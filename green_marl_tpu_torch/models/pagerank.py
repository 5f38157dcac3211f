"""PageRank power iteration (``apps/src/pagerank.gm:1-20``).

Counterpart of ``green_marl_tpu/models/pagerank.py``: a pull-sum over
in-neighbours (the segment-reduce kernel on the card), a double-buffered
rank, an L1-diff convergence test and an iteration cap::

    G.pg_rank = 1 / N;
    Do {
        diff = 0.0;
        Foreach (t: G.Nodes) {
            Double val = (1-d)/N + d * Sum(w: t.InNbrs){ w.pg_rank / w.OutDegree() };
            diff += | val - t.pg_rank |;
            t.pg_rank <= val @ t;
        }
        cnt++;
    } While ((diff > e) && (cnt < max));

Defaults (e=0.001, d=0.85, max=100) are ``pagerank_main.cc:11-15``'s.
``pagerank_profiled`` is the ``-GMProfile`` form: the same supersteps, each
timed on its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..engine.superstep import converge_loop
from ..graph.csr import Graph
from ..ops import segment as ops
from ..utils.timing import profile_supersteps


class PageRankResult(NamedTuple):
    rank: torch.Tensor  # [N_pad] (junk rows zero)
    diff: torch.Tensor  # final L1 diff, 0-d
    iterations: int     # supersteps executed


def pagerank(g: Graph, e=0.001, d=0.85, max_iter: int = 100,
             dtype=torch.float32) -> PageRankResult:
    """PageRank to convergence on ``g``'s device.

    ``e`` and ``d`` are cast to ``dtype`` first and ``diff > e`` is tested
    in ``dtype``, as in the JAX version: a float64 test on the host could
    stop at another iteration.
    """
    e, rank0, step = _setup(g, e, d, dtype)
    (rank, diff), stats = converge_loop(step, lambda st: st[1] > e,
                                        (rank0, torch.zeros_like(e)),
                                        max_iter)
    return PageRankResult(rank=rank, diff=diff, iterations=stats.iterations)


def _setup(g: Graph, e, d, dtype):
    """``(e, rank0, step)``: the threshold in ``dtype``, the initial ranks
    and one superstep ``(rank, diff) -> (rank', diff')``."""
    dev = g.device
    mask = g.node_mask()
    inv_n = torch.tensor(1.0 / g.num_nodes, dtype=dtype, device=dev)
    e = torch.tensor(e, dtype=dtype, device=dev)
    d = torch.tensor(d, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    out_deg = g.out_degree().to(dtype)
    # nodes without out-edges contribute nothing (the pull never reaches
    # them through an edge)
    inv_deg = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1), zero)

    def step(state):
        rank, _ = state
        s = ops.in_nbr_sum(g, rank * inv_deg)
        val = torch.where(mask, (1 - d) * inv_n + d * s, zero)
        return val, (val - rank).abs().sum()

    return e, torch.where(mask, inv_n, zero), step


def pagerank_profiled(g: Graph, e=0.001, d=0.85, max_iter: int = 100,
                      dtype=torch.float32) -> PageRankResult:
    """:func:`pagerank` with a ``superstep[i] time=X ms`` line a superstep
    (``utils.timing.profile_supersteps``): the same arithmetic and
    iterations.  One superstep runs first, untimed and thrown away, as the
    JAX version compiles its step outside the timings: here it builds the
    kernels."""
    e, rank0, step = _setup(g, e, d, dtype)
    zero = torch.zeros_like(e)
    step((rank0, zero))

    def counted(state):
        rank, diff, it = state
        return (*step((rank, diff)), it + 1)

    def cond(state):
        _, diff, it = state
        return it == 0 or bool(diff > e)

    rank, diff, it = profile_supersteps(counted, (rank0, zero, 0), cond,
                                        max_iter)
    return PageRankResult(rank=rank, diff=diff, iterations=it)


def pagerank_np(begin, node_idx, e=0.001, d=0.85, max_iter=100):
    """Host float64 oracle (the .gm source, transliterated) for tests."""
    N = begin.shape[0] - 1
    deg = np.diff(begin)
    src = np.repeat(np.arange(N), deg)
    dst = np.asarray(node_idx)[: src.shape[0]]
    rank = np.full(N, 1.0 / N)
    cnt = 0
    while True:
        contrib = np.where(deg > 0, rank / np.maximum(deg, 1), 0.0)
        s = np.zeros(N)
        np.add.at(s, dst, contrib[src])
        val = (1 - d) / N + d * s
        diff = np.abs(val - rank).sum()
        rank = val
        cnt += 1
        if not (diff > e and cnt < max_iter):
            return rank, diff, cnt
