"""Greedy vertex cover (``apps/src/v_cover.gm``).

Counterpart of ``green_marl_tpu/models/v_cover.py``.  Reference semantics:
repeatedly pick the edge (s, t) that maximises ``s.Deg + t.Deg`` among the
edges whose endpoints are not both covered, zero both degrees, mark both
covered, select the edge and take the maximum off the remaining total;
return the count of covered nodes.

The argmax over edges is a dense masked reduction with a fixed tie-break,
the lowest CSR slot (the reference's OpenMP argmax is first writer wins).
One host sync a step, through ``engine.superstep.while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph


class VCoverResult(NamedTuple):
    select: torch.Tensor   # [E_pad] bool, the selected edges (CSR slots)
    count: torch.Tensor    # 0-d, covered nodes
    iterations: int


def v_cover(g: Graph, max_iter: Optional[int] = None) -> VCoverResult:
    if max_iter is None:
        max_iter = g.num_edges + 1
    dev = g.device
    e_src = g.node_idx_src.long()
    e_dst = g.node_idx.long()
    emask = g.edge_mask()
    slots = torch.arange(g.e_pad, device=dev)

    deg0 = (g.out_degree() + g.in_degree()).to(torch.int32)
    remain0 = torch.tensor(2 * g.num_edges, dtype=torch.int32, device=dev)

    def step(state):
        deg, covered, select, remain = state
        ok = emask & ~(covered[e_src] & covered[e_dst])
        val = torch.where(ok, deg[e_src] + deg[e_dst], -1)
        best = val.max()
        # torch.argmax does not promise the first maximum: take the lowest
        # slot that holds it
        eidx = torch.where(val == best, slots, g.e_pad).min()
        ends = torch.stack([e_src[eidx], e_dst[eidx]])
        deg = deg.index_fill(0, ends, 0)
        covered = covered.index_fill(0, ends, True)
        select = select.index_fill(0, eidx.view(1), True)
        return deg, covered, select, remain - best

    state0 = (deg0, torch.zeros(g.n_pad, dtype=torch.bool, device=dev),
              torch.zeros(g.e_pad, dtype=torch.bool, device=dev), remain0)
    (_, covered, select, _), stats = while_loop(
        step, lambda st: st[3] > 0, state0, max_iter)
    return VCoverResult(select=select, count=(covered & g.node_mask()).sum(),
                        iterations=stats.iterations)


def v_cover_np(begin, node_idx):
    """Host oracle (the same tie-break)."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    deg_out = np.diff(begin)
    E = node_idx.shape[0]
    src = np.repeat(np.arange(N), deg_out)
    deg = (deg_out + np.bincount(node_idx, minlength=N)).astype(np.int64)
    covered = np.zeros(N, bool)
    select = np.zeros(E, bool)
    remain = 2 * E
    while remain > 0:
        ok = ~(covered[src] & covered[node_idx])
        val = np.where(ok, deg[src] + deg[node_idx], -1)
        e = int(np.argmax(val))
        remain -= val[e]
        s, t = src[e], node_idx[e]
        deg[s] = deg[t] = 0
        covered[s] = covered[t] = True
        select[e] = True
    return select, int(covered.sum())
