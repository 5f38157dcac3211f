"""Masked min-relaxation, the superstep of hop_dist and SSSP.

Counterpart of ``green_marl_tpu/models/relax.py``.  Green-Marl's BFS/SSSP
family reduces to (hop_dist.gm:36-50, sssp.gm:77-91)::

    Foreach(n: G.Nodes)(n.updated)
        Foreach(s: n.Nbrs)
            <s.dist_nxt; s.updated_nxt> min= <n.dist + w(e); True>;
    G.dist = G.dist_nxt; G.updated = G.updated_nxt; fin = !Exist(updated)

run here as a pull over CSC slots: each destination takes the min over its
in-edges from updated sources, and ``updated`` flags strict improvement.
The slot pass is one call of the segment reduce's gather form
(``ops.kernels.segment_reduce_sorted`` with the node tables): on the card
one launch reads each slot's source id, its flag and, where set, its
distance and weight; on the CPU its plain version gathers, adds, masks and
reduces as four PyTorch ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import kernels
from ..utils.timing import profile_supersteps, span

INT32_MAX = torch.iinfo(torch.int32).max


class RelaxResult(NamedTuple):
    dist: torch.Tensor  # [N_pad]; the dtype's max (+inf) = unreached
    iterations: int     # supersteps executed


def _inf(dtype: torch.dtype):
    return (float("inf") if dtype.is_floating_point
            else torch.iinfo(dtype).max)


def _setup(g: Graph, root: int, edge_len: Optional[torch.Tensor],
           dist_dtype: torch.dtype):
    """``((dist0, updated0), step)`` of the relaxation from ``root``."""
    dev = g.device
    with span("gm:sync:upload"):     # from pageable memory: a copy that waits
        inf = torch.tensor(_inf(dist_dtype), dtype=dist_dtype, device=dev)
    ids = torch.arange(g.n_pad, dtype=torch.int32, device=dev)
    upd0 = ids == root
    dist0 = torch.where(upd0 & g.node_mask(), torch.zeros_like(inf), inf)
    w = (edge_len.index_select(0, g.e_rev2idx).to(dist_dtype)
         if edge_len is not None else None)      # None: unit weights

    def step(state):
        dist, updated = state
        # looked up at each call: a caller may wrap the module attribute
        best = kernels.segment_reduce_sorted(
            g.r_node_idx, g.r_node_idx_dst, g.r_begin, g.n_pad, "min",
            node_vals=dist, node_mask=updated, add=w)
        new_dist = torch.minimum(dist, best)
        return new_dist, new_dist < dist

    return (dist0, upd0), step


def min_relax(g: Graph, root: int, edge_len: Optional[torch.Tensor] = None,
              max_iter: Optional[int] = None,
              dist_dtype: torch.dtype = torch.int32) -> RelaxResult:
    """Min-relaxation from ``root`` to its fixpoint, in ``dist_dtype``
    (int32, or float32 through the segment-reduce kernel's float min).

    ``edge_len``: optional [E_pad] weights in CSR slot order (``e.len`` of
    sssp.gm); unit weights when None (hop_dist).  ``src_dist + w`` is
    computed before the mask, as in the JAX version, so both wrap alike.
    """
    if max_iter is None:
        max_iter = g.num_nodes + 1
    with span("gm:setup"):
        state0, step = _setup(g, root, edge_len, dist_dtype)
    (dist, _), stats = while_loop(step, lambda s: s[1].any(), state0,
                                  max_iter)
    return RelaxResult(dist=dist, iterations=stats.iterations)


def min_relax_profiled(g: Graph, root: int,
                       edge_len: Optional[torch.Tensor] = None,
                       max_iter: Optional[int] = None,
                       dist_dtype: torch.dtype = torch.int32) -> RelaxResult:
    """:func:`min_relax` with a ``superstep[i] time=X ms`` line a superstep
    (``utils.timing.profile_supersteps``), the ``-GMProfile`` path of
    hop_dist.  One superstep runs first, untimed and thrown away, as the
    JAX version compiles its step outside the timings.  ``iterations`` is
    0, as the JAX version returns it."""
    if max_iter is None:
        max_iter = g.num_nodes + 1
    state0, step = _setup(g, root, edge_len, dist_dtype)
    step(state0)
    dist, _ = profile_supersteps(step, state0, lambda s: s[1].any(),
                                 max_iter)
    return RelaxResult(dist=dist, iterations=0)


def min_relax_np(begin, node_idx, root, edge_len=None):
    """Host oracle (Bellman-Ford over out-edges, int64) for tests."""
    N = begin.shape[0] - 1
    src = np.repeat(np.arange(N), np.diff(begin))
    dst = np.asarray(node_idx)[: src.shape[0]]
    w = np.ones_like(src) if edge_len is None else np.asarray(edge_len)
    INF = np.iinfo(np.int64).max
    dist = np.full(N, INF, dtype=np.int64)
    dist[root] = 0
    changed = True
    while changed:
        cand = np.where(dist[src] < INF, dist[src] + w, INF)
        new = dist.copy()
        np.minimum.at(new, dst, cand)
        changed = bool((new < dist).any())
        dist = new
    return dist
