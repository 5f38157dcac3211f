"""SSSP with path reconstruction (``apps/src/sssp_path.gm``).

Counterpart of ``green_marl_tpu/models/sssp_path.py``.  The compound argmin
``<s.dist_nxt; s.updated_nxt, s.prev> min= <n.dist + e.len; True, n>``
carries the winning predecessor with the distance.  A superstep is three
int32 min reductions over the in-edges (the segment-reduce kernel on the
card): the distance, the smallest source that reaches it, and the smallest
CSR slot among that source's winning edges.  The reference's atomic argmin
keeps an arbitrary winner under races (``gm_cpp_gen.cc:1563-1742``); the
smallest id is the normalised choice of the JAX version.

``get_path`` is the sequential path walk (``get_path``,
sssp_path.gm:33-42) on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops

INT32_MAX = torch.iinfo(torch.int32).max


class SsspPathResult(NamedTuple):
    dist: torch.Tensor       # [N_pad] int32, INT32_MAX = unreached
    prev: torch.Tensor       # [N_pad] int32 predecessor, -1 = NIL
    prev_edge: torch.Tensor  # [N_pad] int32 CSR slot of the prev edge, -1
    iterations: int


def sssp_path(g: Graph, root: int, edge_len: torch.Tensor,
              max_iter: Optional[int] = None) -> SsspPathResult:
    """``edge_len``: [E_pad] weights in CSR slot order."""
    if max_iter is None:
        max_iter = g.num_nodes + 1
    dev = g.device
    inf = torch.full((), INT32_MAX, dtype=torch.int32, device=dev)
    ids = torch.arange(g.n_pad, dtype=torch.int32, device=dev)
    upd0 = (ids == root) & g.node_mask()
    dist0 = torch.where(upd0, 0, inf)
    w_csc = edge_len.index_select(0, g.e_rev2idx).to(torch.int32)
    src = g.r_node_idx.to(torch.int32)
    slot = g.e_rev2idx.to(torch.int32)
    dstseg, off = g.r_node_idx_dst, g.r_begin

    def seg_min(vals):
        return ops.sorted_segment_reduce(vals, dstseg, off, g.n_pad, "min")

    def step(state):
        dist, upd, prev, pedge = state
        cand = torch.where(upd.index_select(0, src),
                           dist.index_select(0, src) + w_csc, inf)
        best = seg_min(cand)
        improved = best < dist
        # the smallest source that reached the winning value
        win = cand == best.index_select(0, dstseg)
        arg = seg_min(torch.where(win, src, inf))
        # and the smallest CSR slot among that source's winning edges
        argslot = seg_min(torch.where(
            win & (src == arg.index_select(0, dstseg)), slot, inf))
        return (torch.minimum(dist, best), improved,
                torch.where(improved, arg, prev),
                torch.where(improved, argslot, pedge))

    nil = torch.full((g.n_pad,), -1, dtype=torch.int32, device=dev)
    (dist, _, prev, pedge), stats = while_loop(
        step, lambda s: s[1].any(), (dist0, upd0, nil, nil), max_iter)
    return SsspPathResult(dist=dist, prev=prev, prev_edge=pedge,
                          iterations=stats.iterations)


def get_path(prev: np.ndarray, begin_node: int, end_node: int) -> list:
    """Host path walk (sssp_path.gm get_path): node sequence begin..end,
    or [] when unreachable."""
    prev = np.asarray(prev)
    if end_node != begin_node and prev[end_node] < 0:
        return []
    out = [end_node]
    t = end_node
    while t != begin_node:
        t = int(prev[t])
        if t < 0:
            return []
        out.append(t)
    return out[::-1]
