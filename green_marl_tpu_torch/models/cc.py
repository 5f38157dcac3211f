"""Connected components.

Counterpart of ``green_marl_tpu/models/cc.py``.  ``weak_cc``: weakly
connected components by min-label propagation over both edge directions
until nothing changes: two ``min`` segment reductions a superstep, the
segment-reduce kernel on the card.  A component's label is the least node
id in it, so outputs are deterministic and comparable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops


class CCResult(NamedTuple):
    comp: torch.Tensor   # [N_pad] int32 label = least node id; -1 on padding
    iterations: int      # supersteps executed


def weak_cc(g: Graph, max_iter: Optional[int] = None) -> CCResult:
    if max_iter is None:
        max_iter = g.num_nodes + 1
    n_pad = g.n_pad
    mask = g.node_mask()
    ids = torch.arange(n_pad, dtype=torch.int32, device=g.device)
    comp0 = torch.where(mask, ids, torch.iinfo(torch.int32).max)

    def step(state):
        comp, _ = state
        # min over in-neighbours and out-neighbours (undirected closure)
        from_in = ops.sorted_segment_reduce(
            comp.index_select(0, g.r_node_idx), g.r_node_idx_dst, g.r_begin,
            n_pad, "min")
        from_out = ops.sorted_segment_reduce(
            comp.index_select(0, g.node_idx), g.node_idx_src, g.begin,
            n_pad, "min")
        new = torch.minimum(comp, torch.minimum(from_in, from_out))
        return new, (new < comp).any()

    (comp, _), stats = while_loop(
        step, lambda st: st[1],
        (comp0, torch.ones((), dtype=torch.bool, device=g.device)), max_iter)
    return CCResult(comp=torch.where(mask, comp, -1),
                    iterations=stats.iterations)


def weak_cc_np(begin, node_idx):
    """Host oracle: the same propagation with ``np.minimum.at``."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    src = np.repeat(np.arange(N), np.diff(begin))
    dst = node_idx[: src.shape[0]]
    comp = np.arange(N)
    changed = True
    while changed:
        new = comp.copy()
        np.minimum.at(new, dst, comp[src])
        np.minimum.at(new, src, comp[dst])
        changed = bool((new < comp).any())
        comp = new
    return comp
