"""Delta-stepping SSSP, the Dijkstra-class replacement.

Counterpart of ``green_marl_tpu/models/delta_stepping.py``.  The
reference's ``sssp_dijkstra.gm`` / ``bidir_dijkstra.gm`` drive a mutable
priority map (``gm_mutatable_priority_map.h``), a sequential schedule.
Delta-stepping (Meyer & Sanders) buckets nodes by ``dist // delta``; the
lowest non-empty bucket is settled by relaxing its *light* edges (w <=
delta) to a fixpoint, then its heavy edges once, and the loop jumps to the
next non-empty bucket.  For non-negative weights the distances equal
Dijkstra's.

Every relaxation is the masked min-reduce superstep of ``models.relax``
(the segment-reduce kernel on the card); the two nested loops are host
loops over ``engine.superstep.while_loop``, one host sync per step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops

INT32_MAX = torch.iinfo(torch.int32).max


class DeltaSteppingResult(NamedTuple):
    dist: torch.Tensor      # [N_pad] int32, INT32_MAX = unreached
    buckets_processed: int  # outer steps
    inner_steps: int        # light-edge steps over all buckets


def delta_stepping(g: Graph, root: int, edge_len: torch.Tensor,
                   delta: int = 8, max_buckets: Optional[int] = None,
                   max_inner: Optional[int] = None) -> DeltaSteppingResult:
    """``edge_len``: [E_pad] non-negative int weights (CSR order)."""
    if max_buckets is None:
        max_buckets = g.num_nodes + 1
    if max_inner is None:
        max_inner = g.num_nodes + 1
    dev = g.device
    inf = torch.full((), INT32_MAX, dtype=torch.int32, device=dev)
    ids = torch.arange(g.n_pad, dtype=torch.int32, device=dev)
    mask = g.node_mask()
    dist0 = torch.where((ids == root) & mask, 0, inf)

    w_csc = edge_len.index_select(0, g.e_rev2idx).to(torch.int32)
    light = w_csc <= delta
    src = g.r_node_idx

    def bucket(dist):
        # floor division; INT32_MAX // delta is never compared unmasked
        return torch.div(dist, delta, rounding_mode="floor")

    def relax(dist, active, sel):
        ok = active.index_select(0, src)
        if sel is not None:
            ok = ok & sel
        cand = torch.where(ok, dist.index_select(0, src) + w_csc, inf)
        best = ops.sorted_segment_reduce(cand, g.r_node_idx_dst, g.r_begin,
                                         g.n_pad, "min")
        return torch.minimum(dist, best)

    def outer(state):
        dist, bkt, inner_total = state
        finite = mask & (dist != inf)
        in_bucket = finite & (bucket(dist) == bkt)

        def inner(st):
            dist, active = st
            new = relax(dist, active, light)
            return new, (new < dist) & (bucket(new) == bkt)

        # settle the bucket: light-edge fixpoint
        (dist, _), stats = while_loop(inner, lambda st: st[1].any(),
                                      (dist, in_bucket), max_inner)
        # heavy edges once, from everything settled in this bucket
        settled = mask & (dist != inf) & (bucket(dist) == bkt)
        dist = relax(dist, settled, None)
        # jump to the next non-empty bucket
        b = bucket(dist)
        nxt = torch.where(mask & (dist != inf) & (b > bkt), b, inf).min()
        return dist, nxt, inner_total + stats.iterations

    def outer_not_done(state):
        dist, bkt, _ = state
        return (mask & (dist != inf) & (bucket(dist) >= bkt)).any()

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    (dist, _, inner_total), stats = while_loop(
        outer, outer_not_done, (dist0, zero, 0), max_buckets)
    return DeltaSteppingResult(dist=dist,
                               buckets_processed=stats.iterations,
                               inner_steps=inner_total)
