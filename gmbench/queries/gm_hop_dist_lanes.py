"""hop_dist.gm (``programs/hop_dist.gm``) compiled from its text and run
from ``lanes`` landmark roots a call in lockstep
(``CompiledProc.batch(graph, over={"root": ...})``).  Arguments:
``lanes``, ``min_out_degree``.  The roots are ``queries/multi_bfs.py``'s
``batch(eligible, pivot, lanes)`` with the call's root as the pivot: a
stratified sample of the nodes with at least ``min_out_degree``
out-edges that starts at it.  The answer is each lane's distances at the
call's node sample (``_lanes``); ``steps`` the passes the call ran, its
deepest lane's.

Check: ``lane_hop_mismatch``, the sampled distances that differ from the
reference's BFS levels from that lane's own root, summed over lanes and
samples.  Distances have no lower-precision path, so the kind has no
control."""

from __future__ import annotations

import numpy as np
import torch

from gmbench.queries import _lanes, multi_bfs
from gmbench.reference import bfs as ref

NUMBERS = ("lane_hop_mismatch",)
UNREACHED = 2**31 - 1       # the program's +INF Int


def roots(eligible: np.ndarray, pivot: int, lanes: int) -> torch.Tensor:
    """The call's roots, int32 on the host."""
    return torch.from_numpy(
        multi_bfs.batch(eligible, pivot, lanes).astype(np.int32))


def prepare(graph, lengths, args):
    return dict(graph=graph, proc=_lanes.compile_program("hop_dist"),
                lanes=int(args["lanes"]),
                eligible=multi_bfs.eligible(
                    graph.out_degree()[:graph.num_nodes],
                    args["min_out_degree"]))


def call(state, root):
    g, before = state["graph"], _lanes.passes()
    over = roots(state["eligible"], root, state["lanes"]).to(g.device)
    out = state["proc"].batch(g, over={"root": over})
    return (_lanes.answer(out["dist"], root, g.num_nodes),
            {"steps": _lanes.passes() - before})


def check(samples, edges, args):
    n, lanes = edges.num_nodes, int(args["lanes"])
    eligible = multi_bfs.eligible(
        torch.bincount(edges.src.to(torch.int64), minlength=n),
        args["min_out_degree"])
    wrong = 0
    for s in samples:
        ids, got = _lanes.lanes_of(s, n, lanes)
        ids = ids.to(edges.src.device)
        for lane, r in enumerate(roots(eligible, s.root, lanes).tolist()):
            want = ref.levels(edges.src, edges.dst, n, r).index_select(0, ids)
            have = got[lane].to(want.device).long()
            have[have == UNREACHED] = -1
            wrong += int((have != want).sum())
    return {"lane_hop_mismatch": wrong}
