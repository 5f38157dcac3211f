"""pagerank.gm (``programs/pagerank.gm``) compiled from its text and run
over ``lanes`` damping factors a call in lockstep
(``CompiledProc.batch(graph, over={"d": ...})``): d evenly spaced over
``d_low`` .. ``d_high`` in float32, ``e`` and ``max`` shared.  Arguments:
``lanes``, ``d_low``, ``d_high``, ``e``, ``max``.  The answer is each
lane's ranks at the call's node sample (``_lanes``); ``steps`` the passes
the call ran, its slowest lane's.

Check (``reference/gm_lockstep.py``): ``lane_rank_rel_err``, for each
lane of each sample the smallest, over the float64 reference's steps
after which that lane's own loop may stop (its diffs each known to within
1% of ``e``, as ``queries/pagerank.py`` allows), of the largest
``|rank - ref| / ref`` over the sampled nodes; the largest over lanes and
samples.  The compiled program has no lower-precision path, so the kind
has no control."""

from __future__ import annotations

import torch

from gmbench.queries import _lanes
from gmbench.reference import gm_lockstep as ref

NUMBERS = ("lane_rank_rel_err",)
STOP_TOL = 0.01     # as queries/pagerank.py: float32 diffs near e


def damping(args) -> torch.Tensor:
    """The lanes' damping factors, float32 on the host."""
    return torch.linspace(float(args["d_low"]), float(args["d_high"]),
                          int(args["lanes"]), dtype=torch.float32)


def prepare(graph, lengths, args):
    return dict(graph=graph, proc=_lanes.compile_program("pagerank"),
                d=damping(args).to(graph.device), e=float(args["e"]),
                max=int(args["max"]))


def call(state, root):
    g, before = state["graph"], _lanes.passes()
    out = state["proc"].batch(g, over={"d": state["d"]}, e=state["e"],
                              max=state["max"])
    return (_lanes.answer(out["pg_rank"], root, g.num_nodes),
            {"steps": _lanes.passes() - before})


def check(samples, edges, args):
    n, lanes = edges.num_nodes, int(args["lanes"])
    e, max_iter = float(args["e"]), int(args["max"])
    kept = [_lanes.lanes_of(s, n, lanes) for s in samples]
    worst = 0.0
    for lane, d in enumerate(damping(args).tolist()):
        stops = ref.stop_ranks(edges.src, edges.dst, n, e, d, max_iter,
                               STOP_TOL)
        for ids, got in kept:
            worst = max(worst, ref.rank_rel_err(
                stops, ids.to(edges.src.device), got[lane]))
    return {"lane_rank_rel_err": worst}
