"""``models.pagerank.pagerank``, as the ``pagerank`` app calls it
(``cli/apps.py``; pagerank.gm).  Arguments: ``e``, ``d``, ``max_iter``.

Check: the ranks after the number of steps the call ran, against the
float64 reference after as many steps (``rank_rel_err``: the largest
``|rank - ref| / ref`` over nodes and samples), and whether the loop could
stop after that step by the reference's diffs, each known to within 1% of
``e`` (``pagerank_stop_off``: the samples where it could not)."""

from __future__ import annotations

import torch

from gmbench.reference import pagerank as ref
from green_marl_tpu_torch.models import pagerank as model

NUMBERS = ("rank_rel_err", "pagerank_stop_off")
STOP_TOL = 0.01     # float32 diffs near e carry ~1e-3 of cancellation


def prepare(graph, lengths, args):
    return dict(graph=graph, e=float(args["e"]), d=float(args["d"]),
                max_iter=int(args["max_iter"]))


def call(state, root):
    res = model.pagerank(state["graph"], e=state["e"], d=state["d"],
                         max_iter=state["max_iter"])
    return res.rank, {"steps": int(res.iterations)}


def control(state, root):
    res = model.pagerank(state["graph"], e=state["e"], d=state["d"],
                         max_iter=state["max_iter"], dtype=torch.bfloat16)
    return res.rank, {"steps": int(res.iterations)}


def check(samples, edges, args):
    e, d, max_iter = float(args["e"]), float(args["d"]), int(args["max_iter"])
    n = edges.num_nodes
    steps = sorted({s.info["steps"] for s in samples})
    ranks, diffs = ref.pagerank(edges.src, edges.dst, n, e, d, steps)
    worst, off = 0.0, 0
    for s in samples:
        want = ranks[s.info["steps"]]
        got = s.answer[:n].to(device=want.device, dtype=torch.float64)
        worst = max(worst, float(((got - want).abs() / want).max()))
        off += not ref.admissible(s.info["steps"], diffs, e, max_iter,
                                  STOP_TOL)
    return {"rank_rel_err": worst, "pagerank_stop_off": off}
