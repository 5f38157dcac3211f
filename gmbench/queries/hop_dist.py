"""``models.hop_dist.hop_dist``, as the ``hop_dist`` app calls it
(hop_dist.gm).  Check: the distances against the reference's BFS levels
(``hop_mismatch``: nodes that differ, summed over samples)."""

from __future__ import annotations

from gmbench.reference import bfs as ref
from green_marl_tpu_torch.models import hop_dist as model

NUMBERS = ("hop_mismatch",)
UNREACHED = 2**31 - 1       # the reference's +INF Int


def prepare(graph, lengths, args):
    return dict(graph=graph)


def call(state, root):
    res = model.hop_dist(state["graph"], root)
    return res.dist, {"steps": int(res.iterations)}


def check(samples, edges, args):
    n, wrong, seen = edges.num_nodes, 0, {}
    for s in samples:
        if s.root not in seen:
            seen[s.root] = ref.levels(edges.src, edges.dst, n, s.root)
        want = seen[s.root]
        got = s.answer[:n].to(want.device).long()
        got[got == UNREACHED] = -1
        wrong += int((got != want).sum())
    return {"hop_mismatch": wrong}
