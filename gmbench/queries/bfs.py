"""``models.bfs.bfs``: the direction-optimizing single-source BFS with its
levels as output (the Graph500 BFS, kernel 2).  Check: the levels against
the reference's (``bfs_mismatch``: nodes that differ, summed over
samples)."""

from __future__ import annotations

from gmbench.reference import bfs as ref
from green_marl_tpu_torch.models import bfs as model

NUMBERS = ("bfs_mismatch",)


def prepare(graph, lengths, args):
    return dict(graph=graph)


def call(state, root):
    res = model.bfs(state["graph"], root)
    return res.level, {"steps": int(res.levels_run)}


def check(samples, edges, args):
    n, wrong, seen = edges.num_nodes, 0, {}
    for s in samples:
        if s.root not in seen:
            seen[s.root] = ref.levels(edges.src, edges.dst, n, s.root)
        got = s.answer[:n].to(seen[s.root].device).long()
        wrong += int((got != seen[s.root]).sum())
    return {"bfs_mismatch": wrong}
