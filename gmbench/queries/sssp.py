"""``models.sssp.sssp`` over the configuration's int32 edge lengths, as
the ``sssp`` app calls it (sssp.gm).  The control is the program's own
float32 distance path (``models.relax.min_relax(dist_dtype=float32)``).
Check: the distances against the reference's int64 Bellman-Ford
(``sssp_mismatch``: nodes that differ, summed over samples)."""

from __future__ import annotations

import torch

from gmbench.reference import sssp as ref
from green_marl_tpu_torch.models import relax, sssp as model

NUMBERS = ("sssp_mismatch",)
UNREACHED = 2**31 - 1


def prepare(graph, lengths, args):
    return dict(graph=graph, lengths=lengths)


def call(state, root):
    res = model.sssp(state["graph"], root, state["lengths"])
    return res.dist, {"steps": int(res.iterations)}


def control(state, root):
    res = relax.min_relax(state["graph"], root, edge_len=state["lengths"],
                          dist_dtype=torch.float32)
    return res.dist, {"steps": int(res.iterations)}


def _as_int(answer: torch.Tensor) -> torch.Tensor:
    """int64 distances with -1 unreached, from int32 or float32 ones."""
    if answer.dtype.is_floating_point:
        out = answer.to(torch.float64).round().to(torch.int64)
        out[torch.isinf(answer)] = -1
        return out
    out = answer.to(torch.int64)
    out[answer == UNREACHED] = -1
    return out


def check(samples, edges, args):
    n, wrong, seen = edges.num_nodes, 0, {}
    for s in samples:
        if s.root not in seen:
            seen[s.root] = ref.distances(edges.src, edges.dst, edges.lens, n,
                                         s.root)
        want = seen[s.root]
        wrong += int((_as_int(s.answer[:n]).to(want.device) != want).sum())
    return {"sssp_mismatch": wrong}
