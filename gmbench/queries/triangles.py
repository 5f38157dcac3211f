"""``models.triangle.triangle_count``: every triangle of the simple
undirected graph counted once, one whole count a call (the third app of
the reference's LiveJournal check, ``triangle_counting.gm``).  No
arguments; the kind has no root and ignores the plan's.

``prepare`` builds the degree-ordered DAG through ``triangle._dag_of``,
the path ``triangle_count`` takes, so the calls find it built (the
reference builds its indexes in ``prepare()`` too, outside its timed
region).  Each call tests every wedge of the DAG again on the card; no
count is kept from one call to the next.  The answer is the count, one
int64.

Check: ``triangle_mismatch``, the checked calls whose count differs from
``reference/triangles.py``'s over the edge list drawn again, which is
computed once a check (a count does not depend on the labels).  An
integer count has no lower-precision path, so the kind has no control."""

from __future__ import annotations

import torch

from gmbench.reference import triangles as ref
from green_marl_tpu_torch.models import triangle

NUMBERS = ("triangle_mismatch",)


def prepare(graph, lengths, args):
    triangle._dag_of(graph)
    return dict(graph=graph)


def call(state, root):
    g = state["graph"]
    return torch.tensor([triangle.triangle_count(g)], dtype=torch.int64,
                        device=g.device), {}


def check(samples, edges, args):
    want = ref.count(edges.src, edges.dst, edges.num_nodes)
    wrong = sum(int(s.answer[0]) != want for s in samples)
    return {"triangle_mismatch": wrong}
