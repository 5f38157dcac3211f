"""Multi-source BFS counts over an edge list, one source at a time: for
each source the nodes it reaches (itself included) and the edges its
BFS traverses, the out-degrees of the reached nodes summed with each
edge's multiplicity (Graph500's TEPS count; MS-BFS, Then et al., PVLDB
8(4), 2014, runs many such BFSs at once)."""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from gmbench.reference.bfs import levels


def counts(src: torch.Tensor, dst: torch.Tensor, n: int,
           sources: Iterable[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(reached, traversed)``, [len(sources)] int64 each, on the edges'
    device."""
    out_deg = torch.bincount(src.to(torch.int64), minlength=n)
    reached, traversed = [], []
    for s in sources:
        seen = levels(src, dst, n, int(s)) >= 0
        reached.append(seen.sum())
        traversed.append(out_deg[seen].sum())
    return torch.stack(reached), torch.stack(traversed)
