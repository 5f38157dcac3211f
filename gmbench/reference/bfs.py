"""BFS levels over an edge list: level[root] = 0, each node one more than
the nearest node with an edge to it, -1 where no path leads
(``hop_dist.gm``'s distances, the Graph500 BFS's levels)."""

from __future__ import annotations

import torch


def levels(src: torch.Tensor, dst: torch.Tensor, n: int,
           root: int) -> torch.Tensor:
    """[n] int64 levels from ``root``, -1 unreached."""
    dev = src.device
    level = torch.full((n,), -1, dtype=torch.int64, device=dev)
    level[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[root] = True
    depth = 0
    while bool(frontier.any()):
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        hit[dst[frontier.index_select(0, src)].to(torch.int64)] = True
        frontier = hit & (level < 0)
        depth += 1
        level[frontier] = depth
    return level
