"""Shortest path distances over an edge list with non-negative lengths
(``sssp.gm``): Bellman-Ford in int64, each round relaxing the out-edges
of the nodes whose distance fell in the round before."""

from __future__ import annotations

import torch

UNREACHED = -1


def distances(src: torch.Tensor, dst: torch.Tensor, lens: torch.Tensor,
              n: int, root: int) -> torch.Tensor:
    """[n] int64 distances from ``root``, ``UNREACHED`` where no path
    leads."""
    dev = src.device
    inf = torch.iinfo(torch.int64).max
    dist = torch.full((n,), inf, dtype=torch.int64, device=dev)
    dist[root] = 0
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    changed[root] = True
    while bool(changed.any()):
        live = changed.index_select(0, src)
        s = src[live]
        cand = dist.index_select(0, s) + lens[live].to(torch.int64)
        new = dist.clone()
        new.scatter_reduce_(0, dst[live].to(torch.int64), cand, "amin")
        changed = new < dist
        dist = new
    return torch.where(dist == inf, UNREACHED, dist)
