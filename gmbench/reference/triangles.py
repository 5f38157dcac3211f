"""Triangles of a simple undirected graph, counted from an edge list
(``triangle_counting.gm``; the GAP Benchmark Suite's ``tc``): every
triangle {a, b, c} once.

The edge list is made simple and undirected here (pairs as sorted int64
keys ``min * n + max``, self-loops and duplicates dropped), each edge is
oriented from the node of lower (degree, id) to the higher, and the
oriented edges are sorted by key ``lo * n + hi``: rows by source id, each
row by destination id.  A triangle has exactly one node before both
others, and its other two nodes are a pair of that node's row.  So every
pair (y, z) of each row's slots, y's slot before z's, is enumerated by
expanding each slot's pairs with ``repeat_interleave``, a chunk of slots
at a time, and the pair oriented by the same order is looked up among the
oriented keys by ``torch.searchsorted``.  Runs on the edges' device in
int64.
"""

from __future__ import annotations

import torch


def _before(u: torch.Tensor, v: torch.Tensor,
            deg: torch.Tensor) -> torch.Tensor:
    """Whether u comes before v in the (degree, id) order."""
    du, dv = deg[u], deg[v]
    return (du < dv) | ((du == dv) & (u < v))


def count(src: torch.Tensor, dst: torch.Tensor, n: int,
          chunk: int = 1 << 25) -> int:
    """The triangles of the undirected graph of the edge list ``src -- dst``
    over ``n`` nodes, its edges' directions, multiplicities and self-loops
    ignored; about ``chunk`` pairs tested at a time."""
    dev = src.device
    a = torch.minimum(src, dst).to(torch.int64)
    b = torch.maximum(src, dst).to(torch.int64)
    keep = a != b
    pairs = torch.unique(a[keep] * n + b[keep])
    del a, b, keep
    a, b = pairs // n, pairs % n
    del pairs
    deg = torch.bincount(a, minlength=n) + torch.bincount(b, minlength=n)
    a_first = _before(a, b, deg)
    keys = torch.sort(torch.where(a_first, a, b) * n
                      + torch.where(a_first, b, a)).values
    del a, b, a_first
    d = keys.numel()
    if d == 0:
        return 0
    lo, hi = keys // n, keys % n
    row_start = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    row_start[1:] = torch.bincount(lo, minlength=n).cumsum(0)
    later = row_start[lo + 1] - torch.arange(1, d + 1, device=dev)
    del lo, row_start
    upto = later.cumsum(0)          # pairs of the slots up to each slot
    total = torch.zeros((), dtype=torch.int64, device=dev)
    s0, done = 0, 0
    while s0 < d:
        s1 = max(int(torch.searchsorted(upto, done + chunk, right=True)),
                 s0 + 1)
        width = int(upto[s1 - 1]) - done
        if width:
            cnt = later[s0:s1]
            slot = torch.repeat_interleave(
                torch.arange(s0, s1, device=dev), cnt, output_size=width)
            first = torch.cumsum(cnt, 0) - cnt         # each slot's first pair
            off = torch.arange(width, device=dev) - first[slot - s0]
            y, z = hi[slot], hi[slot + 1 + off]
            del cnt, first, off, slot
            y_first = _before(y, z, deg)
            q = torch.where(y_first, y, z) * n + torch.where(y_first, z, y)
            pos = torch.searchsorted(keys, q).clamp_(max=d - 1)
            total += (keys[pos] == q).sum()
        done += width
        s0 = s1
    return int(total)
