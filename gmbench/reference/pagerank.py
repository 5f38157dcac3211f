"""PageRank by power iteration over an edge list (``pagerank.gm``)::

    rank = 1/N
    repeat: val[t] = (1-d)/N + d * sum over edges (w -> t) of rank[w] / outdeg[w]
            diff = sum |val - rank|; rank = val
    until diff <= e or max iterations

Duplicate edges count with their multiplicity, in the out-degree too.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int, e: float,
             d: float, keep: Iterable[int], dtype=torch.float64
             ) -> Tuple[Dict[int, torch.Tensor], List[float]]:
    """``({k: rank after k steps, for k in keep}, [diff of each step])``,
    run to the largest step in ``keep``."""
    keep = set(keep)
    out_deg = torch.bincount(src, minlength=n).to(dtype)
    inv_deg = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1),
                          torch.zeros((), dtype=dtype, device=src.device))
    dst64 = dst.to(torch.int64)
    rank = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    ranks, diffs = {}, []
    for k in range(1, max(keep) + 1):
        contrib = (rank * inv_deg).index_select(0, src)
        s = torch.zeros(n, dtype=dtype, device=src.device)
        s.index_add_(0, dst64, contrib)
        val = (1 - d) / n + d * s
        diffs.append(float((val - rank).abs().sum()))
        rank = val
        if k in keep:
            ranks[k] = rank
    return ranks, diffs


def admissible(k: int, diffs: List[float], e: float, max_iter: int,
               tol: float) -> bool:
    """Whether ``Do {...} While (diff > e && cnt < max)`` may stop after
    step ``k`` when each diff is known to within a share ``tol`` of ``e``:
    every earlier diff above ``e`` and this one at or below it (or ``k``
    the cap)."""
    if not 1 <= k <= min(len(diffs), max_iter):
        return False
    earlier = all(diff > e * (1 - tol) for diff in diffs[:k - 1])
    return earlier and (k == max_iter or diffs[k - 1] <= e * (1 + tol))
