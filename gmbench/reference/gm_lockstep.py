"""References of the lockstep kinds, one lane at a time: pagerank.gm at
one damping factor (``reference/pagerank.py``) and hop_dist.gm from one
root (``reference/bfs.py``).  A lane of a lockstep call is one such run,
so each lane is judged against its own reference and nothing of another
lane's.
"""

from __future__ import annotations

from typing import Dict

import torch

from gmbench.reference.pagerank import admissible, pagerank

FIRST_STEPS = 32     # steps run before the reference knows it needs more


def _steps(src, dst, n, e, d, max_iter, tol, more=0):
    """``(ranks after each step 1 .. k + more, diffs, stops)``: ``k`` from
    ``FIRST_STEPS`` on, doubled until no step past it may stop; ``stops``
    the steps that may."""
    k = min(FIRST_STEPS, max_iter)
    while True:
        ranks, diffs = pagerank(src, dst, n, e, d, range(1, k + more + 1))
        # no step past one whose diff is at or below e * (1 - tol) may stop
        if k == max_iter or min(diffs[:k]) <= e * (1 - tol):
            return ranks, diffs, [j for j in ranks if admissible(
                j, diffs, e, max_iter, tol)]
        k = min(2 * k, max_iter)


def stop_ranks(src: torch.Tensor, dst: torch.Tensor, n: int, e: float,
               d: float, max_iter: int, tol: float) -> Dict[int, torch.Tensor]:
    """``{k: float64 ranks after k steps}`` for each step ``k`` after which
    pagerank.gm's ``Do {...} While (diff > e && cnt < max)`` may stop when
    each diff is known to within a share ``tol`` of ``e``
    (``pagerank.admissible``); empty if none may."""
    ranks, _, stops = _steps(src, dst, n, e, d, max_iter, tol)
    return {k: ranks[k] for k in stops}


def rank_rel_err(stops: Dict[int, torch.Tensor], nodes: torch.Tensor,
                 got: torch.Tensor) -> float:
    """The smallest over the steps of ``stops`` of the largest
    ``|got - ref| / ref`` over ``nodes`` (``got``: a lane's ranks there);
    infinite where no step may stop."""
    got = got.to(device=nodes.device, dtype=torch.float64)
    best = float("inf")
    for want in stops.values():
        want = want.index_select(0, nodes)
        best = min(best, float(((got - want).abs() / want).max()))
    return best


def one_step_more(src: torch.Tensor, dst: torch.Tensor, n: int, e: float,
                  d: float, max_iter: int, tol: float,
                  nodes: torch.Tensor) -> float:
    """``rank_rel_err`` at ``nodes`` of the ranks one step past the
    reference's own stop (its first step whose diff is at or below ``e``,
    else ``max_iter``): what a lane run one pass too many reads."""
    ranks, diffs, stops = _steps(src, dst, n, e, d, max_iter, tol, more=1)
    stop = next((k + 1 for k, diff in enumerate(diffs[:max_iter])
                 if diff <= e), max_iter)
    return rank_rel_err({k: ranks[k] for k in stops}, nodes,
                        ranks[stop + 1].index_select(0, nodes))
