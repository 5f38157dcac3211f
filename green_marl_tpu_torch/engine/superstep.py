"""Superstep loops: host loops around a device predicate.

Counterpart of ``green_marl_tpu/engine/superstep.py``, where each loop is
one compiled ``lax.while_loop``.  PyTorch runs eagerly, so here the host
runs the loop and reads the predicate, a 0-d device tensor, once per
superstep (one device-to-host sync each).  Iteration counts equal the JAX
loops': ``converge_loop`` runs the step at least once, ``while_loop``
tests first.

Under a profiler each pass of the host loop is a ``gm:superstep`` span: the
predicate read that decides whether to step (a ``gm:sync:predicate`` span
where the predicate is a tensor), then the step's launches.  The pass
whose read ends the loop holds only that read; ``converge_loop``'s first
pass only the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ..utils.timing import span


@dataclasses.dataclass(frozen=True)
class LoopStats:
    iterations: int  # supersteps executed


def converge_loop(step: Callable[[Any], Any],
                  not_done: Callable[[Any], torch.Tensor],
                  state: Any, max_iter: int) -> Tuple[Any, LoopStats]:
    """``state = step(state)`` while ``not_done(state)``, at most
    ``max_iter`` times; the step always runs once (Green-Marl's
    ``Do {} While()`` with an iteration cap, pagerank.gm:8-18)."""
    it = 0
    while it < max_iter:
        with span("gm:superstep"):
            if it > 0 and not _holds(not_done(state)):
                break
            state = step(state)
        it += 1
    return state, LoopStats(iterations=it)


def while_loop(step: Callable[[Any], Any],
               not_done: Callable[[Any], torch.Tensor],
               state: Any, max_iter: int) -> Tuple[Any, LoopStats]:
    """Pre-test loop (Green-Marl ``While(!fin){...}``, hop_dist.gm:36-50)."""
    it = 0
    while it < max_iter:
        with span("gm:superstep"):
            if not _holds(not_done(state)):
                break
            state = step(state)
        it += 1
    return state, LoopStats(iterations=it)


def _holds(pred) -> bool:
    """The predicate on the host: a tensor's read waits for the device."""
    if isinstance(pred, torch.Tensor):
        with span("gm:sync:predicate"):
            return bool(pred)
    return bool(pred)
