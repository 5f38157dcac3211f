"""Per-superstep timing and the graph's array report (``-GMProfile``).

Counterpart of ``profile_supersteps`` and ``graph_placement_report`` of
``green_marl_tpu/utils/timing.py``.  Its other helpers (``sync``,
``fetch_baseline``, ``device_time``) work around a remote TPU link whose
``block_until_ready`` does not block; on a local card CUDA events time the
device, so they have no counterpart here.
"""

from __future__ import annotations

import time

import torch

from ..graph.csr import ARRAY_FIELDS


def _device_of(state) -> torch.device:
    """The device of the first tensor in ``state`` (a tensor or a tuple
    of them, possibly with plain numbers beside); the CPU if none."""
    items = state if isinstance(state, (tuple, list)) else (state,)
    for x in items:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def profile_supersteps(step, state, cond, max_iter: int = 10 ** 6):
    """Host-driven superstep loop that prints ``superstep[i] time=X ms`` for
    each step (the reference's Shoal step timers and BFS
    ``PROFILE_LEVEL_TIME``, ``gm_cpp_gen.cc:761-770``,
    ``gm_bfs_template.h:85-96``): CUDA events around the step on the card,
    the host clock on the CPU.  ``step(state) -> state``; ``cond(state)``
    is a bool or a 0-d tensor, read on the host before each step.  Returns
    the final state."""
    dev = _device_of(state)
    cuda = dev.type == "cuda"
    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
    i = 0
    while i < max_iter and bool(cond(state)):
        if cuda:
            ev0.record()
            state = step(state)
            ev1.record()
            ev1.synchronize()
            ms = ev0.elapsed_time(ev1)
        else:
            t0 = time.perf_counter()
            state = step(state)
            ms = 1000 * (time.perf_counter() - t0)
        print(f"superstep[{i}] time={ms:.3f} ms", flush=True)
        i += 1
    return state


def graph_placement_report(g) -> str:
    """The ``Array[...]`` report lines (Shoal, run.sh:218-236) of each of
    the graph's seven arrays; dtype names as numpy prints them
    (``int32``)."""
    rows = []
    for f in ARRAY_FIELDS:
        a = getattr(g, f)
        rows.append(f"Array[{f}]: elements={a.numel()} "
                    f"size={a.numel() * a.element_size()} "
                    f"dtype={str(a.dtype).replace('torch.', '')} -- "
                    f"hugepage=[ ] replication=[X] distribution=[ ]")
    return "\n".join(rows)
