"""Per-superstep timing, the graph's array report (``-GMProfile``) and the
program's profiler spans.

Counterpart of ``profile_supersteps`` and ``graph_placement_report`` of
``green_marl_tpu/utils/timing.py``.  Its other helpers (``sync``,
``fetch_baseline``, ``device_time``) work around a remote TPU link whose
``block_until_ready`` does not block; on a local card CUDA events time the
device, so they have no counterpart here.

The harness, the probes and ``chip_smoke.py`` share four helpers:
:func:`entry_device` (an entry point's ``--device``, which never falls back
to the CPU), :func:`card` (the card's name and power limit),
:func:`timed` (the host clock around one call that ends in a synchronize,
and CUDA events on the card) and :func:`kernel_ms` (a kernel's device time
from groups of back-to-back launches).  Every CUDA-event timer of the
package is one of these; the bytes a hand kernel must move are counted in
``probes/bounds.py``.

:func:`span` names the program's own ranges in a ``torch.profiler`` trace:
``gm:setup`` (a model call's work before its loop), ``gm:superstep`` (one
pass of a superstep loop), ``gm:sync:<site>`` (each host wait for the
device: ``predicate``, ``upload``, ``bfs_direction``, ``bfs_push_mark``,
``bfs_reached``), ``gm:edge_map`` (one call of the binned engine's edge
map, ``ops/binned.py``), ``gm:popstats`` (the bit BFS's final
per-instance counts, ``models/batched.py``), ``gm:triangle:count`` (one
``count_dag`` call) and ``gm:triangle:chunk`` (one call of the wedge
search: one kernel launch on the card, every pass of its plain version
on the CPU; ``models/triangle.py``).  They exist only while a profiler
records.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time

import torch
from torch.autograd import _profiler_enabled

from ..graph.csr import ARRAY_FIELDS


def _device_of(state) -> torch.device:
    """The device of the first tensor in ``state`` (a tensor or a tuple
    of them, possibly with plain numbers beside); the CPU if none."""
    items = state if isinstance(state, (tuple, list)) else (state,)
    for x in items:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a shared no-op context: one flag read when nobody profiles (an
    unrecorded ``record_function`` costs ~20x as much on a CPU).  The range
    sits in the profiler's trace, on the clock of the device activities."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def profile_supersteps(step, state, cond, max_iter: int = 10 ** 6):
    """Host-driven superstep loop that prints ``superstep[i] time=X ms`` for
    each step (the reference's Shoal step timers and BFS
    ``PROFILE_LEVEL_TIME``, ``gm_cpp_gen.cc:761-770``,
    ``gm_bfs_template.h:85-96``): CUDA events around the step on the card,
    the host clock on the CPU.  ``step(state) -> state``; ``cond(state)``
    is a bool or a 0-d tensor, read on the host before each step.  Returns
    the final state."""
    cuda = _device_of(state).type == "cuda"
    i = 0
    while i < max_iter and bool(cond(state)):
        if cuda:
            state, ms = _event_ms(lambda: step(state))
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


def entry_device(name: str, device: str) -> torch.device:
    """The device an entry point was asked for; exits non-zero, with a
    message, when it is ``cuda`` and there is no card (it never carries on
    on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device (torch.cuda.is_available() "
                         "is False); use --device cpu for the CPU")
    return dev


def card(dev: torch.device) -> str:
    """The card's name and power limit as NVIDIA's management tool prints them
    (``--query-gpu=name,power.limit``), or a line that says the run is on
    the CPU."""
    if dev.type != "cuda":
        return f"none ({dev.type}: no device times)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _event_ms(fn):
    """``(fn(), ms)``: CUDA events recorded on the current stream before and
    after ``fn()``, the host waiting for the second."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def timed(fn, dev: torch.device):
    """``(fn(), host ms, device ms)``: the host clock around ``fn()`` and a
    synchronize, and CUDA events around it on the card (None elsewhere)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1000 * (time.perf_counter() - t0), None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ms = _event_ms(fn)
    torch.cuda.synchronize()
    return out, 1000 * (time.perf_counter() - t0), ms


def kernel_ms(fn, calls: int, groups: int):
    """``(median, min, max)`` over ``groups`` groups of the mean device ms
    of ``calls`` back-to-back calls of ``fn`` on the card (CUDA events
    around each group), after one warm-up call.  Back to back, the host
    enqueues the next call while the card runs this one, so a kernel of a
    few tens of microseconds is not timed with the host's launch gap."""
    fn()
    torch.cuda.synchronize()

    def group():
        for _ in range(calls):
            fn()

    ms = [_event_ms(group)[1] / calls for _ in range(groups)]
    return statistics.median(ms), min(ms), max(ms)
