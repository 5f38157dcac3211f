"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
window, spans from the benchmark's own files, and what the per-layer
metrics read from it.

Spans are ``torch.profiler.record_function`` ranges opened by the
benchmark around each call into the program (``call:<kind>#<query>``),
around the wait for its result (``sync``), around picking the next query
(``draw``) and around the whole window (``gm:window``); and, while the
window is traced, around each launch of the two kernel wrappers the
roofline metrics read (``gm:segment_reduce_sorted``, ``gm:plain_cumsum``),
which also count the bytes each launch must move from its arguments.
Spans inside the program are not recorded.

Each device activity (kernel, copy, memset) is tied to the call that
launched it by the profiler's correlation ids: its runtime call (same
correlation id) gives the time of the launch, and so the span it was
launched in; the operator it is linked to, where PyTorch launched it,
gives the launcher.  The kernels' C entries launch outside PyTorch and are
linked to no operator, only to their runtime calls.  The profiler also
mirrors each span on the device; those copies are not activities.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from gmbench.metrics import _roofline

WINDOW = "gm:window"
SPAN_PREFIXES = ("call:", "sync", "draw", "gm:")
WRAPPED = ("segment_reduce_sorted", "plain_cumsum")


@dataclasses.dataclass
class Activity:
    name: str
    start: int           # ns, the profiler's clock
    end: int
    kind: str            # kernel, memcpy or memset
    launcher: str        # the operator or span it was launched from ("" if unknown)
    launched: int        # ns when it was launched (its start if unknown)


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]
    activities: List[Activity]      # those that overlap the window
    spans: List[Tuple[int, int, str]]   # the benchmark's, sorted by start
    launch_bytes: Dict[str, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @functools.cached_property
    def busy(self) -> List[Tuple[int, int]]:
        """The union of the activities' intervals within the window."""
        lo, hi = self.window
        out: List[List[int]] = []
        for a in sorted(self.activities, key=lambda a: a.start):
            s, e = max(a.start, lo), min(a.end, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def under(self, span: str) -> List[Activity]:
        """The activities launched inside a span named ``span``."""
        ranges = [(s, e) for s, e, n in self.spans if n == span]
        starts = [s for s, _ in ranges]
        out = []
        for a in self.activities:
            i = bisect.bisect_right(starts, a.launched) - 1
            if i >= 0 and a.launched <= ranges[i][1]:
                out.append(a)
        return out

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the window by the benchmark span open in the
        middle of each gap (call, sync or draw)."""
        top = [(s, e, n.split("#")[0]) for s, e, n in self.spans
               if n.startswith(("call:", "sync", "draw"))]
        starts = [s for s, _, _ in top]
        lo, hi = self.window
        out: Dict[str, float] = {}
        t = lo
        for s, e in self.busy + [(hi, hi)]:
            if s > t:
                mid = (s + t) // 2
                i = bisect.bisect_right(starts, mid) - 1
                label = top[i][2] if i >= 0 and top[i][1] >= mid else "outside"
                out[label] = out.get(label, 0.0) + (s - t) / 1e9
            t = max(t, e)
        return out

    def device_ops(self) -> Dict[str, float]:
        """Device seconds by activity name."""
        out: Dict[str, float] = {}
        for a in self.activities:
            out[a.name] = out.get(a.name, 0.0) + (a.end - a.start) / 1e9
        return out


def _bytes(name: str, args, kwargs) -> int:
    vals = args[0] if args else kwargs["vals"]
    if not vals.is_cuda:
        return 0
    lanes = vals.shape[0] if vals.dim() == 2 else 1
    if name == "segment_reduce_sorted":
        offsets = args[2] if len(args) > 2 else kwargs["offsets"]
        n_out = args[3] if len(args) > 3 else kwargs["n_out"]
        return _roofline.segment_reduce_bytes(
            vals.numel(), offsets.numel(), int(n_out), lanes,
            vals.element_size())
    exclusive = args[1] if len(args) > 1 else kwargs.get("exclusive", False)
    return _roofline.cumsum_bytes(vals.shape[-1], lanes, bool(exclusive),
                                  vals.element_size())


@contextlib.contextmanager
def watch_kernels(launch_bytes: Dict[str, int]):
    """Within the block, each call of the wrapped kernel functions runs in
    a span of its own and adds the bytes it must move to
    ``launch_bytes``.  The program calls them through the module attribute
    (``ops/segment.py``, ``ops/scan_reduce.py``), where they are swapped."""
    from green_marl_tpu_torch.ops import kernels
    originals = {name: getattr(kernels, name) for name in WRAPPED}

    def wrap(name, fn):
        def watched(*args, **kwargs):
            with torch.profiler.record_function(f"gm:{name}"):
                out = fn(*args, **kwargs)
            launch_bytes[name] = (launch_bytes.get(name, 0)
                                  + _bytes(name, args, kwargs))
            return out
        return watched

    try:
        for name, fn in originals.items():
            setattr(kernels, name, wrap(name, fn))
        yield
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def parse(events, launch_bytes: Dict[str, int]) -> Optional[Trace]:
    """The trace of the profiler's events (``kineto_results.events()``),
    or None where the window's span is missing."""
    cuda = torch.autograd.DeviceType.CUDA
    frontend, runtime, device = {}, {}, []
    spans = []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith(SPAN_PREFIXES):   # a span's device copy
                device.append(e)
            continue
        if name.startswith("cuda"):                  # a runtime call
            runtime[e.correlation_id()] = e.start_ns()
            continue
        frontend[e.correlation_id()] = name
        if name.startswith(SPAN_PREFIXES):
            spans.append((e.start_ns(), e.end_ns(), name))
    spans.sort()
    window = next(((s, e) for s, e, n in spans if n == WINDOW), None)
    if window is None:
        return None
    acts = []
    for e in device:
        start = e.start_ns()
        end = start + e.duration_ns()
        if end <= window[0] or start >= window[1]:
            continue
        launched = runtime.get(e.correlation_id(), start)
        acts.append(Activity(name=e.name(), start=start, end=end,
                             kind=_kind(e.name()),
                             launcher=frontend.get(
                                 e.linked_correlation_id() or None, ""),
                             launched=launched))
    return Trace(window=window, activities=acts, spans=spans,
                 launch_bytes=dict(launch_bytes))


@contextlib.contextmanager
def traced(enabled: bool, device: torch.device, out: list):
    """Profile the block when ``enabled``; appends the parsed ``Trace`` (or
    None) to ``out`` after it."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    launch_bytes: Dict[str, int] = {}
    with torch.profiler.profile(activities=acts) as prof:
        with watch_kernels(launch_bytes):
            yield
    out.append(parse(prof.profiler.kineto_results.events(), launch_bytes))
