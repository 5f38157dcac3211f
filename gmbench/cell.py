"""One run of one cell: set-up, the measured window, the metrics, the
check.

Set-up draws the cell's graph on the device (its structure and lengths
from the configuration's seed, its node labels from the run's), builds the
program's ``Graph`` from it there (``csr.build``), draws the query plan,
prepares each query kind and warms it once.  The window runs the plan in
a closed loop, one client: each call starts when the one before has
returned, and is timed on the host clock from the call to its result
ready on the card.  The call that straddles the window's end is finished.
After the window the memory peak is read, the program's state is freed,
the edge list is drawn again from the seeds, and the sampled answers are
compared with the plain references (``gmbench/reference``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from gmbench import csr, draw, spec, trace
from gmbench.edges import Sample


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    latencies_s: List[float]
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: Optional[trace.Trace] = None


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Dict[str, Any]]
    device: Dict[str, Any]
    checks: Dict[str, Dict[str, float]]
    breakdown: Optional[Dict[str, list]] = None
    by_kind: Optional[Dict[str, Dict[str, float]]] = None   # not in the line
    setup: Optional[Dict[str, float]] = None   # seconds from start to each step

    def line(self) -> Dict[str, Any]:
        """The result's JSON object, the checks' key last."""
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Keeper:
    """Copies the sampled answers to host buffers set aside in set-up, on
    a side stream on the card, so the next call need not wait for it."""

    def __init__(self, count: int, nbytes: int, device: torch.device):
        pin = device.type == "cuda"
        self.free = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
                     for _ in range(count)]
        self.stream = torch.cuda.Stream(device) if pin else None

    def keep(self, answer: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.free:
            return None
        buf = self.free.pop()
        host = buf[:answer.numel() * answer.element_size()].view(answer.dtype)
        if self.stream is None:
            host.copy_(answer)
            return host
        self.stream.wait_stream(torch.cuda.current_stream(answer.device))
        with torch.cuda.stream(self.stream):
            host.copy_(answer, non_blocking=True)
        answer.record_stream(self.stream)
        return host


def _device_info(device: torch.device, chips: int) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": chips}


def short_name(name: str) -> str:
    """A kernel's name without its argument lists and common namespaces,
    at most 120 characters (copies and memsets keep theirs)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at_cuda_detail::", "at::cuda::"):
        name = name.replace(noise, "")
    out, depth = [], 0
    for ch in name:
        depth += ch == "("
        if not depth:
            out.append(ch)
        depth -= ch == ")" and depth > 0
    return "".join(out)[:120]


def _top(seconds: Dict[str, float]) -> List[list]:
    """The ten largest entries, largest first, as [name, seconds]."""
    merged: Dict[str, float] = {}
    for k, v in seconds.items():
        merged[short_name(k)] = merged.get(short_name(k), 0.0) + v
    return sorted(([k, v] for k, v in merged.items()),
                  key=lambda kv: -kv[1])[:10]


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, variant: str = "program") -> Result:
    """Run ``cell`` once.  ``t_start``: ``time.perf_counter()`` at the
    process's start; ``variant``: ``program``, or ``control`` for each
    kind's lower-precision path where it has one (``queries/*.py``)."""
    device = torch.device(device)
    steps: Dict[str, float] = {}

    def step(name):
        _sync(device)
        steps[name] = time.perf_counter() - t_start

    step("started")
    cfg = cell.config
    gen = spec.load_module("graphs", cfg["generator"], cell.pkg)
    edges = gen.draw(cfg, seed, device)
    step("drawn")
    graph, (lengths,) = csr.build(edges.src, edges.dst, edges.num_nodes,
                                  [edges.lens])
    step("built")
    plan = draw.plan(cell.traffic, graph.begin.diff(), edges.labels,
                     int(cfg["structure_seed"]), seed)
    del edges
    kinds = {k: spec.load_module("queries", k, cell.pkg) for k in plan.args}
    states = {k: m.prepare(graph, lengths, plan.args[k])
              for k, m in kinds.items()}
    calls = {k: getattr(m, "control", m.call) if variant == "control"
             else m.call for k, m in kinds.items()}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step("planned")
    for kind, root in plan.warmup:
        calls[kind](states[kind], root)
    step("warmed")
    keeper = _Keeper(sum(plan.checked), graph.n_pad * 4, device)
    step("buffered")

    span = torch.profiler.record_function if traced else contextlib.nullcontext
    samples: Dict[str, List[Sample]] = {k: [] for k in kinds}
    latencies: List[float] = []
    per_kind: Dict[str, List[tuple]] = {k: [] for k in kinds}
    attempted = failed = 0
    q = len(plan.kinds)
    got_trace: list = []
    setup_s = time.perf_counter() - t_start
    with trace.traced(traced, device, got_trace), span(trace.WINDOW):
        begin = time.perf_counter()      # the profiler, if any, has started
        deadline = begin + seconds
        i = 0
        while time.perf_counter() < deadline:
            with span("draw"):
                j = i % q
                kind, root = plan.kinds[j], plan.roots[j]
                checked = i < q and plan.checked[j]
            attempted += 1
            t0 = time.perf_counter()
            try:
                with span(f"call:{kind}#{i}"):
                    answer, info = calls[kind](states[kind], root)
                with span("sync"):
                    _sync(device)
            except Exception:  # a failed call is counted and reported
                failed += 1
                traceback.print_exc(file=sys.stderr)
                i += 1
                continue
            latencies.append(time.perf_counter() - t0)
            per_kind[kind].append((latencies[-1], info.get("steps", 0)))
            if checked:
                host = keeper.keep(answer)
                if host is not None:
                    samples[kind].append(Sample(root, host, info))
            del answer
            i += 1
        end = time.perf_counter()
        _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    rec = Record(latencies_s=latencies, window_s=end - begin,
                 setup_s=setup_s, peak_bytes=peak,
                 trace=got_trace[0] if got_trace else None)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_module("metrics", m["name"], cell.pkg).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = _device_info(device, cell.chips)
    dev_info["memory_peak_bytes"] = peak
    breakdown = None
    if rec.trace is not None:
        dev_info["busy_s"] = rec.trace.busy_s()
        dev_info["window_s"] = rec.trace.window_s
        breakdown = {"device_ops": _top(rec.trace.device_ops()),
                     "idle_gaps": _top(rec.trace.idle_gaps())}

    del states, graph, lengths, calls, rec, got_trace
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cell, kinds, samples, plan, seed, device)
    checks = {name: {"value": value, "limit": cell.limits[name]}
              for name, value in numbers.items()}
    correct = (attempted > 0 and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    by_kind = {k: {"count": len(v),
                   "mean_ms": 1e3 * sum(t for t, _ in v) / len(v),
                   "max_ms": 1e3 * max(t for t, _ in v),
                   "mean_steps": sum(s for _, s in v) / len(v)}
               for k, v in per_kind.items() if v}
    return Result(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev_info, checks=checks,
                  breakdown=breakdown, by_kind=by_kind, setup=steps)


def check(cell: spec.Cell, kinds, samples: Dict[str, List[Sample]],
          plan: draw.Plan, seed: int, device) -> Dict[str, float]:
    """Each kind's numbers over its samples, against the references on
    the edge list drawn again from the seed; ``unchecked_kinds`` counts
    the kinds with no sample to compare."""
    gen = spec.load_module("graphs", cell.config["generator"], cell.pkg)
    edges = gen.draw(cell.config, seed, device)
    numbers: Dict[str, float] = {"unchecked_kinds": 0}
    for kind, mod in kinds.items():
        if not samples[kind]:
            numbers["unchecked_kinds"] += 1
            continue
        numbers.update(mod.check(samples[kind], edges, plan.args[kind]))
    return numbers
