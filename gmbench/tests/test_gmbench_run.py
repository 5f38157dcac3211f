"""Whole runs of both cells at small sizes on the CPU: the result's line,
the control and the faults the check must catch, and the trace's
arithmetic."""

import json
import subprocess
import sys
import time

import pytest
import torch

from gmbench import cell, spec, trace
from gmbench.cell import Record

SMALL = {"lj.queries": dict(nodes=3000, edges=24000),
         "g500s24.queries": dict(scale=11)}
SEED = 2**31 + 99


def small(name):
    c = spec.load_cell(name)
    c.config = dict(c.config, **SMALL[name])
    c.traffic = dict(c.traffic, queries=48)
    return c


def run(name, **kw):
    kw.setdefault("seconds", 0.5)
    return cell.run_cell(small(name), SEED, kw.pop("seconds"),
                         kw.pop("traced", False), "cpu", time.perf_counter(),
                         **kw)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_run_is_correct_and_its_line_complete(name):
    res = run(name)
    line = res.line()
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"queries_per_s", "query_ms_p95",
                                    "setup_s"}   # no device peak on a CPU
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    kinds = [k["kind"] for k in small(name).traffic["kinds"]]
    numbers = {n for k in kinds
               for n in spec.load_module("queries", k).NUMBERS}
    assert set(line["checks"]) == numbers | {"unchecked_kinds"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("name,number", [("lj.queries", "rank_rel_err"),
                                         ("g500s24.queries", "sssp_mismatch")])
def test_control_is_not_correct(name, number):
    res = run(name, variant="control")
    assert res.correct is False
    assert res.checks[number]["value"] > res.checks[number]["limit"]


def _unchanged_step(loop):
    def broken(step, not_done, state, max_iter):
        return loop(lambda s: s, not_done, state, max_iter)
    return broken


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_step_that_returns_its_state_unchanged_fails(name, monkeypatch):
    from green_marl_tpu_torch.models import bfs, pagerank, relax
    monkeypatch.setattr(pagerank, "converge_loop",
                        _unchanged_step(pagerank.converge_loop))
    monkeypatch.setattr(relax, "while_loop", _unchanged_step(relax.while_loop))
    monkeypatch.setattr(bfs, "while_loop", _unchanged_step(bfs.while_loop))
    assert run(name).correct is False


@pytest.mark.parametrize("name", sorted(SMALL))
def test_an_answer_altered_where_it_is_produced_fails(name, monkeypatch):
    from green_marl_tpu_torch.models import bfs, pagerank, relax

    def altered(fn, field):
        def wrong(*args, **kwargs):
            res = fn(*args, **kwargs)
            out = getattr(res, field).clone()
            out[int(out.shape[0]) // 3] += 1     # one node's answer
            return res._replace(**{field: out})
        return wrong

    monkeypatch.setattr(pagerank, "pagerank",
                        altered(pagerank.pagerank, "rank"))
    monkeypatch.setattr(relax, "min_relax", altered(relax.min_relax, "dist"))
    monkeypatch.setattr(bfs, "bfs", altered(bfs.bfs, "level"))
    res = run(name)
    assert res.correct is False
    assert any(c["value"] > c["limit"] for c in res.checks.values())


def test_traced_run_on_the_cpu_has_a_window_and_no_device_metric():
    res = run("lj.queries", traced=True)
    assert res.correct is True and res.metrics == {}
    assert res.device["window_s"] > 0 and res.device["busy_s"] == 0
    assert list(res.line())[-2:] == ["breakdown", "checks"]


def test_entry_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "gmbench.run", "--workload",
                        "lj.queries", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=spec.ROOT,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


# --- the trace's arithmetic on made-up profiler events --------------------

class Ev:
    def __init__(self, name, start, end, cuda=False, corr=0, linked=0):
        self._v = (name, start, end, cuda, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _events():
    """A 1000 ns window: one call whose segment reduce (two kernels) is
    launched inside its wrapper span, one gather, one idle gap in sync."""
    return [
        Ev("gm:window", 0, 1000, corr=1),
        Ev("call:sssp#0", 10, 600, corr=2),
        Ev("aten::index_select", 20, 40, corr=3),
        Ev("cudaLaunchKernel", 25, 30, corr=900, linked=3),
        Ev("gm:segment_reduce_sorted", 50, 90, corr=4),
        Ev("cudaLaunchKernel", 60, 62, corr=901),      # from a C entry
        Ev("cudaLaunchCooperativeKernel", 70, 72, corr=902),
        Ev("sync", 600, 990, corr=5),
        Ev("void at::native::indexSelectLargeIndex<float>", 100, 300,
           cuda=True, corr=900, linked=3),
        Ev("void tile_rows_kernel<int, 1>", 300, 340, cuda=True, corr=901),
        Ev("void segment_reduce_kernel<int, 1, true>", 340, 500, cuda=True,
           corr=902),
        Ev("void outside_kernel", 2000, 2100, cuda=True),
        Ev("gm:segment_reduce_sorted", 300, 500, cuda=True),   # mirrors
        Ev("call:sssp#0", 100, 500, cuda=True),
    ]


def test_trace_arithmetic():
    tr = trace.parse(_events(), {"segment_reduce_sorted": 670})
    assert tr.window == (0, 1000) and len(tr.activities) == 3
    assert tr.busy_s() == pytest.approx(400e-9)
    gaps = tr.idle_gaps()
    assert gaps["call:sssp"] == pytest.approx(100e-9)   # 0-100 is in no span
    assert gaps["sync"] == pytest.approx(500e-9)        # 500-1000
    assert len(tr.under("gm:segment_reduce_sorted")) == 2
    rec = Record([1e-6, 2e-6], 1e-6, 0.0, 0, tr)
    read = lambda m: spec.load_module("metrics", m).read(rec)
    assert read("kernels_per_call") == 1.5
    assert read("gather_share_pct") == pytest.approx(50.0)
    assert read("device_idle_pct") == pytest.approx(60.0)
    assert read("segment_reduce_roofline_pct") == pytest.approx(
        100 * 670 / 3.35e12 / 200e-9)
    assert read("cumsum_roofline_pct") is None


def test_trace_without_its_window_is_none():
    assert trace.parse(_events()[1:], {}) is None
