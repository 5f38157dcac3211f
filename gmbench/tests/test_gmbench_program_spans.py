"""The readers of the program's own spans (``host_syncs_per_call``,
``superstep_idle_pct``, ``setup_idle_pct``) on made-up profiler events,
and a traced run on the CPU, whose trace holds the spans but no device
activity, so that no metric is reported."""

import pytest
import torch

from gmbench import spec, trace
from gmbench.cell import Record
from gmbench.tests.test_gmbench_run import Ev, run

READERS = ("host_syncs_per_call", "superstep_idle_pct", "setup_idle_pct")


def _kernel(start, end, corr):
    return Ev(f"void k{corr}", start, end, cuda=True, corr=corr)


def _events(program_spans=True):
    """A 1000 ns window holding one call: set-up with an upload, two
    supersteps each ending in a predicate read, then host work in no
    program span.  Idle gaps: 40-80 in ``gm:setup``, 200-240 in a
    superstep, 460-490 in a predicate read inside a superstep, 600-700 in
    the call only, 950-1000 in ``sync``."""
    evs = [
        Ev("gm:window", 0, 1000, corr=1),
        Ev("call:sssp#0", 10, 900, corr=2),
        Ev("sync", 900, 1000, corr=3),
        _kernel(0, 40, 10), _kernel(80, 200, 11), _kernel(240, 460, 12),
        _kernel(490, 600, 13), _kernel(700, 950, 14),
    ]
    if program_spans:
        evs += [
            Ev("gm:setup", 20, 100, corr=4),
            Ev("gm:sync:upload", 30, 60, corr=5),
            Ev("gm:superstep", 100, 300, corr=6),
            Ev("gm:sync:predicate", 250, 300, corr=7),
            Ev("gm:superstep", 300, 500, corr=8),
            Ev("gm:sync:predicate", 450, 500, corr=9),
            Ev("gm:superstep", 120, 250, cuda=True),     # device mirrors
            Ev("gm:setup", 80, 100, cuda=True),
        ]
    return evs


def _read(tr, name, calls=2):
    rec = Record([1e-6] * calls, 1e-6, 0.0, 0, tr)
    return spec.load_module("metrics", name).read(rec)


def test_program_spans_split_the_calls_idle_time():
    tr = trace.parse(_events(), {})
    assert len(tr.activities) == 5             # the mirrors are no activity
    assert tr.idle_gaps() == pytest.approx({"call:sssp": 210e-9,
                                            "sync": 50e-9})
    assert _read(tr, "setup_idle_pct") == pytest.approx(4.0)   # 40 ns
    assert _read(tr, "superstep_idle_pct") == pytest.approx(7.0)   # 40 + 30
    assert _read(tr, "host_syncs_per_call") == 1.5     # 3 waits, 2 calls
    assert _read(tr, "kernels_per_call") == 2.5
    assert _read(tr, "device_idle_pct") == pytest.approx(26.0)


def test_nested_supersteps_count_their_gaps_once():
    evs = _events() + [Ev("gm:superstep", 180, 260, corr=20)]
    tr = trace.parse(evs, {})
    assert _read(tr, "superstep_idle_pct") == pytest.approx(7.0)


def test_syncs_outside_the_window_are_not_counted():
    evs = _events() + [Ev("gm:sync:predicate", 1200, 1300, corr=21)]
    assert _read(trace.parse(evs, {}), "host_syncs_per_call") == 1.5


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reports_nothing(name):
    tr = trace.parse(_events(program_spans=False), {})
    assert _read(tr, "device_idle_pct") == pytest.approx(26.0)
    assert _read(tr, name) is None


@pytest.mark.parametrize("name", READERS)
def test_no_device_activity_reports_nothing(name):
    evs = [e for e in _events()
           if e.device_type() != torch.autograd.DeviceType.CUDA]
    assert _read(trace.parse(evs, {}), name) is None


def test_traced_run_on_the_cpu_holds_the_spans_and_no_metric(monkeypatch):
    got = []

    def keep(events, launch_bytes):
        got.append(parse(events, launch_bytes))
        return got[-1]

    parse = trace.parse
    monkeypatch.setattr(trace, "parse", keep)
    res = run("g500s24.queries", traced=True)
    assert res.correct is True and res.metrics == {}
    names = {n.split("#")[0] for _, _, n in got[0].spans}
    assert {"gm:setup", "gm:superstep", "gm:sync:predicate",
            "gm:sync:bfs_reached"} <= names
    assert all(_read(got[0], m) is None for m in READERS)
