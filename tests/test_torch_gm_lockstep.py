"""Compiled Green-Marl programs in lockstep as the benchmark runs them
(``gmbench`` cell ``lj.gm_lockstep``): pagerank.gm over damping factors
and hop_dist.gm from landmark roots through ``CompiledProc.batch``,
against the plain references of ``gmbench/reference/gm_lockstep.py``; the
faults the check must catch; the lowerer's ``gm:lower:pass`` spans and
its lane-pass counter; the cell's files and metric readers.  CPU only;
this file imports neither JAX nor ``green_marl_tpu``."""

import ast
import collections
import os
import time
import zlib

import pytest
import torch

from gmbench import cell, spec
from gmbench.queries import _lanes
from gmbench.reference import gm_lockstep as ref
from gmbench.reference.pagerank import admissible, pagerank
from gmbench.tests.test_gmbench_run import Ev
from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.graph.generate import rmat_edges
from green_marl_tpu_torch.lang import lower

N, M = 3000, 24000
CELL = "lj.gm_lockstep"
CPU = [torch.profiler.ProfilerActivity.CPU]
PR_KIND = spec.load_module("queries", "gm_pagerank_lanes")
TRAFFIC = {k["kind"]: k["args"] for k in
           spec.load_json("traffic", "gm_lockstep_16")["kinds"]}
PR_ARGS = TRAFFIC["gm_pagerank_lanes"]
HOP_ARGS = TRAFFIC["gm_hop_dist_lanes"]
LOWER_TESTS = os.path.join(os.path.dirname(__file__), "test_torch_lower.py")


@pytest.fixture(scope="module")
def graph():
    src, dst = rmat_edges(N, M, seed=7)
    g, _ = from_edges(src, dst, N)
    return g, torch.from_numpy(src), torch.from_numpy(dst)


@pytest.fixture(scope="module")
def procs():
    return {name: _lanes.compile_program(name)
            for name in ("pagerank", "hop_dist")}


def _roots(g, count=16):
    deg = g.out_degree()[:N]
    return torch.nonzero(deg > 0).flatten()[::97][:count].to(torch.int32)


# --- the program: spans and the lane-pass counter ------------------------

def _passes(run):
    lower.reset_lane_pass_counts()
    run()
    return lower.lane_pass_counts()


def _batched_and_single(g, procs, name):
    if name == "pagerank":
        ds = PR_KIND.damping(PR_ARGS)
        batched = lambda: procs[name].batch(g, over={"d": ds}, e=0.001,
                                            max=100)
        singles = [lambda d=d: procs[name](g, e=0.001, d=d, max=100)
                   for d in ds.tolist()]
    else:
        roots = _roots(g)
        batched = lambda: procs[name].batch(g, over={"root": roots})
        singles = [lambda r=r: procs[name](g, root=r)
                   for r in roots.tolist()]
    return batched, singles


@pytest.mark.parametrize("name", ["pagerank", "hop_dist"])
def test_counter_sums_the_lanes_single_runs(graph, procs, name):
    g, _, _ = graph
    batched, singles = _batched_and_single(g, procs, name)
    each = [_passes(run) for run in singles]
    lane_passes = [c["passes"] for c in each]
    assert len(set(lane_passes)) > 1, "the lanes stop at one pass"
    assert all(c["loops"] == 1 and c["lanes_computed"] == 0
               for c in each)
    counts = _passes(batched)
    assert counts == {"loops": 1, "passes": max(lane_passes),
                      "lanes_computed": 16 * max(lane_passes),
                      "lanes_live": sum(lane_passes)}


def test_counter_resets(graph, procs):
    g, _, _ = graph
    procs["hop_dist"](g, root=0)
    assert lower.lane_pass_counts()["passes"] > 0
    lower.reset_lane_pass_counts()
    assert set(lower.lane_pass_counts().values()) == {0}


@pytest.mark.parametrize("name", ["pagerank", "hop_dist"])
def test_one_span_a_pass(graph, procs, name):
    g, _, _ = graph
    batched, _ = _batched_and_single(g, procs, name)
    lower.reset_lane_pass_counts()
    with torch.profiler.profile(activities=CPU) as prof:
        batched()
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("gm:"))
    assert names == {"gm:lower:pass": lower.lane_pass_counts()["passes"]}


def test_no_profiler_no_span(graph, procs, monkeypatch):
    g, _, _ = graph
    batched, _ = _batched_and_single(g, procs, "pagerank")
    want = batched()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = batched()
    assert torch.equal(got["pg_rank"], want["pg_rank"])


def _crc(t):
    return zlib.crc32(t.contiguous().numpy().tobytes())


# CRC-32 of each output's bytes before the lowerer had spans and a counter.
# Every float the ranks hold is an elementwise result or a sum of a node's
# in-edges in slot order, so their bits do not depend on how the CPU
# vectorizes a reduction; with e = 0 each lane stops at its own max, so
# neither does the pass a lane stops at.
BEFORE = {"pagerank_e": 2966690253, "pagerank_max": 3091010730,
          "hop_dist": 2654955400}


@pytest.mark.parametrize("case", sorted(BEFORE))
def test_outputs_as_before(graph, procs, case):
    g, _, _ = graph
    ds = PR_KIND.damping(PR_ARGS)
    if case == "pagerank_e":
        out = procs["pagerank"].batch(g, over={"d": ds}, e=0.001, max=100)
    elif case == "pagerank_max":
        out = procs["pagerank"].batch(
            g, over={"d": ds[:4],
                     "max": torch.tensor([3, 5, 7, 9], dtype=torch.int32)},
            e=0.0)
    else:
        out = procs["hop_dist"].batch(g, over={"root": _roots(g)})
    (values,) = out.values()
    assert _crc(values) == BEFORE[case]


# --- the cell's files -----------------------------------------------------

DRAW_KEYS = ["generator", "nodes", "edges", "a", "b", "c", "perturb",
             "self_loops", "structure_seed", "lengths"]


@pytest.mark.parametrize("key", DRAW_KEYS)
def test_configuration_draws_lj(key):
    c = spec.load_cell(CELL)
    assert c.config[key] == spec.load_json("configs", "lj")[key]


def test_configuration_states_what_the_traffic_runs():
    cfg = spec.load_cell(CELL).config
    assert cfg["lanes"] == PR_ARGS["lanes"] == HOP_ARGS["lanes"] == 16
    assert (cfg["damping"]["low"], cfg["damping"]["high"]) == \
        (PR_ARGS["d_low"], PR_ARGS["d_high"])
    assert (cfg["e"], cfg["max"]) == (PR_ARGS["e"], PR_ARGS["max"])
    assert cfg["programs"] == ["pagerank", "hop_dist"]


@pytest.mark.parametrize("name,inline", [("pagerank", "PAGERANK_GM"),
                                         ("hop_dist", "HOP_DIST_GM")])
def test_programs_are_the_tests_texts(name, inline):
    tree = ast.parse(open(LOWER_TESTS).read())
    texts = {t.targets[0].id: t.value.value for t in tree.body
             if isinstance(t, ast.Assign)
             and isinstance(t.targets[0], ast.Name)
             and isinstance(t.value, ast.Constant)}
    assert spec.program_text(name) == texts[inline]


def test_answer_layout(graph):
    g, _, _ = graph
    values = torch.arange(16 * g.n_pad).view(16, g.n_pad)
    for root in (0, 5, 16 * 7 + 15):
        ans = _lanes.answer(values, root, N)
        ids = _lanes.nodes(root, N, 16)
        assert ans.numel() <= g.n_pad
        assert torch.equal(ans.view(16, -1), values[:, ids])
        assert int(ids[0]) == root % 16 and int(ids[-1]) >= N - 16


# --- the references -------------------------------------------------------

def test_stop_ranks_are_the_admissible_steps(graph):
    _, src, dst = graph
    e, tol = 0.001, PR_KIND.STOP_TOL
    for d in (0.70, 0.92):
        stops = ref.stop_ranks(src, dst, N, e, d, 100, tol)
        ranks, diffs = pagerank(src, dst, N, e, d, range(1, 61))
        want = [k for k in range(1, 61) if admissible(k, diffs, e, 100, tol)]
        assert sorted(stops) == want and want
        for k in want:
            assert torch.equal(stops[k], ranks[k])


def test_stop_ranks_past_the_first_steps(graph):
    _, src, dst = graph
    stops = ref.stop_ranks(src, dst, N, 1e-9, 0.92, 100, 0.01)
    assert min(stops) > ref.FIRST_STEPS


def test_one_step_more_reads_above_the_limit(graph):
    """One pass past a lane's stop reads above the limit, except where the
    step after the stop may stop too (its stop's diff within 1% below e):
    then it reads 0, no fault."""
    _, src, dst = graph
    e, tol, ids = 0.001, PR_KIND.STOP_TOL, _lanes.nodes(3, N, 16)
    faults = 0
    for d in PR_KIND.damping(PR_ARGS).tolist():
        _, diffs = pagerank(src, dst, N, e, d, range(1, 61))
        stop = next(k + 1 for k, diff in enumerate(diffs) if diff <= e)
        reading = ref.one_step_more(src, dst, N, e, d, 100, tol, ids)
        if admissible(stop + 1, diffs, e, 100, tol):
            assert reading == 0.0
        else:
            assert reading > limits()["lane_rank_rel_err"]
            faults += 1
    assert faults >= 12


# --- the cell, small, on the CPU -------------------------------------------

def limits():
    return spec.load_json("limits", CELL)["limits"]


def _run(kind):
    """The cell at N nodes with only ``kind``'s traffic, whose first call
    is checked however slow the machine."""
    c = spec.load_cell(CELL)
    c.config = dict(c.config, nodes=N, edges=M)
    kinds = [k for k in c.traffic["kinds"] if k["kind"] == kind]
    c.traffic = dict(c.traffic, queries=12, kinds=kinds)
    return cell.run_cell(c, 2**31 + 99, 0.5, False, "cpu",
                         time.perf_counter())


@pytest.mark.parametrize("kind,number", [
    ("gm_pagerank_lanes", "lane_rank_rel_err"),
    ("gm_hop_dist_lanes", "lane_hop_mismatch")])
def test_small_cell_is_correct(kind, number):
    res = _run(kind)
    assert res.correct is True, res.checks
    assert set(res.checks) == {number, "unchecked_kinds"}
    if number == "lane_hop_mismatch":
        assert res.checks[number]["value"] == 0
    else:
        assert 0 < res.checks[number]["value"] < 1e-5
    assert res.by_kind[kind]["mean_steps"] > 1


def _batch_wrapped(monkeypatch, change):
    """``CompiledProc.batch`` with ``change(self, g, over, fixed, run)``
    in its place, ``run`` the original."""
    batch = lower.CompiledProc.batch

    def wrapped(self, g, over, **fixed):
        return change(self, g, over, fixed,
                      lambda over_: batch(self, g, over_, **fixed))
    monkeypatch.setattr(lower.CompiledProc, "batch", wrapped)


def _one_pass_past_its_stop(monkeypatch):
    """The first lane's ranks one pass after its loop stopped."""
    def change(proc, g, over, fixed, run):
        out = run(over)
        if "d" in over:
            d0 = float(over["d"][0])
            steps = _passes(lambda: proc(g, d=d0, **fixed))["passes"]
            more = proc(g, e=0.0, d=d0, max=steps + 1)["pg_rank"]
            out["pg_rank"][0] = more
        return out
    _batch_wrapped(monkeypatch, change)


def _two_lanes_swapped(monkeypatch):
    def change(proc, g, over, fixed, run):
        out = run(over)
        for v in out.values():
            v[[0, 15]] = v[[15, 0]]
        return out
    _batch_wrapped(monkeypatch, change)


def _another_lanes_d(monkeypatch):
    def change(proc, g, over, fixed, run):
        if "d" in over:
            d = over["d"].clone()
            d[1] = d[0]
            over = dict(over, d=d)
        return run(over)
    _batch_wrapped(monkeypatch, change)


def _one_distance_altered(monkeypatch):
    """One sampled distance of one lane one more than it is."""
    answer = _lanes.answer

    def altered(values, root, n):
        out = answer(values, root, n)
        if not values.dtype.is_floating_point:
            out[5 * out.numel() // 16] += 1
        return out
    monkeypatch.setattr(_lanes, "answer", altered)


RANKS = ("gm_pagerank_lanes", "lane_rank_rel_err")
HOPS = ("gm_hop_dist_lanes", "lane_hop_mismatch")
FAULTS = [(_one_pass_past_its_stop, RANKS), (_two_lanes_swapped, RANKS),
          (_two_lanes_swapped, HOPS), (_another_lanes_d, RANKS),
          (_one_distance_altered, HOPS)]


@pytest.mark.parametrize("fault,kind_number", FAULTS,
                         ids=[f"{f.__name__}-{k[0]}" for f, k in FAULTS])
def test_check_catches(fault, kind_number, monkeypatch):
    kind, number = kind_number
    fault(monkeypatch)
    res = _run(kind)
    assert res.correct is False
    assert res.checks[number]["value"] > res.checks[number]["limit"]


# --- the metric readers -----------------------------------------------------

def _trace(spans=True):
    """A 1000 ns window: two passes (10-200, 300-600), a kernel launched
    in each (100-150, 350-450), a device-to-host copy in the second and a
    kernel launched outside them (700-900); the lane reduce's span around
    the first kernel, of 1e5 bytes."""
    from gmbench import trace
    evs = [Ev("gm:window", 0, 1000, corr=1)]
    if spans:
        evs += [Ev("gm:lower:pass", 10, 200, corr=2),
                Ev("gm:lower:pass", 300, 600, corr=3),
                Ev("gm:segment_reduce_sorted", 20, 40, corr=4)]
    for corr, launched, start, end, name in (
            (10, 30, 100, 150, "void segment_reduce_lanes_kernel"),
            (11, 320, 350, 450, "void k11"),
            (12, 500, 460, 480, "Memcpy DtoH (Device -> Pageable)"),
            (13, 650, 700, 900, "void k13")):
        evs += [Ev("cudaLaunchKernel", launched, launched + 2, corr=corr),
                Ev(name, start, end, cuda=True, corr=corr)]
    return trace.parse(evs, {"segment_reduce_sorted": 10**5} if spans
                       else {})


def _read(metric, tr):
    return spec.load_module("metrics", metric).read(
        cell.Record([1e-6], 1e-6, 0.0, 0, tr))


def test_metrics_on_made_up_events():
    tr = _trace()
    assert _read("kernels_per_pass", tr) == 1.0
    # idle gaps 0-100, 150-350, 450-460, 480-700, 900-1000: the midpoints
    # of the first, third and fourth lie inside a pass
    assert _read("pass_idle_pct", tr) == pytest.approx(
        100 * (100 + 10 + 220) / 1000)
    assert _read("lane_reduce_roofline_pct", tr) == pytest.approx(
        100 * 1e5 / 3.35e12 / 50e-9)


@pytest.mark.parametrize("metric", ["kernels_per_pass", "pass_idle_pct",
                                    "lane_reduce_roofline_pct"])
def test_metrics_none_without_spans(metric):
    assert _read(metric, _trace(spans=False)) is None


def test_live_lane_pct_reads_the_counter(graph, procs, monkeypatch):
    g, _, _ = graph
    batched, singles = _batched_and_single(g, procs, "hop_dist")
    lane_passes = [_passes(run)["passes"] for run in singles]
    lower.reset_lane_pass_counts()
    assert _read("live_lane_pct", None) is None
    batched()
    assert _read("live_lane_pct", None) == pytest.approx(
        100 * sum(lane_passes) / (16 * max(lane_passes)))
    monkeypatch.delattr(lower, "lane_pass_counts")
    assert _read("live_lane_pct", None) is None
