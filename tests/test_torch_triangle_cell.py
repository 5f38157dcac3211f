"""Triangle counting as the benchmark runs it (``gmbench`` cell
``lj.triangles``): ``triangle_count`` on lj's RMAT made undirected,
through each of ``count_dag``'s routes, against the plain reference of
``gmbench/reference/triangles.py`` and the transliterated ``.gm``
(``triangle_count_np``); the router's choice at the cell's sizes; the DAG
built with torch against the host build; the generator; the search's
spans and counter; the cell small on the CPU and the faults its check must
catch; the cell's metric readers.  CPU only; this file imports neither
JAX nor ``green_marl_tpu``."""

import collections
import time

import numpy as np
import pytest
import torch

from gmbench import cell, spec
from gmbench.edges import Sample
from gmbench.reference import triangles as ref
from gmbench.tests.test_gmbench_run import Ev
from green_marl_tpu_torch.graph import native
from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.models import triangle as ttri
from green_marl_tpu_torch.ops import kernels as K
from green_marl_tpu_torch.ops import segment
from tests.test_torch_cuda import SEARCH_CASES, search_dag, search_edges

CELL = "lj.triangles"
CPU = [torch.profiler.ProfilerActivity.CPU]
GEN = spec.load_module("graphs", "rmat_undirected")
# (nodes, edges, structure seed): small RMATs of the cell's generator
GRAPHS = [(300, 2500, 1), (1000, 9000, 2), (2000, 20000, 3)]


def _config(n, m, structure_seed=1):
    return dict(spec.load_cell(CELL).config, nodes=n, edges=m,
                structure_seed=structure_seed)


def _graph(n, m, structure_seed, seed=2**31 + 5):
    """The cell's edges at a small size and the port's graph of them."""
    e = GEN.draw(_config(n, m, structure_seed), seed, "cpu")
    return e, from_edges(e.src.numpy(), e.dst.numpy(), n)[0]


@pytest.fixture(scope="module", params=GRAPHS, ids=lambda p: f"n{p[0]}")
def small(request):
    e, g = _graph(*request.param)
    want = ttri.triangle_count_np(g.begin.numpy(),
                                  g.node_idx[:g.num_edges].numpy())
    assert want > 0
    return e, g, want


# --- the reference ------------------------------------------------------------

def test_reference_equals_the_transliterated_gm(small):
    e, _, want = small
    assert ref.count(e.src, e.dst, e.num_nodes) == want
    assert ref.count(e.src, e.dst, e.num_nodes, chunk=97) == want


def test_reference_ignores_directions_and_duplicates():
    """The directed draw, with each edge twice and a self-loop added, has
    the undirected graph's triangles."""
    cfg = _config(1000, 9000, 2)
    directed = spec.load_module("graphs", "rmat").draw(cfg, 7, "cpu")
    e = GEN.draw(cfg, 7, "cpu")
    src = torch.cat([directed.src, directed.src, directed.src[:1]])
    dst = torch.cat([directed.dst, directed.dst, directed.src[:1]])
    assert ref.count(src, dst, 1000) == ref.count(e.src, e.dst, 1000) > 0


# --- the port, through each route -------------------------------------------

def _force(monkeypatch, path):
    """Thresholds that make ``route`` give ``path`` on a small DAG."""
    if path != "bitmap":
        monkeypatch.setattr(ttri, "_BITMAP_MAX_N", 1)
    if path == "sortmerge":
        monkeypatch.setattr(ttri, "_HASH_MIN_W", 1)
        monkeypatch.setattr(ttri, "_SM_DISPATCH_W", 1 << 13)
    ttri._PREP_CACHE.clear()


@pytest.mark.parametrize("path", ["bitmap", "search", "sortmerge"])
def test_each_route_equals_the_reference(small, path, monkeypatch):
    e, g, want = small
    _force(monkeypatch, path)
    assert ttri.route(ttri._dag_of(g)) == path
    assert ttri.triangle_count(g, chunk=4096) == want
    assert ttri.triangle_count(g) == ref.count(e.src, e.dst, e.num_nodes)


def _fake_dag(n, wedges):
    """A DAG context of ``n`` rows and ``wedges`` wedges, for the router
    alone: it reads the row count and the wedge count."""
    return ttri.DagContext(dag_begin=torch.empty(n + 1, dtype=torch.int32),
                           dag_dst=torch.empty(0, dtype=torch.int32),
                           pair_cum=torch.empty(0, dtype=torch.int64),
                           num_wedges=wedges, num_dag_edges=0)


@pytest.mark.parametrize("n,wedges,path", [
    (4_847_571, 1_414_000_000, "search"),     # the cell's DAG
    (4_800_000, 1_413_985_012, "search"),     # the probe's default graph
    (2_097_152, 142_508_493, "search"),       # the probe's 2^27-wedge RMAT
    (1_048_576, 67_281_342, "search"),        # 2^26 wedges
    (60_000, 1 << 20, "bitmap"),
    (60_000, (1 << 25) + 1, "search"),
    (3, 0, "none")])
def test_router_choice(n, wedges, path):
    assert ttri.route(_fake_dag(n, wedges)) == path


def test_join_still_forced_for_tests(monkeypatch):
    monkeypatch.setattr(ttri, "_HASH_MIN_W", 1)
    assert ttri.route(_fake_dag(4_847_571, 1_414_000_000)) == "sortmerge"


# --- the DAG built with torch -----------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("dedup", [True, False])
def test_torch_dag_equals_the_host_build(use_native, dedup, monkeypatch):
    from green_marl_tpu_torch.graph import csr, generate
    src, dst = csr.to_undirected(*generate.rmat_edges(700, 7000, seed=4),
                                 dedup=dedup)
    g = from_edges(src, dst, 700)[0]
    if use_native:
        assert native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    begin, node_idx = g.begin, g.node_idx[:g.num_edges]
    want = ttri.dag_to_device(
        ttri.build_dag_host(begin.numpy(), node_idx.numpy(), 700), "cpu")
    got = ttri.build_dag(g)
    for name in ("dag_begin", "dag_dst", "pair_cum"):
        w, t = getattr(want, name), getattr(got, name)
        assert t.dtype == w.dtype and torch.equal(t, w), name
    assert (got.num_wedges, got.num_dag_edges) == \
        (want.num_wedges, want.num_dag_edges)
    assert 2 * got.num_dag_edges <= g.num_edges


def test_torch_dag_of_an_empty_graph():
    g = from_edges(np.zeros(0, np.int32), np.zeros(0, np.int32), 5)[0]
    ctx = ttri.build_dag(g)
    assert (ctx.num_wedges, ctx.num_dag_edges) == (0, 0)
    assert ttri.triangle_count(g) == 0


# --- the generator ------------------------------------------------------------

DRAW_KEYS = ["nodes", "edges", "a", "b", "c", "perturb", "self_loops",
             "structure_seed", "lengths"]


@pytest.mark.parametrize("key", DRAW_KEYS)
def test_configuration_draws_lj(key):
    assert spec.load_cell(CELL).config[key] == \
        spec.load_json("configs", "lj")[key]


def test_generator_is_rmat_made_simple_and_undirected():
    cfg = _config(1000, 9000, 2)
    directed = spec.load_module("graphs", "rmat").draw(cfg, 11, "cpu")
    e = GEN.draw(cfg, 11, "cpu")
    n = 1000
    keys = e.src.long() * n + e.dst
    assert torch.equal(keys, torch.unique(keys))       # sorted, no duplicate
    assert not (e.src == e.dst).any()
    rev = torch.sort(e.dst.long() * n + e.src).values
    assert torch.equal(rev, keys)                      # symmetric
    d = torch.unique(torch.cat([directed.src.long() * n + directed.dst,
                                directed.dst.long() * n + directed.src]))
    assert torch.equal(d, keys)                        # rmat's edges, both ways
    assert torch.equal(e.labels, directed.labels)
    assert e.lens.shape == e.src.shape and e.num_nodes == n


# --- the search's synthetic DAGs of the card tests, on the CPU ----------------

@pytest.mark.parametrize("case", SEARCH_CASES)
def test_search_cases_on_the_cpu(case):
    """The card tests' DAGs (oriented by id: a hub row longer than a tile,
    empty rows at both ends): the plain search, in one chunk and in several,
    and the wrapper on the CPU agree with the degree-ordered route's
    count."""
    src, dst, n = search_edges(case)
    ctx = search_dag(src, dst, n, "cpu")
    args = (ctx.dag_begin, ctx.dag_dst, ctx.pair_cum, ctx.num_wedges)
    got = int(K.triangle_search_ref(*args))
    keep = src != dst
    g = from_edges(np.concatenate([src[keep], dst[keep]]),
                   np.concatenate([dst[keep], src[keep]]), n)[0]
    assert got == int(K.triangle_search(*args)) == \
        ttri.triangle_count(g) > 0
    assert int(K.triangle_search_ref(*args, chunk=(1 << 18) + 3)) == got
    ttri._PREP_CACHE.clear()


# --- spans and the counter ----------------------------------------------------

def test_search_counts_and_spans(monkeypatch):
    _, g = _graph(1000, 9000, 2)
    _force(monkeypatch, "search")
    ttri.reset_search_counts()
    with torch.profiler.profile(activities=CPU) as prof:
        t = ttri.triangle_count(g, chunk=5000)
    ctx = ttri._dag_of(g)
    chunks = -(-ctx.num_wedges // 5000)
    steps = max(1, int(ctx.dag_begin.diff().max()).bit_length()) + 1
    assert chunks > 2 and t > 0
    assert ttri.search_counts() == {"calls": 1, "chunks": chunks,
                                    "wedges": ctx.num_wedges,
                                    "steps": chunks * steps}
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("gm:"))
    assert names == {"gm:setup": 1, "gm:triangle:count": 1,
                     "gm:triangle:chunk": 1}
    ttri.triangle_count(g, chunk=5000)
    assert ttri.search_counts()["calls"] == 2
    ttri.reset_search_counts()
    assert set(ttri.search_counts().values()) == {0}


def test_no_profiler_no_span(monkeypatch):
    _, g = _graph(1000, 9000, 2)
    _force(monkeypatch, "search")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert ttri.triangle_count(g, chunk=5000) > 0


# --- the cell, small, on the CPU ---------------------------------------------

def _run(monkeypatch, path="search", n=2000, m=20000):
    """The cell at n nodes through ``path``; every call checked."""
    _force(monkeypatch, path)
    c = spec.load_cell(CELL)
    c.config = dict(c.config, nodes=n, edges=m)
    c.traffic = dict(c.traffic, queries=12, check={"every": 1, "max": 4})
    return cell.run_cell(c, 2**31 + 99, 0.5, False, "cpu",
                         time.perf_counter())


@pytest.mark.parametrize("path", ["search", "sortmerge"])
def test_small_cell_is_correct(path, monkeypatch):
    res = _run(monkeypatch, path)
    assert res.correct is True, res.checks
    assert set(res.checks) == {"triangle_mismatch", "unchecked_kinds"}
    assert res.checks["triangle_mismatch"]["value"] == 0


def test_kind_call_then_check():
    kind = spec.load_module("queries", "triangles")
    e, g = _graph(2000, 20000, 1)
    state = kind.prepare(g, None, {})
    answer, info = kind.call(state, 0)
    assert answer.dtype == torch.int64 and answer.numel() == 1
    sample = Sample(0, answer.clone(), info)
    assert kind.check([sample, sample], e, {}) == {"triangle_mismatch": 0}
    off = Sample(0, answer + 1, info)
    assert kind.check([sample, off], e, {}) == {"triangle_mismatch": 1}


def _off_by_one(monkeypatch):
    count = ttri.triangle_count
    monkeypatch.setattr(ttri, "triangle_count", lambda g: count(g) + 1)


def _dropped_chunk(monkeypatch):
    """The search's second chunk finds nothing (the plain search's
    bisection, ``ops/segment.py`` ``row_contains``, which it looks up at
    each call)."""
    search, contains = ttri.count_search, segment.row_contains

    def dropping(ctx, chunk=1 << 24):
        seen = []

        def second_empty(*args):
            seen.append(1)
            hit = contains(*args)
            return hit & False if len(seen) == 2 else hit
        monkeypatch.setattr(segment, "row_contains", second_empty)
        try:
            return search(ctx, chunk=ctx.num_wedges // 4 + 1)
        finally:
            monkeypatch.setattr(segment, "row_contains", contains)
    monkeypatch.setattr(ttri, "count_search", dropping)


def _dag_without(ctx, slot):
    """``ctx`` with DAG slot ``slot`` removed, its pair prefix made
    again."""
    begin = ctx.dag_begin.long().clone()
    row = int(torch.searchsorted(begin, slot, right=True)) - 1
    begin[row + 1:] -= 1
    D = ctx.num_dag_edges - 1
    dst = torch.cat([ctx.dag_dst[:slot], ctx.dag_dst[slot + 1:D + 1]])
    rows = torch.repeat_interleave(torch.arange(begin.numel() - 1),
                                   begin.diff())
    pairs = begin[rows + 1] - torch.arange(1, D + 1)
    cum = torch.zeros(D + 1, dtype=torch.int64)
    cum[1:] = pairs.cumsum(0)
    return ttri.DagContext(dag_begin=begin.to(torch.int32), dag_dst=dst,
                           pair_cum=cum, num_wedges=int(cum[D]),
                           num_dag_edges=D)


def _closing_slot(ctx):
    """A DAG slot b -> c that closes a triangle (a -> b, a -> c)."""
    begin = ctx.dag_begin.tolist()
    dst = ctx.dag_dst.tolist()
    rows = [dst[begin[r]:begin[r + 1]] for r in range(len(begin) - 1)]
    for row in rows:
        for i, b in enumerate(row):
            for c in row[i + 1:]:
                if c in rows[b]:
                    return begin[b] + rows[b].index(c)
    raise AssertionError("no triangle")


def _edge_removed(monkeypatch):
    build = ttri.build_dag

    def without_one(g):
        ctx = build(g)
        return _dag_without(ctx, _closing_slot(ctx))
    monkeypatch.setattr(ttri, "build_dag", without_one)


FAULTS = [_off_by_one, _dropped_chunk, _edge_removed]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_check_catches(fault, monkeypatch):
    fault(monkeypatch)
    res = _run(monkeypatch, n=1000, m=9000)
    assert res.correct is False
    assert res.checks["triangle_mismatch"]["value"] > 0


# --- the metric readers -------------------------------------------------------

def _trace(spans=True):
    """A 1000 ns window: two counts (10-400, 500-900), chunks 20-200,
    210-390 and 510-890, a kernel launched in each chunk (100-150,
    250-350, 600-700), a device-to-host copy in the second count and a
    kernel launched outside them (940-990)."""
    from gmbench import trace
    evs = [Ev("gm:window", 0, 1000, corr=1)]
    if spans:
        evs += [Ev("gm:triangle:count", 10, 400, corr=2),
                Ev("gm:triangle:count", 500, 900, corr=3),
                Ev("gm:triangle:chunk", 20, 200, corr=4),
                Ev("gm:triangle:chunk", 210, 390, corr=5),
                Ev("gm:triangle:chunk", 510, 890, corr=6)]
    for corr, launched, start, end, name in (
            (10, 30, 100, 150, "void k10"),
            (11, 220, 250, 350, "void k11"),
            (12, 520, 600, 700, "void k12"),
            (13, 895, 880, 890, "Memcpy DtoH (Device -> Pageable)"),
            (14, 930, 940, 990, "void k14")):
        evs += [Ev("cudaLaunchKernel", launched, launched + 2, corr=corr),
                Ev(name, start, end, cuda=True, corr=corr)]
    return trace.parse(evs, {})


def _read(metric, tr):
    return spec.load_module("metrics", metric).read(
        cell.Record([1e-6], 1e-6, 0.0, 0, tr))


def test_metrics_on_made_up_events(monkeypatch):
    monkeypatch.setattr(ttri, "search_counts",
                        lambda: {"calls": 3, "chunks": 6, "wedges": 3000,
                                 "steps": 60})
    tr = _trace()
    assert _read("kernels_per_chunk", tr) == 1.0
    # 2 counts x 1000 wedges over the 250 ns of kernels launched in them
    assert _read("search_gwedges_per_s", tr) == pytest.approx(
        2 * 1000 / 250e-9 / 1e9)
    # idle gaps 0-100, 150-250, 350-600, 700-880, 890-940, 990-1000: the
    # midpoints of the first, second and fourth lie inside a count; the
    # third's (475) falls between the counts, the fifth's (915) after them
    assert _read("triangle_idle_pct", tr) == pytest.approx(
        100 * (100 + 100 + 180) / 1000)


@pytest.mark.parametrize("metric", ["search_gwedges_per_s",
                                    "kernels_per_chunk",
                                    "triangle_idle_pct"])
def test_metrics_none_without_spans(metric):
    assert _read(metric, _trace(spans=False)) is None


def test_rate_none_without_the_counter(monkeypatch):
    monkeypatch.delattr(ttri, "search_counts")
    assert _read("search_gwedges_per_s", _trace()) is None
    monkeypatch.setattr(ttri, "search_counts",
                        lambda: dict.fromkeys(ttri._SEARCH_KEYS, 0),
                        raising=False)
    assert _read("search_gwedges_per_s", _trace()) is None
