"""The batched bit-plane BFS as the benchmark runs it (``gmbench`` cell
``lj.multi_bfs``): ``multi_source_bfs_bits`` with ``bits_schedule``
against the plain reference ``gmbench/reference/multi_bfs.py``, the
kind's batch rule, the faults its check must catch, the engine's spans and
its edge-map counter.  CPU only; this file imports neither JAX nor
``green_marl_tpu``."""

import collections
import time

import numpy as np
import pytest
import torch

from gmbench import cell, spec
from gmbench.metrics import _edge_map_bytes
from gmbench.reference import multi_bfs as ref
from gmbench.tests.test_gmbench_run import Ev
from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.graph.generate import rmat_edges
from green_marl_tpu_torch.models import batched
from green_marl_tpu_torch.ops import binned

N, M = 2000, 14000
CPU = [torch.profiler.ProfilerActivity.CPU]
KIND = spec.load_module("queries", "multi_bfs")


@pytest.fixture(scope="module")
def graph():
    src, dst = rmat_edges(N, M, seed=11)
    g, _ = from_edges(src, dst, N)
    return g, torch.from_numpy(src), torch.from_numpy(dst)


def _sources(g, count):
    """``count`` sources: every tenth node with an out-edge, then two
    without one."""
    deg = g.out_degree()[:N]
    with_edges = torch.nonzero(deg > 0).flatten()[::10][:count - 2]
    without = torch.nonzero(deg == 0).flatten()[:2]
    assert without.numel() == 2
    return torch.cat([with_edges, without]).numpy().astype(np.int32)


@pytest.mark.parametrize("pb,count", [(8, 37), (16, 37), (32, 70)])
def test_bits_equal_the_reference(graph, pb, count):
    g, src, dst = graph
    roots = _sources(g, count)
    assert count % pb
    bp, deg_rows, chunk = batched.bits_schedule(g, count, pb)
    res = batched.multi_source_bfs_bits(bp, roots, deg_rows, plane_bits=pb,
                                        slot_chunk=chunk)
    want_r, want_t = ref.counts(src, dst, N, roots.tolist())
    assert torch.equal(res.reached, want_r)
    assert torch.equal(res.traversed, want_t)
    assert res.reached[-1] == 1 and res.traversed[-1] == 0


def test_batch_rule(graph):
    g, src, _ = graph
    from_graph = KIND.eligible(g.out_degree()[:N], 1)
    from_edges_ = KIND.eligible(torch.bincount(src.long(), minlength=N), 1)
    np.testing.assert_array_equal(from_graph, from_edges_)
    pivot = int(from_graph[len(from_graph) // 3])
    sources = KIND.batch(from_graph, pivot, 100)
    assert sources[0] == pivot and len(set(sources.tolist())) == 100
    assert np.array_equal(sources, KIND.batch(from_edges_, pivot, 100))
    with pytest.raises(ValueError):
        KIND.batch(from_graph, int(np.setdiff1d(np.arange(N),
                                                from_graph)[0]), 100)
    with pytest.raises(ValueError):
        KIND.batch(from_graph, pivot, len(from_graph) + 1)


DRAW_KEYS = ["generator", "nodes", "edges", "a", "b", "c", "perturb",
             "self_loops", "structure_seed", "lengths"]


@pytest.mark.parametrize("key", DRAW_KEYS + ["widths"])
def test_cell_runs_its_configuration(key):
    """The ``lj_msbfs`` deployment holds ``lj``'s graph, drawn the same
    way, and the batch widths it states are the ones its traffic runs."""
    c = spec.load_cell("lj.multi_bfs")
    if key == "widths":
        (kind,) = c.traffic["kinds"]
        assert (c.config["sources_per_call"], c.config["plane_bits"]) == \
            (kind["args"]["batch"], kind["args"]["plane_bits"]) == (4096, 32)
    else:
        assert c.config[key] == spec.load_json("configs", "lj")[key]


def _small():
    c = spec.load_cell("lj.multi_bfs")
    c.config = dict(c.config, nodes=3000, edges=24000)
    kinds = [dict(k, args=dict(k["args"], batch=48))
             for k in c.traffic["kinds"]]
    c.traffic = dict(c.traffic, queries=8, kinds=kinds)
    return c


def _run():
    return cell.run_cell(_small(), 2**31 + 99, 0.5, False, "cpu",
                         time.perf_counter())


def test_small_cell_is_correct():
    res = _run()
    assert res.correct is True, res.checks
    assert set(res.checks) == set(KIND.NUMBERS) | {"unchecked_kinds"}
    assert res.by_kind["multi_bfs"]["mean_steps"] > 1


def _unchanged_step(monkeypatch):
    loop = batched.while_loop
    monkeypatch.setattr(batched, "while_loop",
                        lambda step, *a: loop(lambda s: s, *a))


def _one_bit_flipped(monkeypatch):
    """One bit of one lane set where it was clear, in the visited plane of
    the instance that reaches most (always among those compared)."""
    popstats = batched._bit_popstats

    def flipped(visited, deg_rows, lanes, bits=8):
        b = int(popstats(visited, deg_rows, lanes, bits)[0].argmax())
        lane, bit = b // bits, b % bits
        row = int(torch.nonzero((visited[:N, lane] >> bit) & 1 == 0)[0, 0])
        visited = visited.clone()
        visited[row, lane] ^= 1 << bit
        return popstats(visited, deg_rows, lanes, bits)
    monkeypatch.setattr(batched, "_bit_popstats", flipped)


def _two_swapped(monkeypatch):
    """The answers of the instances that reach least and most swapped."""
    bits = batched.multi_source_bfs_bits

    def swapped(*args, **kwargs):
        res = bits(*args, **kwargs)
        i, j = int(res.reached.argmin()), int(res.reached.argmax())
        order = torch.arange(res.reached.numel())
        order[i], order[j] = j, i
        return res._replace(reached=res.reached[order],
                            traversed=res.traversed[order])
    monkeypatch.setattr(batched, "multi_source_bfs_bits", swapped)


@pytest.mark.parametrize("fault", [_unchanged_step, _one_bit_flipped,
                                   _two_swapped], ids=lambda f: f.__name__)
def test_check_catches(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert res.correct is False
    assert res.checks["msbfs_mismatch"]["value"] > 0


def _profiled_call(g, roots, pb):
    bp, deg_rows, chunk = batched.bits_schedule(g, len(roots), pb)
    with torch.profiler.profile(activities=CPU) as prof:
        res = batched.multi_source_bfs_bits(bp, roots, deg_rows,
                                            plane_bits=pb, slot_chunk=chunk)
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("gm:"))
    return res, names


@pytest.mark.parametrize("pb", [8, 32])
def test_spans_a_call(graph, pb):
    g, _, _ = graph
    res, names = _profiled_call(g, _sources(g, 40), pb)
    assert res.levels_run > 1
    assert names["gm:edge_map"] == res.levels_run
    assert names["gm:popstats"] == 1 and names["gm:setup"] == 1
    assert names["gm:superstep"] == res.levels_run + 1


@pytest.mark.parametrize("pb", [8, 32])
def test_a_level_is_one_level_call(graph, pb, monkeypatch):
    """A level is one ``binned.edge_map_level`` call (on the CPU its plain
    version: no launch) and no ``edge_map`` call, and the loop reads its
    predicate, the level's row count, once a level; the planes and counts
    are the paged form's."""
    from green_marl_tpu_torch.ops import kernels as K
    g, _, _ = graph
    roots = _sources(g, 40)
    bp, deg_rows, chunk = batched.bits_schedule(g, 40, pb)
    want = batched.multi_source_bfs_bits_paged(bp, roots, deg_rows,
                                               plane_bits=pb,
                                               slot_chunk=chunk)
    calls = collections.Counter()
    level = binned.edge_map_level

    def counted(*args, **kwargs):
        calls["edge_map_level"] += 1
        return level(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("edge_map called by a bit-BFS level")

    monkeypatch.setattr(binned, "edge_map_level", counted)
    monkeypatch.setattr(binned, "edge_map", refused)
    K.reset_launch_counts()
    with torch.profiler.profile(activities=CPU) as prof:
        res = batched.multi_source_bfs_bits(bp, roots, deg_rows,
                                            plane_bits=pb, slot_chunk=chunk)
    reads = sum(e.name == "gm:sync:predicate" for e in prof.events())
    assert res.levels_run == want.levels_run > 1
    assert calls["edge_map_level"] == reads == res.levels_run
    assert K.launch_counts()["edge_map_bor_level"] == 0
    assert torch.equal(res.visited, want.visited)
    assert torch.equal(res.reached, want.reached)
    assert torch.equal(res.traversed, want.traversed)


@pytest.mark.parametrize("B,pb,lanes", [
    (1, 8, 16), (40, 8, 16), (129, 8, 32), (4096, 8, 512), (200, 16, 16),
    (2048, 16, 128), (100, 32, 4), (130, 32, 8), (4096, 32, 128)])
def test_planes_are_padded_to_16_bytes(graph, B, pb, lanes):
    """A call's planes have rows of a multiple of 16 bytes, at least 16
    (the rows the edge-map kernels take), with every pad lane 0; the
    result's planes have ``ceil(B / pb)`` lanes, the padded planes' first,
    and the counts are the reference's."""
    g, src, dst = graph
    roots = (np.arange(B) * 7 % N).astype(np.int32)
    bp, deg_rows, chunk = batched.bits_schedule(g, B, pb)
    seed = batched._bits_seed(bp, roots, pb)
    assert batched._plane_lanes(B, pb) == lanes == seed.shape[1]
    assert seed.dtype == batched.PLANE_DTYPES[pb]
    row_bytes = lanes * seed.element_size()
    assert row_bytes % 16 == 0 and 16 <= row_bytes <= 512
    kept = -(-B // pb)
    assert not bool(seed[:, kept:].any())
    assert int(seed.view(torch.uint8).numpy().sum(dtype=np.int64)) > 0
    if B > 256:
        return
    res = batched.multi_source_bfs_bits(bp, roots, deg_rows, plane_bits=pb,
                                        slot_chunk=chunk)
    paged = batched.multi_source_bfs_bits_paged(bp, roots, deg_rows,
                                                plane_bits=pb,
                                                slot_chunk=chunk)
    for got in (res, paged):
        assert got.visited.shape == (bp.n_rows, kept)
        assert got.visited.is_contiguous()
        assert torch.equal(got.visited, res.visited)
        assert got.reached.shape == got.traversed.shape == (B,)
    want_r, want_t = ref.counts(src, dst, N, roots.tolist())
    assert torch.equal(res.reached, want_r)
    assert torch.equal(res.traversed, want_t)


def test_no_profiler_no_record_function(graph, monkeypatch):
    g, _, _ = graph
    roots = _sources(g, 40)
    bp, deg_rows, _ = batched.bits_schedule(g, 40, 8)
    want = batched.multi_source_bfs_bits(bp, roots, deg_rows)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = batched.multi_source_bfs_bits(bp, roots, deg_rows)
    assert torch.equal(got.visited, want.visited)


@pytest.mark.parametrize("pb", [8, 32])
def test_counter_follows_the_schedule(graph, pb):
    g, _, _ = graph
    roots = _sources(g, 40)
    bp, deg_rows, chunk = batched.bits_schedule(g, 40, pb)
    binned.reset_edge_map_counts()
    res = batched.multi_source_bfs_bits(bp, roots, deg_rows, plane_bits=pb,
                                        slot_chunk=chunk)
    k = res.levels_run
    # a level's planes: rows padded to 16 bytes (the result's are not)
    row_bytes = batched._plane_lanes(40, pb) * res.visited.element_size()
    assert row_bytes == 16
    counts = binned.edge_map_counts()
    assert counts == {"calls": k, "slots": k * bp.slot_src.numel(),
                      "rows": k * bp.n_rows,
                      "table_bytes": k * bp.n_rows * row_bytes}
    assert _edge_map_bytes.edge_map_bytes(counts) == k * (
        4 * bp.slot_src.numel() + 2 * bp.n_rows * row_bytes)
    assert _edge_map_bytes.per_call() == \
        _edge_map_bytes.edge_map_bytes(counts) / k
    binned.reset_edge_map_counts()
    assert set(binned.edge_map_counts().values()) == {0}
    assert _edge_map_bytes.per_call() is None


def _trace(engine_spans=True):
    """A 1000 ns window: two edge maps, each launching one kernel of 100
    ns, then a popcount of 200 ns, and a 100 ns kernel outside them."""
    from gmbench import trace
    evs = [Ev("gm:window", 0, 1000, corr=1)]
    if engine_spans:
        evs += [Ev("gm:edge_map", 10, 50, corr=2),
                Ev("gm:edge_map", 200, 240, corr=3),
                Ev("gm:popstats", 400, 450, corr=4)]
    for corr, launched, start in ((10, 20, 100), (11, 210, 250),
                                  (12, 410, 500), (13, 800, 850)):
        evs += [Ev("cudaLaunchKernel", launched, launched + 2, corr=corr),
                Ev(f"void k{corr}", start,
                    start + (200 if corr == 12 else 100), cuda=True,
                    corr=corr)]
    return trace.parse(evs, {})


def test_engine_metrics_on_made_up_events(graph):
    g, _, _ = graph
    bp, deg_rows, _ = batched.bits_schedule(g, 40, 32)
    binned.reset_edge_map_counts()
    binned.edge_map(bp, torch.zeros((bp.n_rows, 2), dtype=torch.int32),
                    "bor")
    per_call = 4 * bp.slot_src.numel() + 2 * bp.n_rows * 8
    rec = cell.Record([1e-6], 1e-6, 0.0, 0, _trace())
    read = lambda m: spec.load_module("metrics", m).read(rec)
    assert read("edge_map_roofline_pct") == pytest.approx(
        100 * 2 * per_call / 3.35e12 / 200e-9)
    assert read("popstats_share_pct") == pytest.approx(40.0)
    bare = cell.Record([1e-6], 1e-6, 0.0, 0, _trace(engine_spans=False))
    for m in ("edge_map_roofline_pct", "popstats_share_pct"):
        assert spec.load_module("metrics", m).read(bare) is None
    binned.reset_edge_map_counts()
    assert read("edge_map_roofline_pct") is None
