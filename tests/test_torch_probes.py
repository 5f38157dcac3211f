"""The gather probes' kernels (their plain versions, on the CPU) against the
TPU probes' Pallas kernel bodies.

``scripts/probe_gather{,2,3}.py`` run their whole measurement at import, so
they cannot be imported.  What each of their Pallas bodies computes on one
block is a ``jnp.take_along_axis`` expression; it is written out here,
mapped over the blocks with ``jax.vmap`` and run in JAX on the CPU, on the
same numpy inputs.  ``scripts/probe_gather4.py`` guards its measurement
behind ``main()``, so its ``gather_kernel`` itself runs here under
``pl.pallas_call(..., interpret=True)`` on a tiny table: interpret mode
runs its DMA semaphores on the CPU.  Gathers are exact: equality.
"""

import functools
import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from green_marl_tpu_torch.ops import kernels as K
from green_marl_tpu_torch.probes import gather as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "probe_gather4", os.path.join(REPO, "scripts", "probe_gather4.py"))
probe_gather4 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe_gather4)

T = torch.from_numpy
L = 128


# The Pallas kernel bodies, one block each (t: the table block, i: the idx
# block), as in scripts/probe_gather.py:109-130, probe_gather2.py:118-129
# and probe_gather3.py:95-96.
def kern_sub(t, i):
    r = jnp.clip(i >> 7, 0, t.shape[0] - 1)
    return jnp.take_along_axis(t, r, axis=0)


def kern_lane(t, i):
    return jnp.take_along_axis(t[:i.shape[0], :], i & 127, axis=1)


def kern_full(t, i):
    r = jnp.clip(i >> 7, 0, t.shape[0] - 1)
    rows = jnp.take_along_axis(t, r, axis=0)
    return jnp.take_along_axis(rows, i & 127, axis=1)


def kern_axis0(t, i):
    return jnp.take_along_axis(t, i, axis=0)


def kern_axis1(t, i):
    return jnp.take_along_axis(t, i, axis=1)


def kern_row(t, i):
    return jnp.take_along_axis(t, jnp.broadcast_to(i[:, :1], t.shape),
                               axis=0)


def jax_blocks(body, table, idx, bh, th, window):
    nb = idx.shape[0] // bh
    ib = jnp.asarray(idx).reshape(nb, bh, L)
    if window:
        return np.asarray(jax.vmap(lambda i: body(jnp.asarray(table[:th]),
                                                  i))(ib)).reshape(-1, L)
    tb = jnp.asarray(table[:nb * th]).reshape(nb, th, L)
    return np.asarray(jax.vmap(body)(tb, ib)).reshape(-1, L)


WINDOW = [("axis0", kern_sub), ("axis1", kern_lane),
          ("composed", kern_full)]


@pytest.mark.parametrize("mode,body", WINDOW, ids=[m for m, _ in WINDOW])
def test_window_modes_match_probe_gather(mode, body):
    """probe_gather.py: a fixed window, split indices, rows clipped (the
    indices run past the window so that the clip is exercised)."""
    rng = np.random.default_rng(1)
    th, bh, R = 64, 16, 96
    table = rng.random((th, L)).astype(np.float32)
    idx = rng.integers(0, th * L + 3000, (R, L)).astype(np.int32)
    want = jax_blocks(body, table, idx, bh, th, window=True)
    got = K.take_along_blocks(T(table), T(idx), mode, bh, th, window=True,
                              split=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (idx >> 7 >= th).any()


BLOCKED = [("axis0", kern_axis0, 8), ("axis0", kern_axis0, 64),
           ("axis1", kern_axis1, 32), ("row", kern_row, 16)]


@pytest.mark.parametrize("mode,body,sub", BLOCKED,
                         ids=[f"{m}-{s}" for m, _, s in BLOCKED])
def test_blocked_modes_match_probe_gather2_3(mode, body, sub):
    """probe_gather2/3.py: the block of each grid step, in-range indices."""
    rng = np.random.default_rng(sub)
    R = 4 * sub
    table = rng.random((R, L)).astype(np.float32)
    hi = L if mode == "axis1" else sub
    idx = rng.integers(0, hi, (R, L)).astype(np.int32)
    want = jax_blocks(body, table, idx, sub, sub, window=False)
    got = K.take_along_blocks(T(table), T(idx), mode, sub)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got.shape == (R, L)


def kern_row_split(t, i):
    r = jnp.clip(i[:, :1] >> 7, 0, t.shape[0] - 1)
    return jnp.take_along_axis(t, jnp.broadcast_to(r, t.shape), axis=0)


ROW = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("window,split", ROW,
                         ids=[f"window{w:d}-split{s:d}" for w, s in ROW])
def test_row_mode_matches_probe_gather2(window, split):
    """The row-broadcast body with a fixed window and split indices, as the
    card's row kernel takes them; the row mode never stages its block."""
    rng = np.random.default_rng(20 + 2 * window + split)
    bh, th, R = 32, 32, 128          # bh = th: the body's output shape
    table = rng.random((th if window else R, L)).astype(np.float32)
    hi = th * L + 3000 if split else th
    idx = rng.integers(0, hi, (R, L)).astype(np.int32)
    body = kern_row_split if split else kern_row
    want = jax_blocks(body, table, idx, bh, th, window)
    got = K.take_along_blocks(T(table), T(idx), "row", bh, th, window, split)
    np.testing.assert_array_equal(got.numpy(), want)
    assert K.take_along_route(th, "row") == "row"
    assert K.take_along_route(th) == "slab"


def test_take_along_blocks_checks_arguments():
    t = torch.zeros((64, L))
    i = torch.zeros((32, L), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.take_along_blocks(t, i, "diag", 16)
    with pytest.raises(ValueError):
        K.take_along_blocks(t, i, "axis0", 24)          # 32 % 24
    with pytest.raises(ValueError):
        K.take_along_blocks(t[:16], i, "axis0", 8)      # table too short
    with pytest.raises(ValueError):
        K.take_along_blocks(t, i, "axis1", 16, table_rows=8, window=True)
    with pytest.raises(TypeError):
        K.take_along_blocks(t.double(), i, "axis0", 16)
    with pytest.raises(ValueError):
        K.take_along_blocks(t[:, :64], i, "axis0", 16)
    with pytest.raises(ValueError):
        K.take_along_blocks(t, i.t().contiguous().t(), "axis0", 16)
    assert K.take_along_route(256, "axis1") == "block"
    assert K.take_along_route(1024, "axis1") == "L2"


def pallas_row_gather(table, idx, k, sweeps, monkeypatch):
    """probe_gather4.gather_kernel at R = len(idx), T = sweeps."""
    monkeypatch.setattr(probe_gather4, "R", idx.shape[0])
    monkeypatch.setattr(probe_gather4, "T", sweeps)
    roww = table.shape[1]
    kern = functools.partial(probe_gather4.gather_kernel, k_bufs=k,
                             roww=roww)
    out = pl.pallas_call(
        kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
            scratch_shapes=[pltpu.VMEM((k, roww), jnp.int32),
                            pltpu.SemaphoreType.DMA((k,))]),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(table))
    return int(np.asarray(out)[0, 0])


@pytest.mark.parametrize("roww,k", [(8, 1), (32, 4), (128, 2)])
def test_row_gather_matches_probe_gather4(roww, k, monkeypatch):
    rng = np.random.default_rng(roww + k)
    table = rng.integers(0, 100, (300, roww)).astype(np.int32)
    idx = rng.integers(0, 300, 48).astype(np.int32)
    want = pallas_row_gather(table, idx, k, 3, monkeypatch)
    got = K.row_gather_checksum(T(table), T(idx), sweeps=3, k=k)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want == 3 * int(table[idx, 0].sum())


ROW_IDS = ["duplicates", "out of range"]


@pytest.mark.parametrize("ids", ROW_IDS)
def test_row_gather_duplicates_and_clipping_match_probe_gather4(
        ids, monkeypatch):
    """Ids that name few rows many times, and ids outside the table on both
    sides.  The port clips an id to the table; the Pallas kernel's DMA takes
    the row it is told, so it is given the clipped ids."""
    rng = np.random.default_rng(len(ids))
    n_rows = 40
    table = rng.integers(-(1 << 20), 1 << 20, (n_rows, 8)).astype(np.int32)
    if ids == "duplicates":
        idx = rng.choice([3, 3, 3, 17, 39, 0], 64).astype(np.int32)
    else:
        idx = rng.integers(-n_rows, 2 * n_rows, 64).astype(np.int32)
        assert (idx < 0).any() and (idx >= n_rows).any()
    clipped = np.clip(idx, 0, n_rows - 1)
    want = pallas_row_gather(table, clipped, 4, 2, monkeypatch)
    got = K.row_gather_checksum(T(table), T(idx), sweeps=2, k=4)
    assert int(got) == want == 2 * int(table[clipped, 0].sum())
    assert int(K.row_gather_checksum_ref(T(table), T(idx), 2)) == want


ODD_TH = [("axis0", kern_sub, True), ("axis0", kern_axis0, False),
          ("composed", kern_full, True)]


@pytest.mark.parametrize("mode,body,split", ODD_TH,
                         ids=[f"{m}-split{s:d}" for m, _, s in ODD_TH])
@pytest.mark.parametrize("th", [24, 100])
def test_odd_table_heights_match_probe_bodies(mode, body, split, th):
    """Table blocks whose height is no power of two, so that no slab of a
    power-of-two number of columns fills its shared memory exactly: a fixed
    window with split indices, and blocked layouts with plain ones."""
    rng = np.random.default_rng(th + split)
    bh, steps = (8, 6) if split else (th, 3)
    R = bh * steps
    table = rng.random((th if split else R, L)).astype(np.float32)
    hi = th * L + 500 if split else th
    idx = rng.integers(0, hi, (R, L)).astype(np.int32)
    want = jax_blocks(body, table, idx, bh, th, window=split)
    got = K.take_along_blocks(T(table), T(idx), mode, bh, th, window=split,
                              split=split)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.take_along_blocks_ref(T(table), T(idx), mode, bh, th, split,
                                split).numpy(), want)


def test_route_of_every_probe_shape():
    """The route is picked by shape alone: every case of the probe has one,
    a slab fits its shared memory, and the names are the C entry's."""
    for c in probe.take_cases():
        route = K.take_along_route(c.table_rows, c.mode)
        assert route in K.TAKE_ROUTES and probe.route_name(c).startswith(route)
        cols = K.take_along_slab_cols(c.table_rows)
        if route == "slab":
            assert c.mode == "axis0" and L % cols == 0
            assert K.SLAB_MIN_COLS <= cols <= L
            assert c.table_rows * cols * 4 <= K.SLAB_BYTES <= K.SMEM_BYTES
            assert cols == L or c.table_rows * 2 * cols * 4 > K.SLAB_BYTES
        if route == "block":
            assert c.table_rows * L * 4 <= K.SMEM_BYTES
        assert (route == "row") == (c.mode == "row")
    assert K.take_along_slab_cols(1 << 20) == 0
    assert K.take_along_route(16384) == "L2"    # 2 columns would fit
    assert K.take_along_route(1 << 20) == "L2"
    assert K.take_along_slab_cols(1) == L


def test_row_gather_scratch_sizes():
    for n in (0, 1, 1000, 1 << 21):
        zeroed, binned = K.row_gather_scratch(n)
        # the sum, then a histogram and a cursor word per table region
        assert zeroed == 1 + 2 * K.ROW_GATHER_BINS and binned == n
    # the kernel's own count of regions is a constant of its source
    src = (pathlib.Path(K.__file__).parent.parent / "csrc"
           / "gather_probe.cu").read_text()
    assert f"constexpr int kBins = {K.ROW_GATHER_BINS};" in src


def test_row_gather_wraps_and_checks():
    rng = np.random.default_rng(3)
    table = rng.integers(1 << 29, 1 << 30, (50, 8)).astype(np.int32)
    idx = rng.integers(0, 50, 40).astype(np.int32)
    exact = 7 * int(table[idx, 0].astype(np.int64).sum())
    want = np.array(exact % (1 << 32), np.uint32).view(np.int32)
    assert int(K.row_gather_checksum(T(table), T(idx), sweeps=7)) == want
    t, i = T(table), T(idx)
    with pytest.raises(ValueError):
        K.row_gather_checksum(t, i, k=3)
    with pytest.raises(ValueError):
        K.row_gather_checksum(t[:, :6], i)
    with pytest.raises(TypeError):
        K.row_gather_checksum(t.long(), i)
    with pytest.raises(ValueError):
        K.row_gather_checksum(t, i, sweeps=0)
    with pytest.raises(ValueError):
        K.row_gather_checksum(t, i[::2])


def test_probe_cases_cover_every_tpu_probe_kernel():
    cases = probe.take_cases()
    replaced = {c.replaces for c in cases}
    assert replaced == {"scripts/probe_gather.py:109",
                        "scripts/probe_gather.py:116",
                        "scripts/probe_gather.py:124",
                        "scripts/probe_gather2.py:118",
                        "scripts/probe_gather2.py:122",
                        "scripts/probe_gather2.py:126",
                        "scripts/probe_gather2.py:154",
                        "scripts/probe_gather3.py:95"}
    for c in cases:           # every block height divides the idx rows
        assert probe.E_ROWS % c.block_rows == 0
    assert [s for s in (8, 64, 256, 1024, 4096, 16384)
            if any(c.block_rows == s and not c.window for c in cases)] == \
        [8, 64, 256, 1024, 4096, 16384]
    assert len(probe.gather_grid()) == 15
    assert set(probe.take_cases(quick=True)) <= set(cases)


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        probe.main(["--quick"])
    assert "GPU" in str(e.value.code)
    with pytest.raises(ValueError):
        probe.run(torch.device("cpu"))


def _script(name):
    """``scripts/<name>.py`` as a module (its measurement is behind
    ``main``)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["probes.segment", "probes.profile_apps",
                                  "probe_relax", "probe_edge_map",
                                  "probes.triangle"])
def test_segment_and_profile_probes_need_a_card(name):
    """Each measures the card: without one it exits with a message, and
    never times the plain versions on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = (importlib.import_module(f"green_marl_tpu_torch.{name}")
           if name.startswith("probes.") else _script(name))
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert "GPU" in str(e.value.code)


# probes/bounds.py against the benchmark's frozen counts, where both count
# the same thing: the probes and the benchmark's ruler cannot drift apart
@pytest.mark.parametrize("lanes", [1, 16])
def test_segment_reduce_bound_is_the_benchmarks(lanes):
    """With offsets over every slot (parity10k's CSC: 0 to E = e_pad), the
    slots in range are every value the benchmark counts."""
    from gmbench.metrics import _roofline
    from green_marl_tpu_torch.graph import binary_io
    from green_marl_tpu_torch.probes import bounds
    g, _, _ = binary_io.load_graph(
        os.path.join(REPO, "data", "parity", "parity10k.bin"))
    off = g.r_begin
    assert int(off[0]) == 0 and int(off[-1]) == g.e_pad
    got = bounds.segment_reduce(int(off[-1]) - int(off[0]), off.numel(),
                                g.n_pad, lanes=lanes)
    assert got == _roofline.segment_reduce_bytes(
        lanes * g.e_pad, off.numel(), g.n_pad, lanes)


@pytest.mark.parametrize("lanes,exclusive", [(1, False), (1, True),
                                             (16, False), (16, True)])
def test_cumsum_bound_is_the_benchmarks(lanes, exclusive):
    from gmbench.metrics import _roofline
    from green_marl_tpu_torch.probes import bounds
    n = 69_000_064
    assert bounds.plain_cumsum(n, lanes=lanes, exclusive=exclusive) == \
        _roofline.cumsum_bytes(n, lanes, exclusive)


def test_edge_map_bound_is_the_benchmarks():
    """The table-once bound of one ``edge_map`` call is what the benchmark
    counts from that call's counter; the gathered-rows bound adds a row a
    slot past the table's own rows."""
    from gmbench.metrics import _edge_map_bytes
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.graph.generate import rmat_edges
    from green_marl_tpu_torch.models import batched
    from green_marl_tpu_torch.ops import binned
    from green_marl_tpu_torch.probes import bounds
    src, dst = rmat_edges(2000, 14000, seed=11)
    g, _ = from_edges(src, dst, 2000)
    bp, _, chunk = batched.bits_schedule(g, 64, 32)
    table = torch.zeros((bp.n_rows, 2), dtype=torch.int32)
    binned.reset_edge_map_counts()
    binned.edge_map(bp, table, "bor", slot_chunk=chunk)
    counts = binned.edge_map_counts()
    binned.reset_edge_map_counts()
    slots, row_bytes = bp.slot_src.numel(), 8
    table_once, gathered = bounds.edge_map_bor(slots, bp.n_rows, row_bytes)
    assert counts["calls"] == 1
    assert table_once == _edge_map_bytes.edge_map_bytes(counts)
    assert gathered - table_once == (slots - bp.n_rows) * row_bytes


def test_edge_map_level_bound():
    """A bit-BFS level (``binned.edge_map_level``) counts as one edge-map
    call of the same shape in the benchmark's counter; its bounds add the
    bytes of ``visited`` that the level reads and writes to the edge
    map's."""
    from gmbench.metrics import _edge_map_bytes
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.graph.generate import rmat_edges
    from green_marl_tpu_torch.models import batched
    from green_marl_tpu_torch.ops import binned
    from green_marl_tpu_torch.probes import bounds
    src, dst = rmat_edges(2000, 14000, seed=11)
    g, _ = from_edges(src, dst, 2000)
    bp, _, chunk = batched.bits_schedule(g, 128, 32)
    frontier = torch.zeros((bp.n_rows, 4), dtype=torch.int32)
    binned.reset_edge_map_counts()
    binned.edge_map_level(bp, frontier, torch.zeros_like(frontier),
                          slot_chunk=chunk)
    counts = binned.edge_map_counts()
    binned.reset_edge_map_counts()
    slots, row_bytes = bp.slot_src.numel(), 16
    em_table, em_gathered = bounds.edge_map_bor(slots, bp.n_rows, row_bytes)
    table_once, gathered = bounds.edge_map_bor_level(slots, bp.n_rows,
                                                     row_bytes, 48, 32)
    assert counts["calls"] == 1
    assert em_table == _edge_map_bytes.edge_map_bytes(counts)
    assert table_once - em_table == gathered - em_gathered == 48 + 32
    assert bounds.edge_map_bor_level(slots, bp.n_rows, row_bytes, 0, 0) \
        == (em_table, em_gathered)


@pytest.mark.parametrize("seed", [12, 13])
def test_triangle_search_bound(seed):
    """The wedge search's two bounds from a degree-ordered DAG's shapes:
    the row offsets and rows once, and for each slot that anchors a wedge
    its row b's two bounds and entries, counted here slot by slot."""
    from green_marl_tpu_torch.graph.csr import from_edges, to_undirected
    from green_marl_tpu_torch.graph.generate import rmat_edges
    from green_marl_tpu_torch.models import triangle
    from green_marl_tpu_torch.probes import bounds
    from green_marl_tpu_torch.probes import triangle as probe_tri
    src, dst = rmat_edges(1500, 12000, seed=seed)
    g = from_edges(*to_undirected(src, dst, dedup=True), 1500)[0]
    ctx = triangle.build_dag(g)
    D, n = ctx.num_dag_edges, ctx.dag_begin.numel() - 1
    begin, dag_dst = ctx.dag_begin.numpy(), ctx.dag_dst.numpy()
    cum = ctx.pair_cum.numpy()
    anchors = [s for s in range(D) if cum[s + 1] > cum[s]]
    entries = sum(int(begin[dag_dst[s] + 1] - begin[dag_dst[s]])
                  for s in anchors)
    assert 0 < len(anchors) < D and entries > 0
    assert probe_tri.search_shape(ctx) == (len(anchors), entries)
    assert bounds.triangle_search(n, D, len(anchors), entries) == \
        (4 * (n + 1) + 4 * D, 8 * len(anchors) + 4 * entries)


@pytest.mark.parametrize("weighted,want", [(False, 451_012),
                                           (True, 771_012)])
def test_relax_bound_on_parity10k(weighted, want):
    """By hand, parity10k (N = 10,000, E = e_pad = 80,000, n_pad = 10,112):
    4 bytes of id (8 with the weight) a slot, 4 a CSC offset (10,001), and
    4 + 4 + 1 a node for the rows out, ``dist`` and ``updated``."""
    from green_marl_tpu_torch.graph import binary_io
    from green_marl_tpu_torch.probes import bounds
    g, _, _ = binary_io.load_graph(
        os.path.join(REPO, "data", "parity", "parity10k.bin"))
    off = g.r_begin
    assert (g.num_edges, g.e_pad, off.numel(), g.n_pad) == \
        (80_000, 80_000, 10_001, 10_112)
    assert bounds.relax(int(off[-1]) - int(off[0]), off.numel(), g.n_pad,
                        weighted) == want
    assert want == (8 if weighted else 4) * 80_000 + 4 * 10_001 \
        + 9 * 10_112


def test_profile_groups_name_the_ports_kernels():
    from green_marl_tpu_torch.probes import profile_apps as pa
    assert pa.group_of("void (anonymous namespace)::segment_reduce_kernel"
                       "<float, 0, true>(...)") == "segment reduce"
    assert pa.group_of("(anonymous namespace)::tile_rows_kernel(int const*"
                       ")") == "segment reduce"
    assert pa.group_of("void (anonymous namespace)::segment_reduce_lanes_"
                       "kernel<float, 0, true>(...)") == "segment reduce"
    assert pa.group_of("void (anonymous namespace)::scan_kernel<unsigned "
                       "int, true, true>") == "prefix sum"
    assert pa.group_of("void at::native::(anonymous namespace)::"
                       "indexSelectLargeIndex<int, long>") == \
        "gathers (index_select)"
    # torch runs gathers and scatters through one kernel: the launching
    # operator decides, and without one the time stays unsplit
    shared = ("void at::native::_scatter_gather_elementwise_kernel<128, 8, "
              "at::native::_cuda_scatter_gather_internal_kernel<...>>")
    assert pa.group_of(shared, "aten::index_select") == pa.GATHERS
    assert pa.group_of(shared, "aten::gather") == pa.GATHERS
    assert pa.group_of(shared, "aten::scatter_reduce_") == pa.SCATTERS
    assert pa.group_of(shared, "aten::index_add_") == pa.SCATTERS
    assert pa.group_of(shared) == pa.UNSPLIT
    assert pa.by_group({shared: 3.0, "x_elementwise_y": 1.0},
                       {"aten::index_select": 2.0,
                        "aten::scatter_add_": 1.0}) == \
        {pa.GATHERS: 2.0, "elementwise": 1.0, pa.SCATTERS: 1.0}
    assert pa.by_group({shared: 3.0}) == {pa.UNSPLIT: 3.0}
    assert pa.group_of("Memset (Device)") == "copies and memsets"
    assert pa.group_of("void at::native::vectorized_elementwise_kernel<4, "
                       "at::native::FillFunctor<int>>") == "elementwise"
    assert pa.group_of("void at::native::reduce_kernel<512, 1, ...>") == \
        "reductions"
    assert pa.group_of("something else") == "other"
    assert pa.by_group({"Memset (Device)": 1.0, "x_elementwise_y": 2.0,
                        "Memcpy DtoH": 0.5}) == \
        {"elementwise": 2.0, "copies and memsets": 1.5}
