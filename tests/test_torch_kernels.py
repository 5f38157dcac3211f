"""The port's kernel wrappers and segment ops against green_marl_tpu's.

On the CPU every wrapper runs its plain PyTorch version.  The JAX side runs
its Pallas kernels in interpret mode, as tests/test_pallas_kernels.py does,
and its CPU path (``jax.ops.segment_*``, ``jnp.cumsum``).  The JAX CPU path
lets padded slots collect in the sentinel row ``N``; the port follows the
TPU kernel (identity in every row from ``N``), so against the JAX CPU path
only rows ``[:N]`` are compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.ops import pallas_kernels as pk
from green_marl_tpu.ops import scan_reduce as jsr
from green_marl_tpu.ops import segment as jseg
from green_marl_tpu_torch.graph.csr import graph_from_arrays, ARRAY_FIELDS
from green_marl_tpu_torch.ops import kernels as K
from green_marl_tpu_torch.ops import scan_reduce as tsr
from green_marl_tpu_torch.ops import segment as tseg

T = torch.from_numpy


def seg_case(e, n, seed, dtype, cross_chunk=False):
    """Sorted ids in [0, n) over ``e`` real slots, padded to a multiple of
    128 with id ``n`` as a Graph pads; many segments stay empty."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if cross_chunk:                     # one segment across the chunk edge
        ids[pk.CHUNK - 900:pk.CHUNK + 700] = ids[pk.CHUNK - 900]
        ids = np.sort(ids)
    if dtype == np.float32:
        vals = rng.random(e).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, e).astype(np.int32)
    off = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(ids, minlength=n), out=off[1:])
    e_pad = ((e + 127) // 128) * 128
    vals_p = np.zeros(e_pad, vals.dtype)
    vals_p[:e] = vals
    ids_p = np.full(e_pad, n, np.int32)
    ids_p[:e] = ids
    return vals_p, ids_p, off


def assert_match(got, want, dtype):
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("e,n,cross", [(pk.CHUNK - 3000, 9000, False),
                                       (2 * pk.CHUNK + 500, 700, True),
                                       (3 * pk.CHUNK - 200, 5000, False)])
def test_segment_reduce_sorted_matches_pallas(op, dtype, e, n, cross):
    vals, ids, off = seg_case(e, n, seed=e + n, dtype=dtype,
                              cross_chunk=cross)
    n_out = ((n + 1 + 127) // 128) * 128 + 128
    got = K.segment_reduce_sorted(T(vals), T(ids), T(off), n_out, op)
    assert got.shape == (n_out,)
    want = np.asarray(pk.segment_reduce_sorted(
        jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(off), n_out,
        op=op, interpret=True))
    assert_match(got.numpy(), want, dtype)
    ident = K.identity(op, got.dtype)
    assert (got[n:] == ident).all()
    jcpu = np.asarray(jseg.sorted_segment_reduce(
        jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(off), n_out, op))
    assert_match(got.numpy()[:n], jcpu[:n], dtype)
    # the dispatching entry point agrees on every row
    disp = tseg.sorted_segment_reduce(T(vals), T(ids), T(off), n_out, op)
    assert_match(disp.numpy(), got.numpy(), dtype)


def test_cumsum_matches_pallas_on_01_input():
    rng = np.random.default_rng(4)
    n = 2 * pk.CS_CHUNK + 4321
    v = (rng.random(n) < 0.3).astype(np.int32)
    want = np.asarray(pk.plain_cumsum(jnp.asarray(v), interpret=True))
    np.testing.assert_array_equal(K.plain_cumsum(T(v)).numpy(), want)
    np.testing.assert_array_equal(K.plain_cumsum_ref(T(v)).numpy(), want)
    np.testing.assert_array_equal(want, np.cumsum(v))
    offsets = np.sort(rng.integers(0, n, 600)).astype(np.int32)
    offsets[0], offsets[-1] = 0, n
    got = tsr.segment_sum_by_offsets(T(v), T(offsets), 700).numpy()
    ex = np.concatenate([[0], want])
    np.testing.assert_array_equal(got[:599], ex[offsets[1:]] - ex[offsets[:-1]])
    assert (got[599:] == 0).all()
    jgot = np.asarray(jsr.segment_sum_by_offsets(
        jnp.asarray(v), jnp.asarray(offsets), 700))
    np.testing.assert_array_equal(got, jgot)


def test_cumsum_wraps_like_int32():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1 << 30, 300_001).astype(np.int32)
    want = np.cumsum(v.astype(np.int64)).astype(np.int32)   # mod 2^32
    assert (want < 0).any()
    got = K.plain_cumsum(T(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    f = rng.standard_normal(1000).astype(np.float32)
    np.testing.assert_allclose(K.plain_cumsum(T(f)).numpy(),
                               np.cumsum(f.astype(np.float64)), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 300_001])
def test_exclusive_cumsum_plain_matches_numpy(n):
    """The exclusive form: n + 1 values, out[0] = 0, out[i] = sum(v[:i])
    mod 2^32 for int32 (the inputs wrap once n is large)."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, 1 << 30, n).astype(np.int32)
    want = np.zeros(n + 1, np.int64)
    np.cumsum(v.astype(np.int64), out=want[1:])
    want = want.astype(np.int32)                              # mod 2^32
    for fn in (K.plain_cumsum, K.plain_cumsum_ref):
        got = fn(T(v), exclusive=True)
        assert got.dtype == torch.int32 and got.shape == (n + 1,)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(K.plain_cumsum(T(v)).numpy(), want[1:])
    f = rng.standard_normal(n).astype(np.float32)
    got = K.plain_cumsum(T(f), exclusive=True).numpy()
    assert got[0] == 0.0
    np.testing.assert_allclose(got[1:], np.cumsum(f.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


def test_exclusive_cumsum_matches_pallas_on_01_input():
    rng = np.random.default_rng(6)
    v = (rng.random(pk.CS_CHUNK + 999) < 0.5).astype(np.int32)
    want = np.asarray(pk.plain_cumsum(jnp.asarray(v), interpret=True))
    np.testing.assert_array_equal(K.plain_cumsum(T(v), exclusive=True)
                                  .numpy(), np.concatenate([[0], want]))


def test_wrappers_check_arguments_and_count_only_launches():
    K.reset_launch_counts()
    x = torch.arange(10, dtype=torch.int32)
    off = torch.tensor([0, 4, 10], dtype=torch.int32)
    with pytest.raises(TypeError):
        K.plain_cumsum(x.long())
    with pytest.raises(ValueError):
        K.plain_cumsum(x[::2])
    with pytest.raises(ValueError):     # lanes are [B, n]: no third axis
        K.plain_cumsum(x.reshape(1, 2, 5))
    with pytest.raises(ValueError):
        K.segment_reduce_sorted(x, x, off, 2, "mul")
    with pytest.raises(TypeError):
        K.segment_reduce_sorted(x.double(), x, off, 2, "add")
    with pytest.raises(TypeError):
        K.segment_reduce_sorted(x, x, off.long(), 2, "add")
    with pytest.raises(ValueError):
        K.segment_reduce_sorted(x, x[:5], off, 2, "add")
    with pytest.raises(ValueError):
        K.segment_reduce_sorted(x, x, off, 1, "add")
    assert K.segment_reduce_sorted(x, x, off, 3, "max").tolist() == \
        [3, 9, torch.iinfo(torch.int32).min]
    # the CPU runs the plain versions: no kernel launched, nothing counted
    assert K.launch_counts() == {"segment_reduce_sorted": 0,
                                 "segment_reduce_sorted[gather]": 0,
                                 "plain_cumsum": 0, "segmented_scan": 0,
                                 "take_along_blocks": 0,
                                 "row_gather_checksum": 0,
                                 "edge_map_bor": 0,
                                 "edge_map_bor_level": 0, "bit_popstats": 0,
                                 "triangle_search": 0}


INT32_MAX = torch.iinfo(torch.int32).max


# -- the bit BFS's final popcount: the rule, the wrapper's checks, the CPU --

U8, I16, I32 = torch.uint8, torch.int16, torch.int32


@pytest.mark.parametrize("dtype,contiguous,takes", [
    (U8, True, True), (I16, True, True), (I32, True, True),
    (U8, False, False), (I16, False, False), (I32, False, False),
    (torch.int8, True, False), (torch.int64, True, False),
    (torch.bool, True, False), (torch.float32, True, False),
    (torch.float16, True, False), (torch.float64, True, False),
])
def test_bit_popstats_rule(dtype, contiguous, takes):
    why = K.bit_popstats_refusal(dtype, contiguous)
    assert (why is None) is takes
    assert takes or isinstance(why, str) and why


I64, F32 = torch.int64, torch.float32


@pytest.mark.parametrize("begin,dst,cum,contiguous,takes", [
    (I32, I32, I64, True, True), (I32, I32, I64, False, False),
    (I64, I32, I64, True, False), (I32, I64, I64, True, False),
    (I32, I32, I32, True, False), (I32, U8, I64, True, False),
    (F32, I32, I64, True, False), (I32, I32, F32, True, False),
])
def test_triangle_search_rule(begin, dst, cum, contiguous, takes):
    why = K.triangle_search_refusal(begin, dst, cum, contiguous)
    assert (why is None) is takes
    assert takes or isinstance(why, str) and why


def _tiny_dag():
    """The DAG of the triangle 0-1-2 and the edge 2-3 oriented by id:
    rows [1, 2], [2], [3], []; one wedge, (1, 2) of row 0, which closes
    the triangle."""
    return (torch.tensor([0, 2, 3, 4, 4], dtype=torch.int32),
            torch.tensor([1, 2, 2, 3], dtype=torch.int32),
            torch.tensor([0, 1, 1, 1, 1], dtype=torch.int64))


@pytest.mark.parametrize("bad", ["dst_int64", "strided", "begin_int64",
                                 "cum_int32", "cum_short", "two_d",
                                 "negative"])
def test_triangle_search_wrapper_checks(bad):
    """What the wrapper refuses raises on the CPU too; what it takes runs
    the plain version there and counts no launch; ids past the DAG's one
    wedge count nothing."""
    begin, dst, cum = _tiny_dag()
    n = 1
    if bad == "dst_int64":
        dst = dst.long()
    elif bad == "strided":
        dst = torch.stack([dst, dst], 1)[:, 0]
    elif bad == "begin_int64":
        begin = begin.long()
    elif bad == "cum_int32":
        cum = cum.int()
    elif bad == "cum_short":
        cum = cum[1:]
    elif bad == "two_d":
        begin = begin[None]
    else:
        n = -1
    K.reset_launch_counts()
    with pytest.raises(ValueError):
        K.triangle_search(begin, dst, cum, n)
    begin, dst, cum = _tiny_dag()
    got = K.triangle_search(begin, dst, cum, 1)
    assert got.dtype == torch.int64 and got.dim() == 0 and int(got) == 1
    assert int(K.triangle_search_ref(begin, dst, cum, 1)) == 1
    assert int(K.triangle_search(begin, dst, cum, 7, chunk=2)) == \
        int(K.triangle_search_ref(begin, dst, cum, 2)) == 1
    assert K.launch_counts()["triangle_search"] == 0


def _numpy_popstats(plane, deg, bits):
    """Instance ``lane * bits + bit``: its rows and their degree sum, one
    bit at a time in numpy int64 (independent of both torch versions)."""
    v = plane.numpy().astype(np.int64)
    d = deg.numpy().astype(np.int64)
    cnt = np.zeros((v.shape[1], bits), np.int64)
    trav = np.zeros_like(cnt)
    for i in range(bits):
        b = (v >> i) & 1
        cnt[:, i] = b.sum(0)
        trav[:, i] = (b * d[:, None]).sum(0)
    return cnt.reshape(-1), trav.reshape(-1)


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("dtype", [U8, I16, I32])
def test_bit_popstats_plain_on_the_cpu(dtype, lanes, monkeypatch):
    """On the CPU the wrapper takes the plain version and launches nothing;
    it equals ``_bit_popstats`` (chunked or not) and a numpy count, with
    degrees over all of int32 and counts past 2^32."""
    from green_marl_tpu_torch.models import batched
    rng = np.random.default_rng(lanes)
    bits = torch.iinfo(dtype).bits
    raw = rng.integers(0, 256, (1000, lanes * dtype.itemsize), dtype=np.uint8)
    raw[:300] = 255
    raw[300:500] = 0
    plane = T(raw).view(dtype)
    deg = T(rng.integers(-(1 << 31), 1 << 31, 1000).astype(np.int32))
    deg[:300] = (1 << 31) - 1
    K.reset_launch_counts()
    got = K.bit_popstats(plane, deg)
    want = _numpy_popstats(plane, deg, bits)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[1] > 1 << 32).any()
    via = batched._bit_popstats(plane, deg, lanes, bits)
    monkeypatch.setattr(batched, "_POP_CH", 37)     # many chunks
    chunked = batched._bit_popstats(plane, deg, lanes, bits)
    for g, a, b in zip(got, via, chunked):
        assert torch.equal(g, a) and torch.equal(g, b)
    assert K.launch_counts()["bit_popstats"] == 0


def test_bit_popstats_checks():
    from green_marl_tpu_torch.models import batched
    plane = torch.zeros((64, 4), dtype=torch.int32)
    deg = torch.zeros(64, dtype=torch.int32)
    for bad in (plane[:, ::2], plane.long(), plane.float(), plane[0]):
        with pytest.raises(ValueError):
            K.bit_popstats(bad, deg)
    with pytest.raises(TypeError):
        K.bit_popstats(plane, deg.long())
    with pytest.raises(ValueError):
        K.bit_popstats(plane, deg[1:])
    with pytest.raises(ValueError):                 # strided degrees
        K.bit_popstats(plane, torch.zeros(128, dtype=torch.int32)[::2])
    with pytest.raises(ValueError):                 # lanes: the plane's
        batched._bit_popstats(plane, deg, 3, 32)
    with pytest.raises(ValueError):                 # bits: the dtype's
        batched._bit_popstats(plane, deg, 4, 8)
    empty = K.bit_popstats(plane[:0], deg[:0])
    assert [t.tolist() for t in empty] == [[0] * 128] * 2


def gather_case(dtype, weighted, mask, wrap, seed=5):
    """A pull over CSC slots as ``models.relax`` makes it: ids (sources)
    in [0, n), sorted destinations with empty rows and a hub of 9,000
    slots across the card's 4,096-slot tile edges, pad slots holding the
    sentinel n, node tables of n_pad rows, rows n..n_out-1 past the
    offsets.  ``mask``: which nodes are set (all, none, one, random);
    ``wrap``: int32 values within 100 of INT32_MAX, so that adds wrap."""
    rng = np.random.default_rng(seed)
    n = 3000
    lens = rng.choice([0, 0, 1, 2, 5, 30], size=n)
    lens[n // 2] = 9000
    off = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    e = int(off[-1])
    e_pad, n_pad = -(-e // 128) * 128 + 128, -(-(n + 1) // 128) * 128
    ids = np.full(e_pad, n, np.int32)
    ids[:e] = rng.integers(0, n, e)
    dst = np.full(e_pad, n, np.int32)
    dst[:e] = np.repeat(np.arange(n), lens)
    if dtype == torch.int32:
        vals = (INT32_MAX - rng.integers(0, 100, n_pad) if wrap
                else rng.integers(0, 1000, n_pad)).astype(np.int32)
        add = rng.integers(1, 101, e_pad).astype(np.int32)
    else:
        vals = (100 * rng.random(n_pad)).astype(np.float32)
        vals[::7] = np.inf
        add = rng.random(e_pad).astype(np.float32)
    node_mask = {"all": np.ones(n_pad, bool), "none": np.zeros(n_pad, bool),
                 "one": np.arange(n_pad) == ids[e // 2],
                 "random": rng.random(n_pad) < 0.3}[mask]
    return (T(ids), T(dst), T(off), n_pad + 128, T(vals), T(node_mask),
            T(add) if weighted else None)


GATHER_CASES = [(dtype, weighted, mask, False)
                for dtype in (torch.int32, torch.float32)
                for weighted in (True, False)
                for mask in ("all", "none", "one", "random")] + [
    (torch.int32, True, "random", True), (torch.int32, False, "all", True)]


@pytest.mark.parametrize("dtype,weighted,mask,wrap", GATHER_CASES)
def test_segment_reduce_gather_form_matches_four_ops(dtype, weighted, mask,
                                                     wrap):
    """The gather form's plain version against the relax step's four ops
    before the form existed: gather, gather, add and where, then the plain
    segment min."""
    ids, dst, off, n_out, vals, node_mask, add = gather_case(
        dtype, weighted, mask, wrap)
    got = K.segment_reduce_sorted(ids, dst, off, n_out, "min",
                                  node_vals=vals, node_mask=node_mask,
                                  add=add)
    inf = torch.tensor(K.identity("min", dtype), dtype=dtype)
    w = add if add is not None else torch.ones_like(inf)
    cand = torch.where(node_mask.index_select(0, ids),
                       vals.index_select(0, ids) + w, inf)
    want = tseg.sorted_segment_reduce(cand, dst, off, n_out, "min")
    assert got.dtype == dtype and torch.equal(got, want)
    n = off.numel() - 1
    assert (got[n:] == inf).all()
    if wrap:                            # the add wrapped past INT32_MAX
        assert (got < 0).any()
    if mask == "none":
        assert (got == inf).all()
    else:
        assert (got[:n] < inf).any()


def test_launch_counts_with_a_wrapper_swapped_in(monkeypatch):
    """A caller may swap the module attribute for a wrapper that watches
    its calls (gmbench/trace.py, chip_smoke.py): the counts stay on the
    wrapper function itself, the gather form's too."""
    real = K.segment_reduce_sorted
    monkeypatch.setattr(K, "segment_reduce_sorted",
                        lambda *a, **kw: real(*a, **kw))
    K.reset_launch_counts()
    ids, dst, off, n_out, vals, node_mask, add = gather_case(
        torch.int32, True, "random", False)
    K.segment_reduce_sorted(ids, dst, off, n_out, "min", node_vals=vals,
                            node_mask=node_mask, add=add)
    counts = K.launch_counts()
    assert counts["segment_reduce_sorted"] == 0
    assert counts["segment_reduce_sorted[gather]"] == 0
    assert real.gather_launches == 0


def test_segment_reduce_gather_form_refusals():
    ids, dst, off, n_out, vals, node_mask, add = gather_case(
        torch.int32, True, "random", False)
    tables = dict(node_vals=vals, node_mask=node_mask, add=add)
    for op in ("add", "max"):
        with pytest.raises(ValueError):
            K.segment_reduce_sorted(ids, dst, off, n_out, op, **tables)
    with pytest.raises(ValueError):     # no lanes in the gather form
        K.segment_reduce_sorted(ids.expand(2, -1).contiguous(), dst, off,
                                n_out, "min", **tables)
    with pytest.raises(ValueError):
        K.segment_reduce_sorted(ids, dst, off, n_out, "min", node_vals=vals)
    with pytest.raises(ValueError):
        K.segment_reduce_sorted(ids, dst, off, n_out, "min",
                                node_mask=node_mask)
    with pytest.raises(ValueError):
        K.segment_reduce_sorted(ids, dst, off, n_out, "min", node_vals=vals,
                                node_mask=node_mask[:-1])
    with pytest.raises(ValueError):
        K.segment_reduce_sorted(ids, dst, off, n_out, "min", node_vals=vals,
                                node_mask=node_mask, add=add[:-1])
    with pytest.raises(TypeError):
        K.segment_reduce_sorted(ids, dst, off, n_out, "min", node_vals=vals,
                                node_mask=node_mask, add=add.float())
    with pytest.raises(TypeError):
        K.segment_reduce_sorted(ids.long(), dst, off, n_out, "min", **tables)


def scan_case(n, seed, dtype):
    """Sorted ids with runs of many lengths (some across the TPU kernel's
    chunk edge), int32 values that wrap when added, or floats."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([1, 1, 2, 3, 7, 40, 900, 5000], size=n)
    lens = lens[:np.searchsorted(np.cumsum(lens), n) + 1]   # >= n slots
    ids = np.repeat(np.arange(lens.size, dtype=np.int32), lens)[:n]
    if dtype == np.float32:
        vals = rng.standard_normal(n).astype(np.float32)
    else:
        vals = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    return vals, ids


OPS_SEED = {"add": 0, "min": 1, "max": 2}


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("n", [2 * pk.CHUNK + 4321, 700])
def test_segmented_scan_matches_pallas(op, dtype, n):
    """The port accepts any length; the JAX side is padded to a multiple
    of its chunk with identity values and a fresh id (-2)."""
    vals, ids = scan_case(n, seed=n + OPS_SEED[op], dtype=dtype)
    pad = -n % pk.CHUNK
    ident = K.identity(op, torch.from_numpy(vals).dtype)
    vals_p = np.concatenate([vals, np.full(pad, ident, dtype)])
    ids_p = np.concatenate([ids, np.full(pad, -2, np.int32)])
    want = np.asarray(pk.segmented_scan(jnp.asarray(vals_p),
                                        jnp.asarray(ids_p), op=op,
                                        interpret=True))[:n]
    got = K.segmented_scan(T(vals), T(ids), op)
    assert got.dtype == T(vals).dtype and got.shape == (n,)
    if dtype == np.float32 and op == "add":
        # float32 adds in another order: |err| <= 1e-5 * the running sum of
        # |vals| over the segment so far (a few ulps of that sum)
        seg_abs = K.segmented_scan_ref(T(np.abs(vals).astype(np.float64)),
                                       T(ids), "add").numpy()
        assert (np.abs(got.numpy() - want) <= 1e-5 * seg_abs + 1e-6).all()
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    if op == "add" and dtype == np.int32:
        assert (np.abs(want.astype(np.int64)) > 1 << 30).any()


def test_segmented_scan_edges():
    x = torch.tensor([5, 1, 2, 7], dtype=torch.int32)
    # ids[0] == -1 continues the TPU kernel's initial (identity) carry
    assert K.segmented_scan(x, torch.tensor([-1, -1, 3, 3],
                                            dtype=torch.int32)).tolist() \
        == [5, 6, 2, 9]
    assert K.segmented_scan(x, torch.zeros(4, dtype=torch.int32),
                            "max").tolist() == [5, 5, 5, 7]
    assert K.segmented_scan(x[:0], x[:0]).numel() == 0
    assert K.segmented_scan(x[:1], x[:1], "min").tolist() == [5]
    with pytest.raises(TypeError):
        K.segmented_scan(x, x.long())
    with pytest.raises(ValueError):
        K.segmented_scan(x, x[:3])
    with pytest.raises(ValueError):
        K.segmented_scan(x, x, "mul")
    with pytest.raises(ValueError):
        K.segmented_scan(x[::2], x[::2])


def edge_layout(name, dtype):
    """(vals, ids, offsets) for a layout that stresses a tiled kernel: slots
    before ``offsets[0]`` carry id -1 (the TPU kernel's initial carry id),
    slots after the last segment carry id N, as a Graph pads.  Floats are
    multiples of 1/8, so that every sum is exact in any order."""
    rng = np.random.default_rng(len(name))
    short = rng.choice([0, 1, 1, 2, 5, 40], size=600)
    lens, lead, trail = {
        "hub over every slot": ([pk.CHUNK + 777], 0, 0),
        "empty segments at both ends": (
            np.concatenate([np.zeros(300, int), short, [pk.CHUNK],
                            np.zeros(200, int)]), 0, 0),
        "offsets[0] > 0": (np.concatenate([[900], short, [3000]]), 333, 210),
    }[name]
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    off += lead
    e = int(off[-1]) + trail
    e_pad = ((e + 127) // 128) * 128
    ids = np.full(e_pad, len(lens), np.int32)
    ids[:lead] = -1
    ids[lead:int(off[-1])] = np.repeat(np.arange(len(lens), dtype=np.int32),
                                       lens)
    if dtype == np.float32:
        vals = (rng.integers(0, 16, e_pad) / 8).astype(np.float32)
    else:
        vals = rng.integers(-(1 << 30), 1 << 30, e_pad).astype(np.int32)
    return vals, ids, off.astype(np.int32)


EDGE_LAYOUTS = ["hub over every slot", "empty segments at both ends",
                "offsets[0] > 0"]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("layout", EDGE_LAYOUTS)
def test_segment_reduce_sorted_edge_layouts_match_pallas(layout, op, dtype):
    vals, ids, off = edge_layout(layout, dtype)
    n = off.size - 1
    n_out = n + 130
    got = K.segment_reduce_sorted(T(vals), T(ids), T(off), n_out, op)
    want = np.asarray(pk.segment_reduce_sorted(
        jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(off), n_out,
        op=op, interpret=True))
    assert_match(got.numpy()[:n], want[:n], dtype)
    assert (got[n:] == K.identity(op, got.dtype)).all()
    empty = np.diff(off) == 0
    assert (got.numpy()[:n][empty] == K.identity(op, got.dtype)).all()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("layout", EDGE_LAYOUTS)
def test_segmented_scan_edge_layouts_match_pallas(layout, op, dtype):
    vals, ids, _ = edge_layout(layout, dtype)
    n = vals.size
    pad = -n % pk.CHUNK
    ident = K.identity(op, T(vals).dtype)
    want = np.asarray(pk.segmented_scan(
        jnp.asarray(np.concatenate([vals, np.full(pad, ident, dtype)])),
        jnp.asarray(np.concatenate([ids, np.full(pad, -2, np.int32)])),
        op=op, interpret=True))[:n]
    got = K.segmented_scan(T(vals), T(ids), op)
    assert_match(got.numpy(), want, dtype)


@pytest.fixture(scope="module")
def graphs():
    src, dst = jgen.rmat_edges(1500, 12000, seed=11)
    jg, _ = jfrom_edges(src, dst, 1500)
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, jg.num_nodes,
                           jg.num_edges)
    return jg, tg


def test_pull_and_push_reductions_match_jax(graphs):
    jg, tg = graphs
    N = jg.num_nodes
    rng = np.random.default_rng(12)
    fv = rng.random(jg.n_pad).astype(np.float32)
    iv = rng.integers(-500, 500, jg.n_pad).astype(np.int32)
    ew = rng.integers(1, 9, jg.e_pad).astype(np.int32)
    for name in ("in_nbr_sum", "in_nbr_min", "in_nbr_max", "out_nbr_sum",
                 "out_nbr_min"):
        for vals, dtype in ((fv, np.float32), (iv, np.int32)):
            want = np.asarray(getattr(jseg, name)(jg, jnp.asarray(vals)))
            got = getattr(tseg, name)(tg, T(vals)).numpy()
            assert_match(got[:N], want[:N], dtype)
    want = np.asarray(jseg.in_nbr_min(jg, jnp.asarray(iv), jnp.asarray(ew),
                                      combine=lambda a, b: a + b))
    got = tseg.in_nbr_min(tg, T(iv), T(ew), combine=lambda a, b: a + b)
    np.testing.assert_array_equal(got.numpy()[:N], want[:N])
    want = np.asarray(jsr.in_nbr_sum_int(jg, jnp.asarray(iv),
                                         jnp.asarray(ew)))
    np.testing.assert_array_equal(tsr.in_nbr_sum_int(tg, T(iv), T(ew))
                                  .numpy(), want)
    mask = rng.random(jg.n_pad) < 0.2
    for name in ("in_nbr_count_true", "out_nbr_count_true"):
        want = np.asarray(getattr(jsr, name)(jg, jnp.asarray(mask)))
        np.testing.assert_array_equal(getattr(tsr, name)(tg, T(mask))
                                      .numpy(), want)


def test_unsorted_and_whole_graph_reductions_match_jax(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(13)
    ids = rng.integers(0, 300, 5000).astype(np.int32)
    for dtype in (np.int32, np.float32):
        vals = rng.integers(-50, 50, 5000).astype(dtype)
        for name in ("segment_sum", "segment_min", "segment_max"):
            want = np.asarray(getattr(jseg, name)(jnp.asarray(vals),
                                                  jnp.asarray(ids), 320))
            got = getattr(tseg, name)(T(vals), T(ids), 320).numpy()
            np.testing.assert_array_equal(got, want)
    v = rng.integers(-9, 9, jg.n_pad).astype(np.int32)
    where = rng.random(jg.n_pad) < 0.5
    assert int(tseg.masked_node_sum(tg, T(v))) == \
        int(jseg.masked_node_sum(jg, jnp.asarray(v)))
    assert int(tseg.masked_node_max(tg, T(v), -99, T(where))) == \
        int(jseg.masked_node_max(jg, jnp.asarray(v), -99,
                                 jnp.asarray(where)))
    assert int(tseg.masked_node_min(tg, T(v), 99)) == \
        int(jseg.masked_node_min(jg, jnp.asarray(v), 99))
    pad_only = np.zeros(jg.n_pad, bool)
    pad_only[jg.num_nodes:] = True
    for m in (where, pad_only):
        assert bool(tseg.node_any(tg, T(m))) == \
            bool(jseg.node_any(jg, jnp.asarray(m)))
