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


def test_wrappers_check_arguments_and_count_only_launches():
    K.reset_launch_counts()
    x = torch.arange(10, dtype=torch.int32)
    off = torch.tensor([0, 4, 10], dtype=torch.int32)
    with pytest.raises(TypeError):
        K.plain_cumsum(x.long())
    with pytest.raises(ValueError):
        K.plain_cumsum(x[::2])
    with pytest.raises(ValueError):
        K.plain_cumsum(x.reshape(2, 5))
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
                                 "plain_cumsum": 0, "segmented_scan": 0,
                                 "take_along_blocks": 0,
                                 "row_gather_checksum": 0}


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
