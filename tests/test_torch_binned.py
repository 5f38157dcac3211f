"""The port's degree-binned edge map against green_marl_tpu's.

Small RMAT graphs from a numpy seed go through ``build_binned`` and
``edge_map`` of both packages.  ``w_max`` is small (16, 8) so that hub
chunks and their second-stage reduction exist.  Schedules must be equal
field by field; integer, OR and bitwise-OR maps bit for bit; float sums
within rtol 1e-5 (float32 added in another order than XLA's).  The port's
bit planes are uint8/int16/int32 where JAX's are uint8/uint16/uint32: the
same bits, compared through ``.view``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.ops import binned as jb
from green_marl_tpu_torch.graph.csr import ARRAY_FIELDS, graph_from_arrays
from green_marl_tpu_torch.ops import binned as tb

T = torch.from_numpy
FIELDS = ("slot_src", "slot_edge", "hub_owner", "perm", "inv_perm")
STATIC = ("bins", "n_nodes", "n_rows", "n_hub", "hub_row_off",
          "n_hub_chunks", "e_pad", "w_max")
# JAX plane dtype -> the port's dtype with the same bits
PLANES = {np.uint8: torch.uint8, np.uint16: torch.int16,
          np.uint32: torch.int32}


@pytest.fixture(scope="module")
def graphs():
    src, dst = jgen.rmat_edges(1200, 14000, seed=31)
    jg, _ = jfrom_edges(src, dst, 1200)
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, jg.num_nodes,
                           jg.num_edges)
    return jg, tg


@pytest.fixture(scope="module")
def schedules(graphs):
    jg, tg = graphs
    return jb.binned_in(jg, w_max=16), tb.binned_in(tg, w_max=16)


def assert_same_schedule(jbp, tbp):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tbp, f).numpy(),
                                      np.asarray(getattr(jbp, f)), err_msg=f)
        assert getattr(tbp, f).dtype == torch.int32
    for f in STATIC:
        assert getattr(tbp, f) == getattr(jbp, f), f


@pytest.mark.parametrize("direction,w_max", [("in", 16), ("out", 8),
                                             ("in", tb.W_MAX)])
def test_build_binned_matches_jax(graphs, direction, w_max):
    jg, tg = graphs
    jbp = getattr(jb, f"binned_{direction}")(jg, w_max=w_max)
    tbp = getattr(tb, f"binned_{direction}")(tg, w_max=w_max)
    assert_same_schedule(jbp, tbp)
    if w_max < 100:
        assert tbp.n_hub_chunks > tbp.n_hub > 0     # hubs span chunks
    assert tb.W_MAX == jb.W_MAX
    # the numpy round trip keeps every field
    assert_same_schedule(jbp, tb.from_arrays(tb.to_arrays(tbp)))
    d = jb.to_arrays(jbp)
    for k, v in tb.to_arrays(tbp).items():
        np.testing.assert_array_equal(v, d[k], err_msg=k)


def test_op_identity_matches_jax():
    for op in tb.OPS:
        for dt in (np.float32, np.int32, np.uint8, np.int16):
            assert tb.op_identity(op, dt) == jb.op_identity(op, dt)
            assert tb.op_identity(op, torch.from_numpy(
                np.zeros(1, dt)).dtype) == jb.op_identity(op, dt)


def test_table_helpers_match_jax(schedules):
    jbp, tbp = schedules
    rng = np.random.default_rng(1)
    x = rng.random((jbp.n_nodes + 40, 3)).astype(np.float32)
    xb = tbp.to_binned(T(x))
    np.testing.assert_array_equal(xb.numpy(),
                                  np.asarray(jbp.to_binned(jnp.asarray(x))))
    table = tbp.make_table(xb, np.float32(-1))
    want = jbp.make_table(jbp.to_binned(jnp.asarray(x)), -1.0)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))
    noisy = table + 5
    np.testing.assert_array_equal(
        tbp.pin_identity(noisy, -1.0).numpy(),
        np.asarray(jbp.pin_identity(jnp.asarray(noisy.numpy()), -1.0)))
    np.testing.assert_array_equal(tbp.from_binned(xb).numpy(), x[:1200])
    assert tbp.ident_row == jbp.ident_row
    np.testing.assert_array_equal(tbp.node_rows_mask().numpy(),
                                  np.asarray(jbp.node_rows_mask()))


def _table(rng, n_rows, B, dtype):
    if dtype == np.float32:
        return rng.random((n_rows, B)).astype(np.float32)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, (n_rows, B)).astype(np.int32)
    info = np.iinfo(dtype)
    return rng.integers(0, int(info.max) + 1, (n_rows, B), dtype=dtype)


def _port(x):
    """A JAX-side numpy table as the port's tensor (same bits)."""
    x = np.array(x)          # writable
    if x.dtype.type in (np.uint16, np.uint32):
        return T(x).view(PLANES[x.dtype.type])
    return T(x)


def _back(t, like):
    """The port's result as JAX's dtype (same bits)."""
    return t.numpy().view(like.dtype)


def _bor_table(rng, bp, dtype):
    """A sparse bit plane with pad rows zero (as the engine keeps them)."""
    x = _table(rng, bp.n_rows, 6, dtype)
    x &= _table(rng, bp.n_rows, 6, dtype)
    x &= _table(rng, bp.n_rows, 6, dtype)
    x[bp.n_nodes:] = 0
    return x


CASES = [("sum", np.float32), ("sum", np.int32), ("min", np.float32),
         ("min", np.int32), ("max", np.float32), ("max", np.int32),
         ("or", np.float32), ("bor", np.uint8), ("bor", np.uint16),
         ("bor", np.uint32)]


@pytest.mark.parametrize("op,dtype", CASES)
def test_edge_map_matches_jax(schedules, op, dtype):
    jbp, tbp = schedules
    rng = np.random.default_rng(CASES.index((op, dtype)))
    if op == "bor":
        x = _bor_table(rng, jbp, dtype)
    elif op == "or":
        x = (rng.random((jbp.n_rows, 5)) < 0.1).astype(np.float32)
        x[jbp.n_nodes:] = 0
    else:
        x = jbp.pin_identity(jnp.asarray(_table(rng, jbp.n_rows, 5, dtype)),
                             jb.op_identity(op, dtype))
        x = np.asarray(x)
    want = np.asarray(jb.edge_map(jbp, jnp.asarray(x), op))
    got = tb.edge_map(tbp, _port(x), op)
    assert got.shape == want.shape
    if op == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(_back(got, want), want)
    # slot-chunked: the same result (bit for bit, but for float sums,
    # where a hub's chunk partials add in another order)
    chunked = tb.edge_map(tbp, _port(x), op, slot_chunk=40)
    if op == "sum" and dtype == np.float32:
        np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=1e-6)
    else:
        np.testing.assert_array_equal(chunked.numpy(), got.numpy())


def test_edge_map_slot_vals_match_jax(graphs):
    """Edge-weighted maps: min-plus relaxation and a weighted sum, with
    per-slot values laid out from a CSC edge property."""
    jg, tg = graphs
    jbp = jb.binned_in(jg, w_max=16)
    tbp = tb.binned_in(tg, w_max=16)
    rng = np.random.default_rng(2)
    w = rng.integers(1, 20, jg.e_pad).astype(np.int32)
    jsv = jb.edge_slot_vals(jbp, jnp.asarray(w), 0)
    tsv = tb.edge_slot_vals(tbp, T(w), 0)
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    big = jb.op_identity("min", np.int32) // 2
    x = rng.integers(0, 100, (jbp.n_rows, 4)).astype(np.int32)
    x[jbp.n_nodes:] = big
    want = np.asarray(jb.edge_map(jbp, jnp.asarray(x), "min", slot_vals=jsv))
    got = tb.edge_map(tbp, T(x), "min", slot_vals=tsv)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tb.edge_map(tbp, T(x), "min", slot_vals=tsv, slot_chunk=33).numpy(),
        want)
    xf = rng.random((jbp.n_rows, 4)).astype(np.float32)
    xf[jbp.n_nodes:] = 0
    wf = rng.random((tsv.shape[0], 4)).astype(np.float32)   # [S_tot, B]
    want = np.asarray(jb.edge_map(jbp, jnp.asarray(xf), "sum",
                                  slot_vals=jnp.asarray(wf),
                                  combine=lambda a, b: a * b))
    got = tb.edge_map(tbp, T(xf), "sum", slot_vals=T(wf),
                      combine=lambda a, b: a * b, slot_chunk=50)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_lite_schedule_refuses_edge_values(schedules):
    _, tbp = schedules
    lite = tbp.to("cpu", with_edges=False)
    assert lite.slot_edge.numel() == 0
    assert torch.equal(lite.slot_src, tbp.slot_src)
    with pytest.raises(ValueError, match="lite"):
        tb.edge_slot_vals(lite, torch.zeros(tbp.e_pad, dtype=torch.int32), 0)
    full = tbp.to("cpu")
    assert torch.equal(full.slot_edge, tbp.slot_edge)


def test_edge_map_checks_arguments(schedules):
    _, tbp = schedules
    x = torch.zeros((tbp.n_rows, 2))
    with pytest.raises(ValueError):
        tb.edge_map(tbp, x, "mul")
    with pytest.raises(ValueError):
        tb.edge_map(tbp, x[:-1], "sum")
    with pytest.raises(TypeError):
        tb.edge_map(tbp, x, "bor")
    assert tb.slot_chunk_for(512) == (4 << 30) // 512
