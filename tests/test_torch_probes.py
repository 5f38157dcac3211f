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
    assert K.take_along_staged(256) and not K.take_along_staged(1024)


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
