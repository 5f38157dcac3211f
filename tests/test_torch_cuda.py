"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor ``green_marl_tpu``, so it also runs where JAX is not
installed; there, skip ``tests/conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from green_marl_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _segments(rng, n_seg, hub=0):
    """[n_seg + 1] int32 offsets: many empty and length-1 segments, a few
    long ones, and optionally one hub segment of ``hub`` slots."""
    lens = rng.choice([0, 1, 1, 2, 5, 40], size=n_seg)
    if hub:
        lens[n_seg // 3] = hub
    off = np.zeros(n_seg + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off.astype(np.int32)


def _vals(rng, e, dtype):
    if dtype == torch.int32:
        return rng.integers(-(1 << 30), 1 << 30, e).astype(np.int32)
    # integer-valued floats: sums of the hub stay exact in any order
    return rng.integers(0, 16, e).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segment_reduce_matches_ref(dev, op, dtype):
    rng = np.random.default_rng(7)
    off = _segments(rng, 50_000, hub=1 << 20)
    e_pad = int(off[-1]) + 77                  # not a multiple of 128
    vals = torch.from_numpy(_vals(rng, e_pad, dtype)).to(dev)
    ids = torch.zeros(e_pad, dtype=torch.int32, device=dev)
    offsets = torch.from_numpy(off).to(dev)
    n_out = 50_000 + 200                       # rows past N get the identity
    got = K.segment_reduce_sorted(vals, ids, offsets, n_out, op)
    want = K.segment_reduce_sorted_ref(vals, ids, offsets, n_out, op)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n_out,)
    assert torch.equal(got, want)


def test_segment_reduce_float_rounding(dev):
    rng = np.random.default_rng(8)
    off = _segments(rng, 20_000)
    vals = torch.from_numpy(
        rng.random(int(off[-1])).astype(np.float32)).to(dev)
    offsets = torch.from_numpy(off).to(dev)
    got = K.segment_reduce_sorted(vals, vals, offsets, 20_000, "add")
    want = K.segment_reduce_sorted_ref(vals.double(), vals, offsets,
                                       20_000, "add")
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


def test_cumsum_int32_wraps(dev):
    rng = np.random.default_rng(9)
    for n in (1, 4095, 4096, 4097, 3 * 4096 + 5, 5_000_003):
        v = rng.integers(0, 1 << 30, n).astype(np.int32)
        want = np.cumsum(v.astype(np.int64)).astype(np.int32)  # mod 2^32
        got = K.plain_cumsum(torch.from_numpy(v).to(dev)).cpu().numpy()
        np.testing.assert_array_equal(got, want)


TILE = 8192                # csrc/cumsum.cu's kTile
LOOKBACK_SIZES = [0, 1] + [k * TILE + d for k in (1, 2, 3) for d in (-1, 0, 1)]


def _wrapped_cumsum(v, exclusive):
    """numpy's int32 prefix sum, mod 2^32."""
    want = np.cumsum(v.astype(np.int64))
    if exclusive:
        want = np.concatenate([[0], want])
    return want.astype(np.int32)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n", LOOKBACK_SIZES)
def test_cumsum_lookback_tile_edges(dev, n, exclusive):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 1 << 30, n).astype(np.int32)
    got = K.plain_cumsum(torch.from_numpy(v).to(dev), exclusive)
    assert got.shape == (n + exclusive,)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _wrapped_cumsum(v, exclusive))


def test_cumsum_more_tiles_than_resident(dev):
    """2^25 + 3 elements: 4,097 tiles, far more than the card holds at
    once, so tiles wait on predecessors that started long before."""
    n = (1 << 25) + 3
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    want = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    assert torch.equal(K.plain_cumsum(ones), want)
    ex = K.plain_cumsum(ones, exclusive=True)
    assert int(ex[0]) == 0 and torch.equal(ex[1:], want)
    rng = np.random.default_rng(13)
    v = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                         .astype(np.int32)).to(dev)
    assert torch.equal(K.plain_cumsum(v), K.plain_cumsum_ref(v))


def test_cumsum_repeated_launches_agree(dev):
    """20 launches on one input: a race on the status words would show as
    a launch that differs from the plain version."""
    rng = np.random.default_rng(14)
    v = torch.from_numpy(rng.integers(0, 1 << 30, 3_000_017)
                         .astype(np.int32)).to(dev)
    want = K.plain_cumsum_ref(v)
    want_ex = K.plain_cumsum_ref(v, exclusive=True)
    for rep in range(20):
        assert torch.equal(K.plain_cumsum(v, rep % 2 == 1),
                           want_ex if rep % 2 else want), rep


@pytest.mark.parametrize("exclusive", [False, True])
def test_cumsum_unaligned_view(dev, exclusive):
    """A view that starts 4 bytes into an allocation takes the 4-byte path
    and gives the same result."""
    rng = np.random.default_rng(15)
    base = torch.from_numpy(rng.integers(0, 1 << 30, 1_000_003)
                            .astype(np.int32)).to(dev)
    view = base[1:]
    assert view.data_ptr() % 16 != 0
    assert torch.equal(K.plain_cumsum(view, exclusive),
                       K.plain_cumsum_ref(view, exclusive))
    f = torch.from_numpy(rng.standard_normal(base.numel())
                         .astype(np.float32)).to(dev)[1:]
    got = K.plain_cumsum(f, exclusive).double()
    want = K.plain_cumsum_ref(f.double(), exclusive)
    bound = 1e-6 * K.plain_cumsum_ref(f.double().abs(), exclusive)
    assert bool(((got - want).abs() <= bound).all())


def test_cumsum_exclusive_float32(dev):
    rng = np.random.default_rng(16)
    v = torch.from_numpy(rng.standard_normal(5_000_003)
                         .astype(np.float32)).to(dev)
    got = K.plain_cumsum(v, exclusive=True).double()
    want = K.plain_cumsum_ref(v.double(), exclusive=True)
    bound = 1e-6 * K.plain_cumsum_ref(v.double().abs(), exclusive=True)
    assert got.shape == (v.numel() + 1,) and float(got[0]) == 0.0
    assert bool(((got - want).abs() <= bound + 1e-6).all())


def test_cumsum_float32(dev):
    rng = np.random.default_rng(10)
    v = rng.standard_normal(5_000_003).astype(np.float32)
    got = K.plain_cumsum(torch.from_numpy(v).to(dev)).cpu().numpy()
    exact = np.cumsum(v.astype(np.float64))
    bound = 1e-6 * np.cumsum(np.abs(v).astype(np.float64))
    assert (np.abs(got - exact) <= bound + 1e-6).all()


def test_launch_counts_and_checks(dev):
    K.reset_launch_counts()
    x = torch.ones(1000, dtype=torch.int32, device=dev)
    K.plain_cumsum(x)
    K.segment_reduce_sorted(x, x, torch.tensor([0, 500, 1000],
                                               dtype=torch.int32,
                                               device=dev), 2, "add")
    assert K.launch_counts() == {"segment_reduce_sorted": 1,
                                 "plain_cumsum": 1, "segmented_scan": 0,
                                 "take_along_blocks": 0,
                                 "row_gather_checksum": 0}
    with pytest.raises(TypeError):
        K.plain_cumsum(x.long())
    with pytest.raises(ValueError):
        K.plain_cumsum(x[::2])
    assert K.launch_counts()["plain_cumsum"] == 1


def _scan_case(rng, n, dtype):
    lens = rng.choice([1, 1, 2, 3, 40, 900, 5000, 70_000], size=n)
    lens = lens[:np.searchsorted(np.cumsum(lens), n) + 1]   # >= n slots
    ids = np.repeat(np.arange(lens.size, dtype=np.int32), lens)[:n]
    if dtype == torch.int32:
        vals = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    else:                       # integer-valued: sums exact in any order
        vals = rng.integers(-8, 9, n).astype(np.float32)
    return vals, ids


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segmented_scan_matches_ref(dev, op, dtype):
    rng = np.random.default_rng(11)
    for n in (1, 4095, 4096, 4097, 3 * 4096 + 5, 1024 * 4096 + 77,
              3_000_001):
        vals, ids = _scan_case(rng, n, dtype)
        v = torch.from_numpy(vals).to(dev)
        i = torch.from_numpy(ids).to(dev)
        got = K.segmented_scan(v, i, op)
        want = K.segmented_scan_ref(v, i, op)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (n,)
        assert torch.equal(got, want), (op, dtype, n)


def test_segmented_scan_float_rounding(dev):
    rng = np.random.default_rng(12)
    vals, ids = _scan_case(rng, 2_000_003, torch.int32)
    v = torch.from_numpy(rng.standard_normal(ids.size).astype(np.float32))
    i = torch.from_numpy(ids)
    exact = K.segmented_scan_ref(v.double(), i, "add")
    bound = 1e-5 * K.segmented_scan_ref(v.double().abs(), i, "add") + 1e-6
    got = K.segmented_scan(v.to(dev), i.to(dev), "add").cpu().double()
    assert bool(((got - exact).abs() <= bound).all())


TAKE = [("axis0", 8, 8, False, False), ("axis0", 256, 256, False, False),
        ("axis0", 1024, 1024, False, False), ("axis1", 64, 64, False, False),
        ("row", 1024, 1024, False, False), ("row", 256, 1024, False, True),
        ("row", 64, 4096, True, False), ("row", 64, 64, False, False),
        ("axis0", 256, 4096, True, True), ("axis1", 256, 4096, True, True),
        ("composed", 256, 4096, True, True),
        ("composed", 16, 64, True, True)]


@pytest.mark.parametrize("mode,bh,th,window,split", TAKE)
def test_take_along_blocks_matches_ref(dev, mode, bh, th, window, split):
    rng = np.random.default_rng(bh + th)
    R = 8 * max(bh, 128)
    table = torch.from_numpy(rng.random(
        (th if window else R // bh * th, 128)).astype(np.float32)).to(dev)
    hi = th * 128 + 999 if split else (128 if mode == "axis1" else th + 5)
    idx = torch.from_numpy(rng.integers(-3, hi, (R, 128))
                           .astype(np.int32)).to(dev)
    got = K.take_along_blocks(table, idx, mode, bh, th, window, split)
    want = K.take_along_blocks_ref(table, idx, mode, bh, th, window, split)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("roww", [8, 32, 128])
def test_row_gather_matches_ref(dev, roww):
    rng = np.random.default_rng(roww)
    table = torch.from_numpy(rng.integers(0, 1 << 30, (100_003, roww))
                             .astype(np.int32)).to(dev)
    for n_ids, sweeps in ((1, 1), (1000, 3), (262_147, 2)):
        idx = torch.from_numpy(rng.integers(0, 100_003, n_ids)
                               .astype(np.int32)).to(dev)
        want = K.row_gather_checksum_ref(table, idx, sweeps)
        for k in K.ROW_GATHER_K:
            got = K.row_gather_checksum(table, idx, sweeps, k)
            assert int(got) == int(want), (roww, n_ids, sweeps, k)


def test_cumsum_empty_launches_nothing(dev):
    K.reset_launch_counts()
    x = torch.ones(0, dtype=torch.int32, device=dev)
    assert K.plain_cumsum(x).numel() == 0
    assert K.plain_cumsum(x, exclusive=True).tolist() == [0]
    assert K.launch_counts()["plain_cumsum"] == 0
    K.plain_cumsum(torch.ones(5, dtype=torch.int32, device=dev),
                   exclusive=True)
    assert K.launch_counts()["plain_cumsum"] == 1


def test_new_kernels_count_and_check(dev):
    K.reset_launch_counts()
    x = torch.ones(5000, dtype=torch.int32, device=dev)
    K.segmented_scan(x, x)
    t = torch.zeros((64, 128), device=dev)
    i = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    K.take_along_blocks(t, i, "axis0", 8)
    K.row_gather_checksum(i, i[0], 2)
    counts = K.launch_counts()
    assert (counts["segmented_scan"], counts["take_along_blocks"],
            counts["row_gather_checksum"]) == (1, 1, 1)
    with pytest.raises(TypeError):
        K.segmented_scan(x.float(), x.float())
    with pytest.raises(ValueError):
        K.segmented_scan(x[::2], x[::2])
    with pytest.raises(ValueError):
        K.take_along_blocks(t, i[:60], "axis0", 8)
    with pytest.raises(TypeError):
        K.take_along_blocks(t.half(), i, "axis0", 8)
    with pytest.raises(ValueError):
        K.row_gather_checksum(i[:, :2].contiguous(), i[0])
    with pytest.raises(ValueError):
        K.row_gather_checksum(i, i[0], k=5)
    with pytest.raises(ValueError):
        K.row_gather_checksum(i, i[:, 0])           # strided ids
    assert (counts["segmented_scan"], counts["take_along_blocks"],
            counts["row_gather_checksum"]) == (1, 1, 1)
    assert K.launch_counts() == counts
