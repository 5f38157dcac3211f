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


OP_DTYPE = [(op, dt) for dt in (torch.int32, torch.float32)
            for op in ("add", "min", "max")]


def _edge_layouts(tile):
    """name -> (lens, lead, trail): segment lengths that stress a kernel
    whose blocks own tiles of ``tile`` consecutive slots; ``lead`` slots
    before ``offsets[0]`` and ``trail`` slots after the last segment."""
    rng = np.random.default_rng(21)
    short = lambda k: rng.choice([0, 1, 1, 2, 5, 40], size=k)
    return {
        "one segment over every slot": ([5 * tile + 3], 0, 0),
        "segments that end on tile edges": (
            [tile, tile, 2 * tile, 1, tile - 1, 3, tile - 3, 3 * tile], 0, 0),
        "runs of empty segments at slot 0, at a tile edge and at the end": (
            np.concatenate([np.zeros(3000, int), [tile], np.zeros(2500, int),
                            short(400), [2 * tile + 7],
                            np.zeros(1700, int)]), 0, 0),
        "offsets[0] > 0 and slots after the last segment": (
            np.concatenate([[tile + 9], short(900), [3 * tile]]),
            tile + 37, 2 * tile + 5),
        "more rows in a tile than one load of offsets holds": (
            np.concatenate([rng.choice([0, 1, 2], size=9000), [7],
                            np.zeros(4000, int), short(50)]), 3, 0),
        "long rows among short ones": (
            np.concatenate([np.concatenate([short(30), [int(k)]])
                            for k in rng.integers(257, 3 * tile, 40)]), 0, 11),
        "every segment empty": (np.zeros(700, int), 5, 2 * tile),
        "a hub over many tiles between short rows": (
            np.concatenate([short(2000), [70 * tile + 13], short(2000)]),
            0, 0),
    }


LAYOUTS = list(_edge_layouts(4096))          # the names only


def _layout_case(name, tile, dtype, seed):
    rng = np.random.default_rng(seed)
    lens, lead, trail = _edge_layouts(tile)[name]
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    off += lead
    n = int(off[-1]) + trail
    if dtype == torch.int32:
        vals = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)
    else:
        vals = rng.random(n).astype(np.float32)
    return vals, off.astype(np.int32)


def _assert_same(got, want64, op, dtype):
    """int32 and min/max bit for bit; float32 add within rtol 1e-5 of the
    plain version in float64 (the values are >= 0: no cancellation)."""
    if dtype == torch.float32 and op == "add":
        torch.testing.assert_close(got.double(), want64, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got, want64.to(got.dtype))


def _want(fn, vals, *args):
    """The plain version, float32 sums in float64."""
    if vals.dtype == torch.float32 and args[-1] == "add":
        return fn(vals.double(), *args)
    return fn(vals, *args).double() if vals.dtype == torch.float32 \
        else fn(vals, *args)


@pytest.mark.parametrize("op,dtype", OP_DTYPE)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_segment_reduce_tile_edge_layouts(dev, layout, op, dtype):
    from green_marl_tpu_torch.ops import _build
    tile = _build.lib().gm_segment_reduce_tile_size()
    vals_np, off_np = _layout_case(layout, tile, dtype, seed=31)
    vals = torch.from_numpy(vals_np).to(dev)
    offsets = torch.from_numpy(off_np).to(dev)
    n_out = offsets.numel() - 1 + 130            # rows past N: the identity
    got = K.segment_reduce_sorted(vals, vals, offsets, n_out, op)
    torch.cuda.synchronize()
    assert got.shape == (n_out,) and got.dtype == dtype
    _assert_same(got, _want(K.segment_reduce_sorted_ref, vals, vals, offsets,
                            n_out, op), op, dtype)
    for _ in range(3):                           # the same bits every launch
        assert torch.equal(K.segment_reduce_sorted(vals, vals, offsets,
                                                   n_out, op), got)


def _ids_of(off_np, n):
    """Sorted ids of the slots of a layout: -1 before ``offsets[0]`` (the
    scan's initial carry id), the row inside, one more id after."""
    lens = np.diff(off_np.astype(np.int64))
    ids = np.concatenate([
        np.full(off_np[0], -1, np.int32),
        np.repeat(np.arange(lens.size, dtype=np.int32), lens),
        np.full(n - int(off_np[-1]), lens.size, np.int32)])
    return ids


@pytest.mark.parametrize("op,dtype", OP_DTYPE)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_segmented_scan_tile_edge_layouts(dev, layout, op, dtype):
    from green_marl_tpu_torch.ops import _build
    tile = _build.lib().gm_segmented_scan_tile_size()
    vals_np, off_np = _layout_case(layout, tile, dtype, seed=32)
    vals = torch.from_numpy(vals_np).to(dev)
    ids = torch.from_numpy(_ids_of(off_np, vals_np.size)).to(dev)
    got = K.segmented_scan(vals, ids, op)
    torch.cuda.synchronize()
    assert got.shape == vals.shape and got.dtype == dtype
    _assert_same(got, _want(K.segmented_scan_ref, vals, ids, op), op, dtype)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 4095, 4096, 4097, 8191, 8192, 8193,
                               3 * 8192 + 5])
def test_segment_kernels_sizes_around_a_tile(dev, n):
    """Both kernels at lengths around their tiles, in all six op/dtype
    pairs: short random segments and one segment over all n slots."""
    rng = np.random.default_rng(n)
    cuts = np.unique(np.concatenate([[0, n], rng.integers(0, n + 1, n // 9)]))
    for off_np in (cuts.astype(np.int32), np.array([0, n], np.int32)):
        offsets = torch.from_numpy(off_np).to(dev)
        ids = torch.from_numpy(_ids_of(off_np, n)).to(dev)
        for op, dtype in OP_DTYPE:
            vals = torch.from_numpy(_vals(rng, n, dtype)).to(dev)
            n_out = offsets.numel() + 2
            assert torch.equal(
                K.segment_reduce_sorted(vals, ids, offsets, n_out, op),
                K.segment_reduce_sorted_ref(vals, ids, offsets, n_out, op))
            assert torch.equal(K.segmented_scan(vals, ids, op),
                               K.segmented_scan_ref(vals, ids, op))


def test_segment_kernels_more_tiles_than_resident(dev):
    """2^25 + 3 slots: thousands of tiles, far more than the card holds at
    once, with hubs whose carries cross hundreds of them."""
    n = (1 << 25) + 3
    rng = np.random.default_rng(41)
    lens = rng.choice([0, 1, 2, 7, 30, 200], size=400_000).astype(np.int64)
    lens[100_000] = 3_000_001
    lens[250_000] = 9_000_000
    off = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    off = off[:np.searchsorted(off, n, side="right")]
    off[-1] = n
    off_np = off.astype(np.int32)
    offsets = torch.from_numpy(off_np).to(dev)
    ids = torch.from_numpy(_ids_of(off_np, n)).to(dev)
    n_out = offsets.numel() - 1
    for op, dtype in OP_DTYPE:
        vals = torch.from_numpy(_vals(rng, n, dtype)).to(dev)
        if dtype == torch.float32 and op == "add":
            vals = (vals > 14).float()   # 0/1: every sum exact in any order
        got = K.segment_reduce_sorted(vals, ids, offsets, n_out, op)
        assert torch.equal(got, K.segment_reduce_sorted_ref(
            vals, ids, offsets, n_out, op)), (op, dtype)
        scan = K.segmented_scan(vals, ids, op)
        assert torch.equal(scan, K.segmented_scan_ref(vals, ids, op))
        tails = (offsets[1:] - 1).long()
        nonempty = offsets[1:] > offsets[:-1]
        assert torch.equal(scan[tails[nonempty]], got[nonempty])
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    whole = torch.tensor([0, n], dtype=torch.int32, device=dev)
    assert K.segment_reduce_sorted(ones, ones, whole, 1, "add").tolist() == [n]
    assert torch.equal(K.segmented_scan(ones, torch.zeros_like(ones)),
                       torch.arange(1, n + 1, dtype=torch.int32, device=dev))


def test_segment_kernels_repeated_launches_agree(dev):
    """20 launches on one input: a race on the status words would show as
    a launch that differs.  The segment reduce gives the same bits for
    float32 too; the scan's float32 add is compared within rounding."""
    rng = np.random.default_rng(42)
    lens = rng.choice([0, 1, 3, 14, 60, 20_000, 150_000], size=3000)
    off_np = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n = int(off_np[-1])
    offsets = torch.from_numpy(off_np).to(dev)
    ids = torch.from_numpy(_ids_of(off_np, n)).to(dev)
    vi = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, n)
                          .astype(np.int32)).to(dev)
    vf = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    want_i = K.segment_reduce_sorted_ref(vi, ids, offsets, 3000, "add")
    first_f = K.segment_reduce_sorted(vf, ids, offsets, 3000, "add")
    torch.testing.assert_close(
        first_f.double(), K.segment_reduce_sorted_ref(
            vf.double(), ids, offsets, 3000, "add"), rtol=1e-5, atol=0.0)
    scan_i = K.segmented_scan_ref(vi, ids, "add")
    scan_f = K.segmented_scan_ref(vf.double(), ids, "add")
    for rep in range(20):
        assert torch.equal(K.segment_reduce_sorted(vi, ids, offsets, 3000,
                                                   "add"), want_i), rep
        assert torch.equal(K.segment_reduce_sorted(vf, ids, offsets, 3000,
                                                   "add"), first_f), rep
        assert torch.equal(K.segmented_scan(vi, ids, "add"), scan_i), rep
        torch.testing.assert_close(K.segmented_scan(vf, ids, "add").double(),
                                   scan_f, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("op,dtype", OP_DTYPE)
def test_segment_kernels_unaligned_views(dev, op, dtype):
    """Views that start 4 bytes into an allocation, of a length that is no
    multiple of 4, take the kernels' 4-byte paths: the same results."""
    rng = np.random.default_rng(43)
    n = 300_003
    lens = rng.choice([0, 1, 2, 9, 40, 9000], size=20_000)
    off = np.concatenate([[0], np.cumsum(lens)])
    off_np = np.append(off[off < n], n).astype(np.int32)
    offsets = torch.from_numpy(off_np).to(dev)
    vals = torch.from_numpy(_vals(rng, n + 1, dtype)).to(dev)[1:]
    ids = torch.from_numpy(np.concatenate([[0], _ids_of(off_np, n)])
                           .astype(np.int32)).to(dev)[1:]
    assert vals.data_ptr() % 16 != 0 and ids.data_ptr() % 16 != 0
    n_out = offsets.numel() - 1
    assert torch.equal(K.segment_reduce_sorted(vals, ids, offsets, n_out, op),
                       K.segment_reduce_sorted_ref(vals, ids, offsets, n_out,
                                                   op))
    assert torch.equal(K.segmented_scan(vals, ids, op),
                       K.segmented_scan_ref(vals, ids, op))
    # one operand aligned, the other not
    assert torch.equal(K.segmented_scan(vals.clone(), ids, op),
                       K.segmented_scan_ref(vals, ids, op))


def test_segment_reduce_no_slots(dev):
    """No edge slots at all, and offsets that are all one position."""
    empty = torch.zeros(0, dtype=torch.float32, device=dev)
    off = torch.zeros(6, dtype=torch.int32, device=dev)
    assert K.segment_reduce_sorted(empty, empty, off, 8, "min").tolist() \
        == [float("inf")] * 8
    x = torch.arange(10, dtype=torch.int32, device=dev)
    assert K.segment_reduce_sorted(x, x, off + 10, 5, "add").tolist() == [0] * 5
    assert K.segmented_scan(empty, empty.int()).numel() == 0


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


SLAB_TAKE = [(mode, th, window, split)
             for mode in ("axis0", "composed")
             for th in (8, 256, 1024, 4096, 16384)
             for window in (False, True)
             for split in (False, True)]


@pytest.mark.parametrize("mode,th,window,split", SLAB_TAKE)
def test_take_along_slab_and_l2_routes(dev, mode, th, window, split):
    """axis0 (column slabs, or L2 where no slab fits) and composed (whole
    block or L2) on window and blocked layouts, with R of one grid step and
    of many, and indices below 0 and above th (clipped)."""
    rng = np.random.default_rng(th + 2 * window + split)
    bh = min(th, 256) if window else th
    for steps in (1, 8):
        R = steps * bh
        table = torch.from_numpy(rng.random(
            (th if window else steps * th, 128)).astype(np.float32)).to(dev)
        lo, hi = (-999, th * 128 + 999) if split else (-3, th + 5)
        idx = torch.from_numpy(rng.integers(lo, hi, (R, 128))
                               .astype(np.int32)).to(dev)
        got = K.take_along_blocks(table, idx, mode, bh, th, window, split)
        want = K.take_along_blocks_ref(table, idx, mode, bh, th, window,
                                       split)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (steps, K.take_along_route(th, mode))


@pytest.mark.parametrize("slab_bytes", [1 << 12, 1 << 14, 1 << 16, 1 << 17])
@pytest.mark.parametrize("th", [8, 64, 256, 1024, 4096])
def test_take_along_every_slab_width(dev, th, slab_bytes, monkeypatch):
    """Every slab width from ``SLAB_MIN_COLS`` columns to the whole block,
    the L2 route where fewer would fit, and R that the persistent blocks of
    a window do not divide evenly."""
    monkeypatch.setattr(K, "SLAB_BYTES", slab_bytes)
    cols = K.take_along_slab_cols(th)
    fit = min(128, slab_bytes // (th * 4))      # a power of two, as both are
    assert cols == (fit if fit >= K.SLAB_MIN_COLS else 0)
    assert K.take_along_route(th) == ("slab" if cols else "L2")
    rng = np.random.default_rng(th + slab_bytes)
    for window, bh, R in ((False, th, 3 * th), (True, 8, 8 * 1237)):
        table = torch.from_numpy(rng.random(
            (th if window else R, 128)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(-2, th + 2, (R, 128))
                               .astype(np.int32)).to(dev)
        got = K.take_along_blocks(table, idx, "axis0", bh, th, window)
        want = K.take_along_blocks_ref(table, idx, "axis0", bh, th, window)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (cols, window)


def _row_ids(rng, pattern, n_rows):
    """int32 ids that stress the binned row gather."""
    if pattern == "all equal":
        return np.full(70_001, n_rows // 2)
    if pattern == "sorted":
        return np.sort(rng.integers(0, n_rows, 70_001))
    if pattern == "one bin":               # one region of the table only
        return rng.integers(n_rows // 2, n_rows // 2 + 7, 70_001)
    if pattern == "out of range":          # clipped on both sides
        return rng.integers(-n_rows, 2 * n_rows, 70_001)
    if pattern == "fewer ids than bins":
        return rng.integers(0, n_rows, K.ROW_GATHER_BINS // 3)
    if pattern == "one id":
        return rng.integers(0, n_rows, 1)
    return rng.integers(0, n_rows, 300_007)          # duplicate-heavy


ROW_PATTERNS = ["all equal", "sorted", "one bin", "out of range",
                "fewer ids than bins", "one id", "random"]


@pytest.mark.parametrize("pattern", ROW_PATTERNS)
@pytest.mark.parametrize("roww", [4, 8, 32, 128])
def test_row_gather_binned_patterns(dev, roww, pattern):
    """Rows of 16 to 512 bytes from a table whose row count is no power of
    two, every k, sweeps 1 and 3."""
    rng = np.random.default_rng(roww + len(pattern))
    n_rows = 100_003
    table = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (n_rows, roww))
                             .astype(np.int32)).to(dev)
    idx = torch.from_numpy(_row_ids(rng, pattern, n_rows)
                           .astype(np.int32)).to(dev)
    for sweeps in (1, 3):
        want = int(K.row_gather_checksum_ref(table, idx, sweeps))
        for k in K.ROW_GATHER_K:
            got = K.row_gather_checksum(table, idx, sweeps, k)
            assert int(got) == want, (sweeps, k)


@pytest.mark.parametrize("roww", [12, 20, 36, 68, 124])
def test_row_gather_odd_row_widths(dev, roww):
    """Rows of 3, 5, 9, 17 and 31 16-byte pieces: a warp's step holds 8, 4,
    2, 1 and 1 of them, with lanes left over."""
    rng = np.random.default_rng(roww)
    table = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (5003, roww))
                             .astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(-9, 5012, 40_001)
                           .astype(np.int32)).to(dev)
    want = int(K.row_gather_checksum_ref(table, idx, 2))
    for k in K.ROW_GATHER_K:
        assert int(K.row_gather_checksum(table, idx, 2, k)) == want, k


@pytest.mark.parametrize("n_rows", [1, 5, 255, 256, 257, 70_000])
def test_row_gather_small_tables(dev, n_rows):
    """Tables with fewer rows than bins, and around the bin count."""
    rng = np.random.default_rng(n_rows)
    table = torch.from_numpy(rng.integers(0, 1 << 30, (n_rows, 32))
                             .astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(-5, n_rows + 5, 50_000)
                           .astype(np.int32)).to(dev)
    want = int(K.row_gather_checksum_ref(table, idx, 2))
    assert int(K.row_gather_checksum(table, idx, 2, 8)) == want


def test_row_gather_repeated_launches_agree(dev):
    """20 launches back to back: each starts from a zeroed histogram and
    sum, whatever the one before left in the allocator's block."""
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.integers(0, 1 << 30, (1 << 18, 128))
                             .astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 1 << 18, 1 << 19)
                           .astype(np.int32)).to(dev)
    want = int(K.row_gather_checksum_ref(table, idx))
    got = [K.row_gather_checksum(table, idx, 1, 8) for _ in range(20)]
    assert [int(g) for g in got] == [want] * 20


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


# -- triangle counting and the analytics models: the card equals the CPU -----

def _rmat_graph(n, m, seed, undirected=False):
    from green_marl_tpu_torch.graph import csr, generate
    src, dst = generate.rmat_edges(n, m, seed=seed)
    if undirected:
        src, dst = csr.to_undirected(src, dst)
        keep = src != dst
        src, dst = src[keep], dst[keep]
    return csr.from_edges(src, dst, n)[0]


def test_triangle_paths_on_the_card(dev, monkeypatch):
    from green_marl_tpu_torch.models import triangle as T
    g = _rmat_graph(3000, 40_000, 51, undirected=True)
    want = T.triangle_count(g)                      # CPU, bitmap route
    assert want == T.count_search(T.build_dag(g)) > 0
    gd = g.to(dev)
    ctx = T.build_dag(gd)
    assert ctx.dag_dst.is_cuda and ctx.pair_cum.dtype == torch.int64
    assert T.triangle_count(gd) == want             # bitmap route
    assert T.count_search(ctx) == want
    assert T.count_search(ctx, chunk=5000) == want
    assert T.count_sortmerge(ctx) == want
    monkeypatch.setattr(T, "_SM_DISPATCH_W", 1 << 15)
    T._PREP_CACHE.clear()
    assert T.count_sortmerge(ctx, chunk=1 << 10) == want
    assert T.triangle_count_literal(gd) == want
    monkeypatch.setattr(T, "_BITMAP_MAX_N", 1)
    T._PREP_CACHE.clear()
    assert T.triangle_count_literal(gd, chunk=70_000) == want
    T._PREP_CACHE.clear()


def test_triangle_literal_directed_on_the_card(dev, monkeypatch):
    from green_marl_tpu_torch.models import analytics as A
    from green_marl_tpu_torch.models import triangle as T
    g = _rmat_graph(2000, 30_000, 52)
    want = T.triangle_count_literal(g)
    gd = g.to(dev)
    assert T.triangle_count_literal(gd) == want > 0
    monkeypatch.setattr(T, "_BITMAP_MAX_N", 1)
    T._PREP_CACHE.clear()
    assert T.triangle_count_literal(gd) == want
    assert A.triangle_directed_count(gd) == A.triangle_directed_count(g) > 0
    T._PREP_CACHE.clear()


def test_weak_cc_and_communities_on_the_card(dev):
    from green_marl_tpu_torch.models import cc, communities
    g = _rmat_graph(20_000, 60_000, 53)
    gd = g.to(dev)
    K.reset_launch_counts()
    want, got = cc.weak_cc(g), cc.weak_cc(gd)
    assert got.iterations == want.iterations > 1
    assert torch.equal(got.comp.cpu(), want.comp)
    # two min reductions a superstep, each one launch of the kernel
    assert K.launch_counts()["segment_reduce_sorted"] == 2 * got.iterations
    K.reset_launch_counts()
    want, got = communities.communities(g), communities.communities(gd)
    assert got.iterations == want.iterations > 1
    assert torch.equal(got.comm.cpu(), want.comm)
    assert K.launch_counts()["segment_reduce_sorted"] == 2 * got.iterations


def test_communities_int64_route_on_the_card(dev, monkeypatch):
    from green_marl_tpu_torch.models import communities
    g = _rmat_graph(5000, 30_000, 54)
    want = communities.communities(g)
    monkeypatch.setattr(communities, "_ENC_LIMIT", 1)
    K.reset_launch_counts()
    got = communities.communities(g.to(dev))
    assert got.iterations == want.iterations
    assert torch.equal(got.comm.cpu(), want.comm)
    # int64 best-count reduction: plain version; int32 own-count: kernel
    assert K.launch_counts()["segment_reduce_sorted"] == got.iterations


def test_small_models_on_the_card(dev):
    from green_marl_tpu_torch.models import analytics as A
    from green_marl_tpu_torch.models import conductance, v_cover
    from green_marl_tpu_torch.utils.gm_rand import conduct_membership
    g = _rmat_graph(1000, 4000, 55)
    gd = g.to(dev)
    want, got = v_cover.v_cover(g), v_cover.v_cover(gd)
    assert got.iterations == want.iterations > 10
    assert int(got.count) == int(want.count)
    assert torch.equal(got.select.cpu(), want.select)
    member = torch.zeros(g.n_pad, dtype=torch.int32)
    member[: g.num_nodes] = torch.from_numpy(conduct_membership(g.num_nodes))
    for num in range(4):
        assert float(conductance.conductance(gd, member.to(dev), num)) == \
            float(conductance.conductance(g, member, num)) > 0
    age = torch.from_numpy(np.random.default_rng(56).integers(
        0, 60, g.n_pad).astype(np.int32))
    K.reset_launch_counts()
    avg_d, cnt_d = A.avg_teen_cnt(gd, age.to(dev), 30)
    assert K.launch_counts()["plain_cumsum"] == 1
    avg_c, cnt_c = A.avg_teen_cnt(g, age, 30)
    assert torch.equal(cnt_d.cpu(), cnt_c)
    assert float(avg_d) == pytest.approx(float(avg_c), rel=1e-6)
    assert torch.equal(A.potential_friends(gd).cpu(), A.potential_friends(g))
    np.testing.assert_allclose(A.adamic_adar_edges(gd),
                               A.adamic_adar_edges(g), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.int16,
                                   torch.uint8, torch.bool])
def test_segment_ops_route_by_dtype_on_the_card(dev, dtype):
    """Types the kernels lack take the plain versions on the card too."""
    from green_marl_tpu_torch.ops import segment
    g = _rmat_graph(5000, 40_000, 57)
    gd = g.to(dev)
    rng = np.random.default_rng(58)
    if dtype == torch.bool:
        vals = torch.from_numpy(rng.random(g.n_pad) < 0.3)
    elif dtype.is_floating_point:
        vals = torch.from_numpy(rng.random(g.n_pad))
    else:
        vals = torch.from_numpy(rng.integers(0, 100, g.n_pad)).to(dtype)
    K.reset_launch_counts()
    for f in (segment.in_nbr_sum, segment.in_nbr_max, segment.out_nbr_min):
        if dtype == torch.bool and f is segment.in_nbr_sum:
            continue
        got, want = f(gd, vals.to(dev)), f(g, vals)
        assert got.dtype == dtype and got.is_cuda
        if dtype.is_floating_point:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=0)
        else:
            assert torch.equal(got.cpu(), want)
    assert sum(K.launch_counts().values()) == 0


def test_float64_pagerank_on_the_card(dev):
    from green_marl_tpu_torch.models.pagerank import pagerank
    g = _rmat_graph(5000, 40_000, 59)
    want = pagerank(g, dtype=torch.float64)
    got = pagerank(g.to(dev), dtype=torch.float64)
    assert got.iterations == want.iterations
    torch.testing.assert_close(got.rank.cpu(), want.rank, rtol=1e-9, atol=0)


def test_segment_or_and_has_edge_to_on_the_card(dev):
    from green_marl_tpu_torch.ops import segment
    g = _rmat_graph(5000, 40_000, 60)
    gd = g.to(dev)
    rng = np.random.default_rng(61)
    src = torch.from_numpy(rng.integers(0, 5000, 100_000).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 5000, 100_000).astype(np.int32))
    src[:30_000] = g.node_idx_src[:30_000]
    dst[:30_000] = g.node_idx[:30_000]
    want = segment.has_edge_to(g, src, dst)
    assert torch.equal(segment.has_edge_to(gd, src.to(dev),
                                           dst.to(dev)).cpu(), want)
    assert want[:30_000].all() and not want.all()
    words = torch.from_numpy(rng.integers(0, 1 << 30, (g.e_pad, 2))
                             .astype(np.int32))
    ids = g.node_idx_src
    assert torch.equal(
        segment.sorted_segment_or(words.to(dev), ids.to(dev), g.n_pad).cpu(),
        segment.sorted_segment_or(words, ids, g.n_pad))


# -- the component and path models: the card equals the CPU ------------------

def _weights(g, seed, lo=0, hi=100):
    w = torch.zeros(g.e_pad, dtype=torch.int32)
    w[: g.num_edges] = torch.from_numpy(np.random.default_rng(seed).integers(
        lo, hi, g.num_edges).astype(np.int32))
    return w


def test_reverse_bfs_and_scc_on_the_card(dev):
    from green_marl_tpu_torch.models import bfs, scc
    g = _rmat_graph(20_000, 120_000, 80)
    gd = g.to(dev)
    deg = g.in_degree()
    for root in (int(deg.argmax()), 0, 17):
        for direction in ("auto", "pull", "push"):
            want = bfs.bfs(g, root, reverse=True, direction=direction)
            got = bfs.bfs(gd, root, reverse=True, direction=direction)
            assert torch.equal(got.level.cpu(), want.level)
            assert (got.levels_run, got.reached) == (want.levels_run,
                                                     want.reached)
    want = scc.scc(g)
    K.reset_launch_counts()
    got = scc.scc(gd)
    assert got.rounds == want.rounds >= 1
    assert torch.equal(got.comp.cpu(), want.comp)
    launched = K.launch_counts()
    assert launched["segment_reduce_sorted"] > 2 * got.rounds
    assert launched["plain_cumsum"] == 0
    np.testing.assert_array_equal(
        got.comp[: g.num_nodes].cpu().numpy(),
        scc.scc_np(g.begin.numpy(), g.node_idx[: g.num_edges].numpy()))


def test_sssp_path_and_delta_stepping_on_the_card(dev):
    from green_marl_tpu_torch.models import delta_stepping, sssp, sssp_path
    g = _rmat_graph(20_000, 120_000, 81)
    gd = g.to(dev)
    w = _weights(g, 81)
    wd = w.to(dev)
    for root in (int(g.out_degree().argmax()), 0):
        want = sssp_path.sssp_path(g, root, w)
        K.reset_launch_counts()
        got = sssp_path.sssp_path(gd, root, wd)
        # three min reductions a superstep, each one launch of the kernel
        assert K.launch_counts()["segment_reduce_sorted"] == \
            3 * got.iterations
        assert got.iterations == want.iterations
        for f in ("dist", "prev", "prev_edge"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
        assert torch.equal(got.dist, sssp.sssp(gd, root, wd).dist)
        for delta in (1, 8, 64):
            want = delta_stepping.delta_stepping(g, root, w, delta=delta)
            got = delta_stepping.delta_stepping(gd, root, wd, delta=delta)
            assert torch.equal(got.dist.cpu(), want.dist)
            assert (got.buckets_processed, got.inner_steps) == (
                want.buckets_processed, want.inner_steps)
        found, par, pare, dist = sssp.dijkstra_host_exact(gd, wd, root, 5)
        want = sssp.dijkstra_host_exact(g, w, root, 5)
        assert (found, dist) == (want[0], want[3])
        assert np.array_equal(par, want[1]) and np.array_equal(pare, want[2])


def test_bc_on_the_card(dev):
    from green_marl_tpu_torch.models import bc
    g = _rmat_graph(20_000, 120_000, 82)
    gd = g.to(dev)
    seeds = [int(s) for s in g.out_degree().argsort(descending=True)[:3]]
    want = bc.bc(g, seeds + [0])
    K.reset_launch_counts()
    got = bc.bc(gd, seeds + [0])
    assert K.launch_counts()["segment_reduce_sorted"] > 0
    assert float(want.bc.sum()) > 0
    torch.testing.assert_close(got.bc.cpu(), want.bc, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("app", ["kosaraju", "tarjan_scc", "bc", "bc_random",
                                 "sssp_path", "sssp_dijkstra",
                                 "bidir_dijkstra"])
def test_path_apps_on_the_card(dev, app, capsys):
    """The CLI on the card prints what it prints on the CPU (BC values
    within rtol 1e-5)."""
    import os
    from green_marl_tpu_torch.cli import apps
    fixture = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "data", "parity", "parity10k.bin")
    out = {}
    for device in ("cpu", "cuda"):
        assert apps.main([app, f"-GMDevice={device}", fixture]) == 0
        out[device] = [ln for ln in capsys.readouterr().out.splitlines()
                       if "time=" not in ln]
    if app.startswith("bc"):
        vals = {d: [float(ln.split(" = ")[1]) for ln in lines
                    if ln.startswith("BC[")] for d, lines in out.items()}
        np.testing.assert_allclose(vals["cuda"], vals["cpu"], rtol=1e-5)
    else:
        assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_threefry_on_the_card(dev, seed):
    """The card draws the CPU's bits (and so JAX's)."""
    from green_marl_tpu_torch.runtime import rng
    key = rng.PRNGKey(seed)
    keys = rng.split(key, 5)
    assert torch.equal(rng.split(key.to(dev), 5).cpu(), keys)
    for shape in ((), (1,), (100_003,), (17, 33)):
        assert torch.equal(rng.random_bits(keys.to(dev), shape).cpu(),
                           rng.random_bits(keys, shape))
        got = rng.uniform(key.to(dev), shape).cpu()
        assert torch.equal(got.view(torch.int32),
                           rng.uniform(key, shape).view(torch.int32))
        for span in (1, 3, 12345, 2 ** 31 - 1):
            assert torch.equal(rng.randint(key.to(dev), shape, 0, span).cpu(),
                               rng.randint(key, shape, 0, span))


def test_sampling_on_the_card(dev):
    """Node samplings, both walks and the matching on the card equal the
    CPU's bit for bit (degree sums stay below 2^24: exact in any order)."""
    from green_marl_tpu_torch.models import sampling as S
    from green_marl_tpu_torch.runtime import rng
    g = _rmat_graph(20_000, 120_000, 83)
    gd = g.to(dev)
    key = rng.PRNGKey(3)
    for fn in (S.random_node_sampling, S.random_degree_node_sampling):
        assert torch.equal(fn(gd, key, 500).cpu(), fn(g, key, 500))
    assert torch.equal(S.random_walk_with_jump(gd, key, 5000).cpu(),
                       S.random_walk_with_jump(g, key, 5000))
    starts = torch.arange(0, 20_000, 97, dtype=torch.int32)
    want = S.parallel_random_walks(g, key, starts, 30)
    got = S.parallel_random_walks(gd, key, starts.to(dev), 30)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    left = torch.zeros(g.n_pad, dtype=torch.bool)
    left[:20_000] = g.out_degree()[:20_000] > 2
    want = S.random_bipartite_matching(g, left)
    K.reset_launch_counts()
    got = S.random_bipartite_matching(gd, left.to(dev))
    assert (K.launch_counts()["segment_reduce_sorted"]
            == 2 * got.iterations > 0)
    assert torch.equal(got.match.cpu(), want.match)
    assert (got.count, got.iterations) == (want.count, want.iterations)
    assert got.count > 0
