"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor ``green_marl_tpu``, so it also runs where JAX is not
installed; there, skip ``tests/conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from green_marl_tpu_torch.ops import kernels as K
from green_marl_tpu_torch.utils.timing import kernel_ms

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
                                 "segment_reduce_sorted[gather]": 0,
                                 "plain_cumsum": 1, "segmented_scan": 0,
                                 "take_along_blocks": 0,
                                 "row_gather_checksum": 0,
                                 "edge_map_bor": 0,
                                 "edge_map_bor_level": 0, "bit_popstats": 0,
                                 "triangle_search": 0}
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


@pytest.mark.parametrize("dtype,op", [(torch.float32, "add"),
                                      (torch.int32, "min"),
                                      (torch.int32, "max")])
def test_segment_reduce_runs_of_empty_rows(dev, dtype, op):
    """1.2M empty rows at slot 0 and 1.1M at the end, a body of short rows
    and one hub between (the shape of a shard's clipped offsets): float add
    within rtol 1e-5 of float64, int32 min and max exactly, the same bits on
    a second launch, and the kernel no slower than its plain version
    (median of 10 launches each)."""
    rng = np.random.default_rng(11)
    body = rng.choice([0, 1, 1, 2, 3, 8, 30], size=600_000)
    body[300_000] = 1 << 20
    lens = np.concatenate([np.zeros(1_200_000, np.int64), body,
                           np.zeros(1_100_003, np.int64)])
    off = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    e = int(off[-1])
    offsets = torch.from_numpy(off.astype(np.int32)).to(dev)
    n_out = lens.size + 300
    if dtype == torch.float32:
        vals = torch.from_numpy(rng.random(e).astype(np.float32)).to(dev)
    else:
        vals = torch.from_numpy(_vals(rng, e, dtype)).to(dev)
    got = K.segment_reduce_sorted(vals, vals, offsets, n_out, op)
    again = K.segment_reduce_sorted(vals, vals, offsets, n_out, op)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        want = K.segment_reduce_sorted_ref(vals.double(), vals, offsets,
                                           n_out, op)
        assert torch.allclose(got.double(), want, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(got, K.segment_reduce_sorted_ref(
            vals, vals, offsets, n_out, op))
    ms = kernel_ms(lambda: K.segment_reduce_sorted(vals, vals, offsets,
                                                   n_out, op), 1, 10)[0]
    plain = kernel_ms(lambda: K.segment_reduce_sorted_ref(
        vals, vals, offsets, n_out, op), 1, 10)[0]
    assert ms <= plain, (ms, plain)


def test_kernels_launch_on_an_edge8_bin_graph(dev, tmp_path):
    """A graph read from a BIN file with 8-byte ``edge_t`` holds int32
    arrays on the card: pagerank launches the segment reduce and a pull BFS
    the prefix sum, with the results of the same graph stored with 4-byte
    ``edge_t``."""
    from green_marl_tpu_torch.graph import binary_io
    from green_marl_tpu_torch.models.bfs import bfs
    from green_marl_tpu_torch.models.pagerank import pagerank
    g4 = _card_graph(torch.device("cpu"))
    path = str(tmp_path / "edge8.bin")
    binary_io.store_binary(path, g4.begin.numpy(),
                           g4.node_idx.numpy()[:g4.num_edges], edge_bytes=8)
    raw = binary_io.load_binary(path)
    assert raw.begin.dtype == np.int64
    g8 = raw.freeze()[0].to(dev)
    assert g8.edge_dtype == torch.int32
    root = int(np.argmax(np.diff(g4.begin.numpy())))
    K.reset_launch_counts()
    pr = pagerank(g8)
    lv = bfs(g8, root, direction="pull")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["segment_reduce_sorted"] >= pr.iterations > 0
    assert counts["plain_cumsum"] > 0
    g4 = g4.to(dev)
    assert torch.equal(pr.rank, pagerank(g4).rank)
    assert torch.equal(lv.level, bfs(g4, root, direction="pull").level)


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


def test_triangle_dag_built_on_the_card(dev):
    """``build_dag`` of a card graph builds on the card, equal bit for bit
    to the host build; the router takes the search there, with its
    counter and no device read of its own."""
    from green_marl_tpu_torch.models import triangle as T
    g = _rmat_graph(1 << 17, 1_500_000, 52, undirected=True)
    E = g.num_edges
    want = T.dag_to_device(T.build_dag_host(
        g.begin.numpy(), g.node_idx[:E].numpy(), g.num_nodes), dev)
    gd = g.to(dev)
    got = T.build_dag(gd)
    for name in ("dag_begin", "dag_dst", "pair_cum"):
        w, t = getattr(want, name), getattr(got, name)
        assert t.is_cuda and t.dtype == w.dtype and torch.equal(t, w), name
    assert (got.num_wedges, got.num_dag_edges) == \
        (want.num_wedges, want.num_dag_edges)
    assert T.route(got) == "search"
    T.reset_search_counts()
    assert T.triangle_count(gd) == T.count_sortmerge(got) > 0
    counts = T.search_counts()
    assert (counts["calls"], counts["wedges"]) == (1, got.num_wedges)
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


# -- triangle counting's wedge search (csrc/triangle.cu) ---------------------

SEARCH_CASES = ["rmat61", "rmat62", "rmat63", "empty_ends", "hub"]
SEARCH_TILE = 1 << 12     # wedge ids a warp claims: kTile of csrc/triangle.cu


def search_edges(case):
    """``(src, dst, n)``: an edge list whose undirected simple graph is the
    case.  ``rmat<seed>``: an RMAT of 3,000 nodes; ``empty_ends``: an RMAT
    on ids 100-2,899 of 3,000, so that the rows of ids below 100 and from
    2,900 are empty; ``hub``: an RMAT on ids 1-6,000 and node 0 next to
    every other node, a row of 6,000 slots whose first slot anchors 5,999
    wedges (more than a tile of the kernel)."""
    from green_marl_tpu_torch.graph import generate
    if case.startswith("rmat"):
        src, dst = generate.rmat_edges(3000, 40_000, seed=int(case[4:]))
        return src, dst, 3000
    if case == "empty_ends":
        src, dst = generate.rmat_edges(2800, 30_000, seed=65)
        return src + 100, dst + 100, 3000
    assert case == "hub", case
    src, dst = generate.rmat_edges(6000, 40_000, seed=66)
    others = np.arange(1, 6001, dtype=src.dtype)
    return (np.concatenate([src + 1, np.zeros_like(others)]),
            np.concatenate([dst + 1, others]), 6001)


def search_dag(src, dst, n, device):
    """The DAG of the simple undirected graph of ``src -- dst`` oriented
    from the lower id to the higher (rank = id, where ``build_dag`` orders
    by degree: any order counts each triangle once), as a ``DagContext`` on
    ``device``."""
    from green_marl_tpu_torch.graph.csr import round_up
    from green_marl_tpu_torch.models import triangle as T
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    codes = np.unique(lo[lo != hi] * n + hi[lo != hi])
    rows, dd = codes // n, codes % n
    D = codes.shape[0]
    begin = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=begin[1:])
    d_pad = round_up(max(D, 1))
    dag_dst = np.full(d_pad, n, np.int64)
    dag_dst[:D] = dd
    pair_cum = np.zeros(d_pad + 1, np.int64)
    np.cumsum(begin[rows + 1] - np.arange(1, D + 1), out=pair_cum[1:D + 1])
    pair_cum[D + 1:] = pair_cum[D]
    return T.dag_to_device((begin, dag_dst, pair_cum, D), device)


def _search(ctx, fn=K.triangle_search):
    return int(fn(ctx.dag_begin, ctx.dag_dst, ctx.pair_cum, ctx.num_wedges))


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_triangle_search_kernel_matches_ref(dev, case):
    """The kernel's count equals the plain version's on the CPU and on the
    card and the join's, one launch a call, over the DAG oriented by id and
    (RMAT cases) the degree-ordered one; wedge ids past the DAG's total
    count nothing (the kernel ends); the cases' shapes hold."""
    from green_marl_tpu_torch.models import triangle as T
    src, dst, n = search_edges(case)
    host = search_dag(src, dst, n, "cpu")
    ctx = search_dag(src, dst, n, dev)
    want = _search(host, K.triangle_search_ref)
    assert want == _search(ctx, K.triangle_search_ref) == \
        T.count_sortmerge(ctx) > 0
    K.reset_launch_counts()
    got = K.triangle_search(ctx.dag_begin, ctx.dag_dst, ctx.pair_cum,
                            ctx.num_wedges)
    assert got.is_cuda and got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    assert K.launch_counts()["triangle_search"] == 1
    total = int(ctx.pair_cum[-1])
    assert total == ctx.num_wedges
    for past in (total + 1, total + 3 * SEARCH_TILE + 5):
        assert int(K.triangle_search(ctx.dag_begin, ctx.dag_dst,
                                     ctx.pair_cum, past)) == want
        assert int(K.triangle_search_ref(ctx.dag_begin, ctx.dag_dst,
                                         ctx.pair_cum, past)) == want
    assert K.launch_counts()["triangle_search"] == 3
    rows = host.dag_begin.diff()
    assert host.num_wedges % SEARCH_TILE != 0
    if case == "hub":
        assert int(rows[0]) == 6000 > SEARCH_TILE
        assert int(host.pair_cum[1]) == 5999 > SEARCH_TILE
    if case == "empty_ends":
        assert int(rows[:100].abs().sum()) == int(rows[-100:].abs().sum()) \
            == 0
    if case.startswith("rmat"):
        csr_src, csr_dst = np.concatenate([src, dst]), \
            np.concatenate([dst, src])
        keep = csr_src != csr_dst
        from green_marl_tpu_torch.graph import csr
        g = csr.from_edges(csr_src[keep], csr_dst[keep], n)[0]
        by_degree = T.build_dag(g.to(dev))
        assert _search(by_degree) == \
            _search(by_degree, K.triangle_search_ref) == want
        assert K.launch_counts()["triangle_search"] == 4
    T._PREP_CACHE.clear()


def test_triangle_search_complete_graph(dev):
    """K_2400 through ``build_dag`` on the card: rows of up to 2,399 slots
    and C(2400, 3) = 2,301,120,800 wedges, all triangles: wedge ids and
    the count past 2^31."""
    from green_marl_tpu_torch.models import triangle as T
    n = 2400
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    node_idx = ids.repeat(n).view(n, n)[~torch.eye(n, dtype=torch.bool,
                                                   device=dev)]
    begin = torch.arange(n + 1, dtype=torch.int32, device=dev) * (n - 1)
    ctx = T.build_dag_torch(begin, node_idx, n)
    want = n * (n - 1) * (n - 2) // 6
    assert want == 2_301_120_800 > 2**31
    assert ctx.num_wedges == want
    assert int(ctx.dag_begin.diff().max()) == n - 1
    K.reset_launch_counts()
    assert _search(ctx) == want
    assert K.launch_counts()["triangle_search"] == 1


def test_triangle_search_route_counts_and_refusals(dev):
    """``count_search`` on the card: one launch, the counter's fields
    (``steps`` 0); what the rule refuses raises and launches nothing."""
    from green_marl_tpu_torch.models import triangle as T
    ctx = search_dag(*search_edges("rmat61"), dev)
    want = _search(ctx, K.triangle_search_ref)
    K.reset_launch_counts()
    T.reset_search_counts()
    assert T.count_search(ctx) == T.count_search(ctx, chunk=5000) == want
    assert T.search_counts() == {"calls": 2, "chunks": 2,
                                 "wedges": 2 * ctx.num_wedges, "steps": 0}
    assert K.launch_counts()["triangle_search"] == 2
    strided = torch.stack([ctx.dag_dst, ctx.dag_dst], 1)[:, 0]
    assert not strided.is_contiguous()
    bad = [(ctx.dag_begin, ctx.dag_dst.long(), ctx.pair_cum),
           (ctx.dag_begin, strided, ctx.pair_cum),
           (ctx.dag_begin.long(), ctx.dag_dst, ctx.pair_cum),
           (ctx.dag_begin, ctx.dag_dst, ctx.pair_cum.int()),
           (ctx.dag_begin, ctx.dag_dst, ctx.pair_cum[1:]),
           (ctx.dag_begin, ctx.dag_dst, ctx.pair_cum.cpu())]
    for args in bad:
        with pytest.raises(ValueError):
            K.triangle_search(*args, ctx.num_wedges)
    assert K.launch_counts()["triangle_search"] == 2
    assert int(K.triangle_search(ctx.dag_begin, ctx.dag_dst, ctx.pair_cum,
                                 0)) == 0
    assert K.launch_counts()["triangle_search"] == 2


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


INT32_MAX = torch.iinfo(torch.int32).max
GATHER_CASES = [(dtype, weighted, mask, False, False, 0)
                for dtype in (torch.int32, torch.float32)
                for weighted in (True, False)
                for mask in ("all", "none", "one", "random")] + [
    (torch.int32, True, "random", True, False, 0),
    (torch.int32, False, "all", True, False, 0),
    (torch.int32, True, "random", False, True, 0),
    (torch.float32, True, "random", False, True, 0),
    (torch.int32, True, "random", False, False, 1 << 21),
    (torch.int32, True, "sparse", False, False, 1 << 21),
    (torch.float32, False, "sparse", False, False, 5_000_001),
    (torch.int32, False, "one", False, True, 5_000_001)]


@functools.lru_cache(maxsize=1)
def _gather_graph():
    """An RMAT graph with one more hub of 20,000 in-edges, over five of the
    kernel's 4,096-slot tiles."""
    from green_marl_tpu_torch.graph import csr, generate
    n = 60_000
    src, dst = generate.rmat_edges(n, 1_500_000, seed=83)
    rng = np.random.default_rng(83)
    src = np.concatenate([src, rng.integers(0, n, 20_000).astype(src.dtype)])
    dst = np.concatenate([dst, np.full(20_000, 5, dst.dtype)])
    return csr.from_edges(src, dst, n)[0]


@pytest.mark.parametrize("dtype,weighted,mask,wrap,unaligned,tables",
                         GATHER_CASES)
def test_segment_reduce_gather_form_matches_ref(dev, dtype, weighted, mask,
                                                wrap, unaligned, tables):
    """The gather form on a seeded RMAT graph's CSC, bit for bit its plain
    version: hubs over many 4,096-slot tiles, empty rows, pad slots holding
    the sentinel, rows n..n_out-1; sources all, none, one, a third or one
    in a thousand set; ``wrap``: int32 values within 100 of INT32_MAX, so
    that the add wraps; ``unaligned``: ids and weights not 16-byte aligned
    (the wrapper copies them to aligned memory first); ``tables``: node tables of that many rows (0: n_pad),
    past 327,680 so that a bit of the kernel's summary of the flags stands
    for 8 or 16 nodes (the ids stay below n_pad)."""
    g = _gather_graph()
    rng = np.random.default_rng(84)
    n_pad, e_pad = tables or g.n_pad, g.e_pad
    if dtype == torch.int32:
        vals = (INT32_MAX - rng.integers(0, 100, n_pad) if wrap
                else rng.integers(0, 1 << 20, n_pad)).astype(np.int32)
        add = rng.integers(1, 101, e_pad).astype(np.int32)
    else:
        vals = (100 * rng.random(n_pad)).astype(np.float32)
        vals[::7] = np.inf
        add = rng.random(e_pad).astype(np.float32)
    node_mask = {"all": np.ones(n_pad, bool), "none": np.zeros(n_pad, bool),
                 "one": np.arange(n_pad) == int(g.r_node_idx[e_pad // 3]),
                 "random": rng.random(n_pad) < 0.3,
                 "sparse": rng.random(n_pad) < 0.001}[mask]
    args = (g.r_node_idx, g.r_node_idx_dst, g.r_begin, g.n_pad + 256, "min")
    tables = dict(node_vals=torch.from_numpy(vals),
                  node_mask=torch.from_numpy(node_mask),
                  add=torch.from_numpy(add) if weighted else None)
    want = K.segment_reduce_sorted_ref(*args, **tables)

    def card(t):
        if not unaligned:
            return t.to(dev)
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.to(dev)
        return buf[1:]
    d_args = [card(t) for t in args[:3]] + list(args[3:])
    d_tables = {k: None if t is None else card(t) for k, t in tables.items()}
    K.reset_launch_counts()
    got = K.segment_reduce_sorted(*d_args, **d_tables)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got.cpu(), want)
    assert K.launch_counts()["segment_reduce_sorted[gather]"] == 1
    assert K.launch_counts()["segment_reduce_sorted"] == 1
    if wrap:
        assert (want < 0).any()
    assert (want[:g.num_nodes] < K.identity("min", dtype)).any() == \
        (mask != "none")


def test_relax_models_on_the_card(dev):
    """hop_dist, sssp and min_relax(dist_dtype=float32) on the card equal
    their CPU results, each superstep one launch of the segment reduce's
    gather form; pagerank and bfs launch none."""
    from green_marl_tpu_torch.models import bfs, hop_dist, pagerank, relax
    from green_marl_tpu_torch.models import sssp
    g = _rmat_graph(20_000, 200_000, 85)
    gd = g.to(dev)
    w = _weights(g, 85, lo=1)
    wd = w.to(dev)
    by_degree = g.out_degree().argsort(descending=True)
    for root in (int(by_degree[0]), int(by_degree[1000])):
        for run in (lambda g, w: hop_dist.hop_dist(g, root),
                    lambda g, w: sssp.sssp(g, root, w),
                    lambda g, w: relax.min_relax(
                        g, root, w, dist_dtype=torch.float32),
                    lambda g, w: relax.min_relax(
                        g, root, dist_dtype=torch.float32)):
            want = run(g, w)
            K.reset_launch_counts()
            got = run(gd, wd)
            counts = K.launch_counts()
            assert got.iterations == want.iterations > 1
            assert torch.equal(got.dist.cpu(), want.dist)
            assert counts["segment_reduce_sorted[gather]"] == \
                counts["segment_reduce_sorted"] == got.iterations
    K.reset_launch_counts()
    pr = pagerank.pagerank(gd)
    lv = bfs.bfs(gd, int(g.out_degree().argmax()))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["segment_reduce_sorted"] >= pr.iterations > 0
    assert int(lv.level.max()) > 0
    assert counts["segment_reduce_sorted[gather]"] == 0


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


# ---------------------------------------------------------------------------
# Compiled .gm programs on the card (lang.lower) against device="cpu"
# ---------------------------------------------------------------------------

_PAGERANK_GM = """
Procedure pagerank(G: Graph, e,d: Double, max: Int;
                   pg_rank: Node_Prop<Double>)
{
    Double diff;
    Int cnt = 0;
    Double N = G.NumNodes();
    G.pg_rank = 1 / N;
    Do {
        diff = 0.0;
        Foreach (t: G.Nodes) {
            Double val = (1-d) / N + d*
                Sum(w: t.InNbrs) { w.pg_rank / w.OutDegree() };
            diff += | val - t.pg_rank |;
            t.pg_rank <= val @ t;
        }
        cnt++;
    } While ((diff > e) && (cnt < max));
}
"""

_HOP_DIST_GM = """
Procedure hop_dist(G:Graph, dist:N_P<Int>, root: Node)
{
    N_P<Bool> updated;
    N_P<Bool> updated_nxt;
    N_P<Int>  dist_nxt;
    Bool fin = False;
    G.dist = (G == root) ? 0 : +INF;
    G.updated = (G == root) ? True: False;
    G.dist_nxt = G.dist;
    G.updated_nxt = G.updated;
    While(!fin) {
        fin = True;
        Foreach(n: G.Nodes)(n.updated) {
            Foreach(s: n.Nbrs) {
                <s.dist_nxt; s.updated_nxt> min= <n.dist + 1; True>;
            }
        }
        G.dist = G.dist_nxt;
        G.updated = G.updated_nxt;
        G.updated_nxt = False;
        fin = ! Exist(n: G.Nodes){n.updated};
    }
}
"""

_PULL_GM = """
Procedure pull(G: Graph, A: N_P<Int>; B: N_P<Int>, C: N_P<Int>,
               D: N_P<Int>) {
    G.D = +INF;
    Foreach(t: G.Nodes) {
        t.B = Min(w: t.InNbrs) { w.A };
        t.C = Sum(w: t.InNbrs) { w.A };
        Foreach(w: t.InNbrs) { t.D min= w.A + 1; }
    }
}
"""


def _compiled_pair(text, dev, **kw):
    """(card outputs, cpu outputs, launch counts of the card run)."""
    import warnings

    from green_marl_tpu_torch.graph import generate as gen
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.lang.lower import compile_source
    src, dst = gen.rmat_edges(20_000, 200_000, seed=3)
    g, _ = from_edges(src, dst, 20_000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cp = compile_source(text)
    want = cp(g, **kw)
    cp(g.to(dev), **kw)                      # builds the kernels
    K.reset_launch_counts()
    got = cp(g.to(dev), **kw)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    return ({k: v.cpu() for k, v in got.items()}, want, counts)


def test_compiled_pagerank_on_card(dev):
    got, want, counts = _compiled_pair(_PAGERANK_GM, dev, e=1e-7, d=0.85,
                                       max=100)
    torch.testing.assert_close(got["pg_rank"], want["pg_rank"], rtol=1e-4,
                               atol=1e-9)
    assert counts["segment_reduce_sorted"] > 0


def test_compiled_hop_dist_on_card(dev):
    got, want, counts = _compiled_pair(_HOP_DIST_GM, dev, root=0)
    assert torch.equal(got["dist"], want["dist"])
    assert counts == {k: 0 for k in counts}   # a push program: scatters


def test_compiled_int_pull_on_card(dev):
    a = torch.from_numpy((np.arange(20_096) * 7919 % 100_003)
                         .astype(np.int32))
    got, want, counts = _compiled_pair(_PULL_GM, dev, A=a)
    for k in ("B", "C", "D"):
        assert torch.equal(got[k], want[k]), k
    assert counts["segment_reduce_sorted"] > 0      # Min(...), min= ... @ t
    assert counts["plain_cumsum"] > 0               # integer Sum(...)


# ---------------------------------------------------------------------------
# Lane-batched kernels and batched compiled programs (CompiledProc.batch)
# ---------------------------------------------------------------------------

def _lane_case(rng, b, n_seg, dtype, tail=0):
    """[b, e] values, [n_seg + 1] offsets with runs of empty rows (at slot
    0, in the middle over whole 512-row chunks, at the end) and one hub; e
    odd, ``tail`` slots past the last row."""
    lens = rng.choice([0, 1, 1, 2, 5, 40], size=n_seg)
    lens[:3000] = 0
    lens[n_seg // 2:n_seg // 2 + 5000] = 0
    lens[-2000:] = 0
    lens[n_seg // 3] = 300_000
    off = np.zeros(n_seg + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    e = int(off[-1]) + tail
    e += 1 - e % 2
    vals = np.stack([_vals(rng, e, dtype) for _ in range(b)])
    if dtype == torch.float32:
        vals += rng.random(vals.shape).astype(np.float32)
    return vals, off.astype(np.int32)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("dtype,op", [(torch.int32, "add"),
                                      (torch.int32, "min"),
                                      (torch.int32, "max"),
                                      (torch.float32, "add"),
                                      (torch.float32, "max")])
def test_segment_reduce_lanes(dev, b, dtype, op):
    """[B, E] lanes in one launch: int32 add, min and max equal the plain
    version exactly; every lane has the bits of the 1-D kernel on its row;
    also with offsets clipped to a slab (rows that start at slot > 0)."""
    rng = np.random.default_rng(b)
    vals_h, off = _lane_case(rng, b, 60_000, dtype, tail=77)
    vals = torch.from_numpy(vals_h).to(dev)
    ids = torch.zeros(vals.shape[1], dtype=torch.int32, device=dev)
    for offsets, n_out in ((torch.from_numpy(off).to(dev), 60_300),
                           (torch.from_numpy(off[20_000:45_001]).to(dev),
                            25_100)):
        K.reset_launch_counts()
        got = K.segment_reduce_sorted(vals, ids, offsets, n_out, op)
        torch.cuda.synchronize()
        assert got.shape == (b, n_out) and got.dtype == dtype
        assert K.lane_launch_counts()["segment_reduce_sorted[lanes]"] == 1
        assert K.launch_counts()["segment_reduce_sorted"] == 0
        if dtype == torch.int32 or op != "add":
            assert torch.equal(got, K.segment_reduce_sorted_ref(
                vals, ids, offsets, n_out, op))
        for r in range(b):
            assert torch.equal(got[r], K.segment_reduce_sorted(
                vals[r].contiguous(), ids, offsets, n_out, op)), r


def _lane_layout(rng, b, dtype, layout):
    """[b, e] values on the host and [n_seg + 1] offsets for a layout of
    the lane kernel's tests: ``aligned`` (e % 4 == 0: the bulk copies),
    ``odd_length`` (e % 4 != 0: 4-byte loads), ``unaligned_view`` (the
    aligned case shifted by one slot in memory, see the caller),
    ``few_tiles`` (fewer tiles than the card holds blocks: lane groups)."""
    if layout == "few_tiles":
        lens = rng.choice([0, 1, 3, 17], size=3000)
        lens[1000:1700] = 0                      # 700 empty rows
        off = np.zeros(lens.size + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        e = int(off[-1]) + 5
        vals = np.stack([_vals(rng, e, dtype) for _ in range(b)])
        if dtype == torch.float32:
            vals += rng.random(vals.shape).astype(np.float32)
        return vals, off.astype(np.int32)
    vals, off = _lane_case(rng, b, 60_000, dtype, tail=77)
    if layout == "odd_length":
        return vals, off
    return vals[:, :vals.shape[1] // 4 * 4], off


@pytest.mark.parametrize("layout", ["aligned", "odd_length",
                                    "unaligned_view", "few_tiles"])
@pytest.mark.parametrize("b", [2, 3, 16, 17])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segment_reduce_lane_kernel(dev, op, dtype, b, layout):
    """The lane kernel against its plain version and against the 1-D kernel
    on each row: runs of more than 512 empty rows, a hub row over 73 tiles,
    a share of the rows, offsets clipped to a slab.  int32 and min/max equal the plain version
    bit for bit; float32 add gives each lane the 1-D kernel's bits and is
    within rtol 1e-5 of a float64 sum (values of one sign)."""
    rng = np.random.default_rng(1000 * b + len(layout))
    vals_h, off = _lane_layout(rng, b, dtype, layout)
    if layout == "unaligned_view":
        buf = torch.empty((b, vals_h.shape[1] + 1), dtype=dtype, device=dev)
        vals = buf.view(-1)[1:1 + vals_h.size].view(vals_h.shape)
        vals.copy_(torch.from_numpy(vals_h))
        assert vals.data_ptr() % 16 != 0 and vals.is_contiguous()
    else:
        vals = torch.from_numpy(vals_h).to(dev)
    e = vals.shape[1]
    ids = torch.zeros(e, dtype=torch.int32, device=dev)
    n_seg = off.size - 1
    # all rows; a share of them (rows that start past slot 0); all rows
    # clipped to a slab as a shard's are (runs of empty rows at both ends)
    clipped = np.clip(off - e // 4, 0, e // 2).astype(np.int32)
    for offsets, n_out in ((off, n_seg + 300),
                           (off[n_seg // 3:2 * n_seg // 3 + 1], n_seg),
                           (clipped, n_seg)):
        offsets = torch.from_numpy(np.ascontiguousarray(offsets)).to(dev)
        K.reset_launch_counts()
        got = K.segment_reduce_sorted(vals, ids, offsets, n_out, op)
        torch.cuda.synchronize()
        assert got.shape == (b, n_out) and got.dtype == dtype
        assert K.lane_launch_counts()["segment_reduce_sorted[lanes]"] == 1
        if dtype == torch.int32 or op != "add":
            assert torch.equal(got, K.segment_reduce_sorted_ref(
                vals, ids, offsets, n_out, op))
        else:
            want = K.segment_reduce_sorted_ref(vals.double(), ids, offsets,
                                               n_out, op)
            assert torch.allclose(got.double(), want, rtol=1e-5, atol=0.0)
        for r in range(b):
            assert torch.equal(got[r], K.segment_reduce_sorted(
                vals[r].contiguous(), ids, offsets, n_out, op)), r


@pytest.mark.parametrize("b", [1, 5, 16])
@pytest.mark.parametrize("n", [1, 8191, 8192 * 3 + 5, 1_000_003])
def test_cumsum_lanes(dev, b, n):
    """[B, n] int32 lanes in one launch, inclusive and exclusive: bit for
    bit ``torch.cumsum(dim=1)`` mod 2^32 and the 1-D kernel on each row."""
    rng = np.random.default_rng(n + b)
    v = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (b, n))
                         .astype(np.int32)).to(dev)
    want = torch.cumsum(v.long(), dim=1)
    want = ((want + (1 << 31)) % (1 << 32) - (1 << 31)).int()
    K.reset_launch_counts()
    inc = K.plain_cumsum(v)
    exc = K.plain_cumsum(v, exclusive=True)
    torch.cuda.synchronize()
    assert K.lane_launch_counts()["plain_cumsum[lanes]"] == 2
    assert torch.equal(inc, want)
    assert exc.shape == (b, n + 1) and torch.equal(exc[:, 1:], want)
    assert not exc[:, 0].any()
    assert torch.equal(inc, torch.cumsum(v, dim=1, dtype=torch.int32))
    for r in range(b):
        assert torch.equal(exc[r], K.plain_cumsum(v[r].contiguous(),
                                                  exclusive=True))


_BAND_GM = """
Procedure band(G: Graph, age, cnt: N_P<Int>, lo: Int) : Int {
    Foreach(n: G.Nodes) {
        n.cnt = Count(t: n.InNbrs)(t.age >= lo && t.age < lo + 10);
    }
    Return Sum(n: G.Nodes){ n.cnt };
}
"""


@pytest.mark.parametrize("text,over,kw", [
    (_PAGERANK_GM, {"d": [0.6, 0.75, 0.85, 0.92]}, dict(e=1e-7, max=100)),
    (_HOP_DIST_GM, {"root": [0, 5, 77, 19_999]}, {}),
    (_BAND_GM, {"lo": [0, 10, 25, 60]}, {"age": "age"}),
], ids=["pagerank", "hop_dist", "band_count"])
def test_batched_program_on_card(dev, text, over, kw):
    """A batched compiled program on the card equals ``device="cpu"``
    (integers exactly, floats within rtol 1e-4 as for one instance) and
    launches the lane-batched kernels where its pulls depend on the
    lanes."""
    import warnings

    from green_marl_tpu_torch.graph import generate as gen
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.lang.lower import compile_source
    src, dst = gen.rmat_edges(20_000, 200_000, seed=3)
    g, _ = from_edges(src, dst, 20_000)
    if kw.get("age"):
        kw = {"age": torch.from_numpy(np.random.default_rng(2).integers(
            0, 80, g.n_pad).astype(np.int32))}
    over = {k: np.asarray(v, np.float32 if isinstance(v[0], float)
                          else np.int32) for k, v in over.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cp = compile_source(text)
    want = cp.batch(g, over=over, **kw)
    kw_dev = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
    cp.batch(g.to(dev), over=over, **kw_dev)       # builds the kernels
    K.reset_launch_counts()
    got = cp.batch(g.to(dev), over=over, **kw_dev)
    torch.cuda.synchronize()
    lanes = K.lane_launch_counts()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].device.type == "cuda"
        if want[k].dtype.is_floating_point:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                       atol=1e-9)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k
    if text is _PAGERANK_GM:
        assert lanes["segment_reduce_sorted[lanes]"] > 0
    elif text is _BAND_GM:
        assert lanes["plain_cumsum[lanes]"] == 1


# ---------------------------------------------------------------------------
# Multi-device execution: 4 shards on one card against one-device runs
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh4(dev, monkeypatch):
    """Four shards sharing the card (GM_TORCH_VIRTUAL_DEVICES=4)."""
    from green_marl_tpu_torch.parallel import comm
    monkeypatch.setenv(comm.VIRTUAL_ENV, "4")
    return comm.vmesh(4)


def _card_graph(dev):
    from green_marl_tpu_torch.graph import generate as gen
    from green_marl_tpu_torch.graph.csr import from_edges
    src, dst = gen.rmat_edges(20_000, 200_000, seed=3)
    g, _ = from_edges(src, dst, 20_000)
    return g.to(dev)


def test_vertex_sharded_engines_on_the_card(dev, mesh4):
    from green_marl_tpu_torch.models.hop_dist import hop_dist
    from green_marl_tpu_torch.models.pagerank import pagerank
    from green_marl_tpu_torch.models.sssp import sssp
    from green_marl_tpu_torch.parallel import comm, vertex_sharded as V
    g = _card_graph(dev)
    n = g.num_nodes
    vsg = V.place(V.build_vertex_sharded(g, 4), mesh4)
    K.reset_launch_counts()
    rank, _, it = V.pagerank_vsharded(vsg, mesh4, e=1e-7, max_iter=50)
    ref = pagerank(g, e=1e-7, max_iter=50)
    assert it == ref.iterations
    torch.testing.assert_close(rank, ref.rank[:n], rtol=1e-5, atol=1e-9)
    dist, _ = V.hop_dist_vsharded(vsg, mesh4, 7)
    assert torch.equal(dist, hop_dist(g, 7).dist[:n])
    w = torch.from_numpy(np.random.default_rng(1).integers(
        1, 50, g.e_pad).astype(np.int32)).to(dev)
    w_slab = comm.place_rows(V.shard_edge_prop(vsg, g, w), mesh4)
    sd, _ = V.sssp_vsharded(vsg, mesh4, w_slab, 7)
    assert torch.equal(sd, sssp(g, 7, w).dist[:n])
    vis, _ = V.multi_bfs_vsharded(vsg, mesh4, [7, 11, 13])
    reach = ((vis[:, 0] >> 0) & 1).bool()
    assert torch.equal(reach, dist < torch.iinfo(torch.int32).max)
    torch.cuda.synchronize()
    assert K.launch_counts()["segment_reduce_sorted"] > 0


def test_run_vertex_sharded_on_the_card(dev, mesh4):
    import warnings

    from green_marl_tpu_torch.lang import distribute as D
    from green_marl_tpu_torch.lang import lower_vertex as LV
    from green_marl_tpu_torch.lang.lower import compile_source
    g = _card_graph(dev)
    sched = LV.place_schedule(LV.build_schedule(g, 4), mesh4)
    a = torch.from_numpy((np.arange(g.n_pad) * 7919 % 100_003)
                         .astype(np.int32)).to(dev)
    for text, kw in ((_PAGERANK_GM, dict(e=1e-7, d=0.85, max=100)),
                     (_HOP_DIST_GM, dict(root=0)), (_PULL_GM, dict(A=a))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cp = compile_source(text)
        want = cp(g, **kw)
        K.reset_launch_counts()
        got = LV.run_vertex_sharded(cp, g, mesh=mesh4, sched=sched, **kw)
        rep = D.run_sharded(cp, g, mesh=mesh4, **kw)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        for k, v in want.items():
            for out in (got[k], rep[k][: v.shape[0]]):
                if v.dtype.is_floating_point:
                    torch.testing.assert_close(out, v, rtol=1e-4,
                                               atol=1e-9)
                else:
                    assert torch.equal(out, v), k
        assert counts["segment_reduce_sorted"] > 0
        if text is _PULL_GM:
            assert counts["plain_cumsum"] > 0          # integer Sum(...)


def test_nccl_one_rank_four_shards(dev, mesh4):
    """``multihost.init`` with one process and four shards on the card
    (NCCL): pagerank_vsharded and hop_dist_vsharded equal the four-thread
    run on the same card (integers bit for bit, ranks within rtol 1e-5),
    and the NCCL path ran its collectives."""
    import socket

    from green_marl_tpu_torch.parallel import comm, multihost as mh
    from green_marl_tpu_torch.parallel import vertex_sharded as V
    g = _card_graph(dev)
    vsg_h = V.build_vertex_sharded(g, 4)
    vsg = V.place(vsg_h, mesh4)
    rank_t, _, it_t = V.pagerank_vsharded(vsg, mesh4, e=1e-7, max_iter=50)
    dist_t, depth_t = V.hop_dist_vsharded(vsg, mesh4, 7)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mh.init(f"localhost:{port}", 1, 0,
            local_device_ids=[dev.index or 0] * 4)
    try:
        mesh = mh.global_mesh()
        assert mesh.dist is not None and mesh.size == 4
        vsg_d = mh.place_multihost(vsg_h, mesh)
        comm.reset_counts()
        rank, _, it = V.pagerank_vsharded(vsg_d, mesh, e=1e-7, max_iter=50)
        dist, depth = V.hop_dist_vsharded(vsg_d, mesh, 7)
        torch.cuda.synchronize()
        counts = dict(comm.COUNTS)
    finally:
        mh.shutdown()
    assert it == it_t and depth == depth_t
    torch.testing.assert_close(rank, rank_t, rtol=1e-5, atol=0.0)
    assert torch.equal(dist, dist_t)
    assert counts["all_to_all"] == it + depth and counts["psum"] > 0


# ---------------------------------------------------------------------------
# The harness and the hot-path probes (harness/, probes/) on the card
# ---------------------------------------------------------------------------

_SSSP_GM = """
Procedure sssp(G:Graph, dist:N_P<Int>, len:E_P<Int>, root: Node)
{
    N_P<Bool> updated;
    N_P<Bool> updated_nxt;
    N_P<Int>  dist_nxt;
    Bool fin = False;
    G.dist = (G == root) ? 0 : +INF;
    G.updated = (G == root) ? True: False;
    G.dist_nxt = G.dist;
    G.updated_nxt = G.updated;
    While(!fin) {
        fin = True;
        Foreach(n: G.Nodes)(n.updated) {
            Foreach(s: n.Nbrs) {
                Edge e = s.ToEdge();
                <s.dist_nxt; s.updated_nxt> min= <n.dist + e.len; True>;
            }
        }
        G.dist = G.dist_nxt;
        G.updated = G.updated_nxt;
        G.updated_nxt = False;
        fin = ! Exist(n: G.Nodes){n.updated};
    }
}
"""

_CONDUCT_GM = """
Procedure conduct(G: Graph, member: N_P<Int>, num: Int) : Float {
    Int Din, Dout, Cross;
    Din = Sum(u: G.Nodes)(u.member == num){ u.Degree() };
    Dout = Sum(u: G.Nodes)(u.member != num){ u.Degree() };
    Cross = Sum(u: G.Nodes)(u.member == num){
        Count(j: u.Nbrs)(j.member != num) };
    Float m = (Din < Dout) ? Din : Dout;
    If (m == 0) Return (Cross == 0) ? 0.0 : +INF;
    Else Return (Cross / m);
}
"""

_AVG_TEEN_CNT_GM = """
Procedure avg_teen_cnt(G: Graph, age, teen_cnt: N_P<Int>, K: Int) : Float {
    Foreach(n: G.Nodes) {
        n.teen_cnt = Count(t: n.InNbrs)(t.age >= 10 && t.age < 20);
    }
    Float avg = (Float) Avg(n: G.Nodes)(n.age > K){ n.teen_cnt };
    Return avg;
}
"""


def test_segment_reduce_base_gives_the_whole_arrays_bits(dev):
    """A slab reduced with ``base`` = its position in a longer array gets,
    for every segment, the bits of the whole array's float32 sum (the
    sharded PageRank's ranks then agree at every shard count)."""
    rng = np.random.default_rng(21)
    off = _segments(rng, 300_000, hub=1 << 18)
    vals = torch.from_numpy(rng.random(int(off[-1])).astype(np.float32)) \
        .to(dev)
    whole = K.segment_reduce_sorted(vals, vals, torch.from_numpy(off).to(dev),
                                    300_000, "add")
    from green_marl_tpu_torch.ops import _build
    tile = _build.lib().gm_segment_reduce_tile_size()
    for first in (12_345, 99_999, 150_001):
        cut = int(off[first])
        assert cut % tile                  # not on a tile edge
        sub = torch.from_numpy(off[first:] - cut).to(dev)
        got = K.segment_reduce_sorted(vals[cut:].clone(), vals[cut:], sub,
                                      300_000 - first, "add", base=cut)
        assert torch.equal(got, whole[first:])


def test_matrix_sweep_eight_shards_on_card(dev, tmp_path):
    """``harness.matrix_sweep`` with 8 shards on the card: all 12 cells
    run and agree with the one-device run; the pulls launch the segment
    reduce."""
    from green_marl_tpu_torch.harness import matrix_sweep as M
    for app, text in (("pagerank", _PAGERANK_GM), ("hop_dist", _HOP_DIST_GM),
                      ("sssp", _SSSP_GM), ("conduct", _CONDUCT_GM),
                      ("avg_teen_cnt", _AVG_TEEN_CNT_GM)):
        (tmp_path / f"{app}.gm").write_text(text)
    path = str(tmp_path / "m.bin")
    M.write_graph(path)
    rec = M.sweep(path, "cuda", str(tmp_path), log=lambda m: None)
    assert (rec["ran"], rec["passed"], rec["not_run"]) == (12, 12, 0)
    launches = {(c["app"], c["placement"]): c["launches"]
                for c in rec["cells"]}
    assert launches[("pagerank", "engine")] > 0
    assert launches[("pagerank", "distribute")] > 0
    assert rec["base"]["pagerank"]["values"]


def test_twitter_probe_fused_equals_paged_on_card(dev):
    """``probes.twitter_scale`` at its smoke size on the card: fused ==
    paged, and both == the CPU run bit for bit."""
    from green_marl_tpu_torch.probes import twitter_scale as TW
    bp, deg_rows, out_deg, _ = TW.prepare(*TW.SMOKE)
    roots = TW.top_roots(out_deg)
    card, cpu = {}, {}
    res = TW.run(bp, deg_rows, roots, dev, reps=1, keep=card)
    TW.run(bp, deg_rows, roots, torch.device("cpu"), ("fused",), reps=1,
           keep=cpu)
    assert res["equal"] and res["fused"]["peak_gb"] > 0
    assert card["fused"][0] == cpu["fused"][0]
    assert np.array_equal(card["fused"][1], cpu["fused"][1])
    assert torch.equal(card["fused"][3], cpu["fused"][3])


def test_bfs_probe_launches_the_prefix_sum(dev):
    """``probes.bfs`` on the card at a small size: the pull sweep and the
    auto BFS launch the prefix-sum kernel, and the BFS equals the CPU's."""
    from green_marl_tpu_torch.probes import bfs as PB
    g, out_deg, _ = PB.host_graph(20_000, 200_000)
    rec = PB.measure(g, out_deg, dev, log=lambda m: None)
    want = PB.measure(g, out_deg, torch.device("cpu"), log=lambda m: None)
    assert rec["pull"]["plain_cumsum_launches"] > 0
    assert rec["pull"]["ms"] is not None
    assert (rec["bfs"]["levels"], rec["bfs"]["reached"]) == (
        want["bfs"]["levels"], want["bfs"]["reached"])
    fr = PB.pull_frontier(g)
    gd = g.to(dev)
    assert torch.equal(PB.pull(gd, fr.to(dev)).cpu(), PB.pull(g, fr))


def test_multi_bfs_kind_on_the_card(dev):
    """The benchmark's ``multi_bfs`` kind at the cell's shapes (4,096
    sources, 32 to a lane: 512-byte rows) on a reduced RMAT: its answer on
    the card equals the CPU path's, and the edge-map counter's bytes equal
    ``_edge_map_bytes``' count from the schedule."""
    from gmbench import spec
    from gmbench.metrics import _edge_map_bytes
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.graph.generate import rmat_edges
    from green_marl_tpu_torch.ops import binned

    kind = spec.load_module("queries", "multi_bfs")
    args = spec.load_json("traffic", "msbfs_4096")["kinds"][0]["args"]
    src, dst = rmat_edges(1 << 16, 1 << 20, seed=3)
    g, _ = from_edges(src, dst, 1 << 16)
    on_cpu = kind.prepare(g, None, args)
    on_card = kind.prepare(g.to(dev), None, args)
    pivot = int(on_cpu["eligible"][len(on_cpu["eligible"]) // 2])
    want, want_info = kind.call(on_cpu, pivot)
    binned.reset_edge_map_counts()
    got, info = kind.call(on_card, pivot)
    counts = binned.edge_map_counts()
    assert torch.equal(got.cpu(), want) and info == want_info
    bp = on_card["schedule"].bp
    per_call = 4 * bp.slot_src.numel() + 2 * bp.n_rows * 512
    assert counts["calls"] == info["steps"] > 1
    assert _edge_map_bytes.edge_map_bytes(counts) == info["steps"] * per_call


@functools.lru_cache(maxsize=1)
def _bor_graph():
    """An RMAT of 2^15 nodes and 2^19 edges: in-degrees up to thousands,
    so that a schedule has hub chunks at ``w_max`` 512 and bins wide
    enough for a block a row."""
    return _rmat_graph(1 << 15, 1 << 19, 61)


def _bor_planes(bp, dtype, lanes, seed, dev):
    """[n_rows, lanes] planes of sparse bits (p = 1/16) on ``dev``, pad and
    identity rows 0."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (4, bp.n_nodes, lanes * dtype.itemsize),
                       dtype=np.uint8)
    rows = torch.from_numpy(raw[0] & raw[1] & raw[2] & raw[3]).view(dtype)
    return bp.make_table(rows.to(dev), 0)


@pytest.mark.parametrize("w_max", [512, 4096])
@pytest.mark.parametrize("plane_bits", [8, 16, 32])
@pytest.mark.parametrize("B", [128, 1024, 4096])
def test_edge_map_bor_kernel_matches_ref(dev, B, plane_bits, w_max):
    """The kernel equals the plain gather-and-fold path bit for bit at the
    bit BFS's row widths (B / 8 bytes: 16, 128, 512), with hub chunks, and
    gives the same bits on every launch."""
    from green_marl_tpu_torch.models.batched import PLANE_DTYPES
    from green_marl_tpu_torch.ops import binned
    bp = binned.binned_in(_bor_graph(), w_max=w_max).to(dev)
    assert (bp.n_hub_chunks > 0) == (w_max == 512)
    assert max(w for w, *_ in bp.bins) >= 256        # a block a row at 512 B
    dtype = PLANE_DTYPES[plane_bits]
    table = _bor_planes(bp, dtype, B // plane_bits, B + plane_bits, dev)
    want = K.edge_map_bor_ref(bp, table)
    K.reset_launch_counts()
    got = [K.edge_map_bor(bp, table) for _ in range(3)]
    got.append(binned.edge_map(bp, table, "bor"))
    torch.cuda.synchronize()
    assert K.launch_counts()["edge_map_bor"] == 4
    for out in got:
        assert out.dtype == dtype and torch.equal(out, want)
    assert not bool(want[bp.n_nodes:].any())
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("dtype,lanes", [
    (torch.int32, 8), (torch.int32, 12), (torch.uint8, 64),
    (torch.int16, 128), (torch.uint8, 16), (torch.int16, 192)])
def test_edge_map_bor_kernel_row_widths(dev, dtype, lanes):
    """Rows of 32, 48, 64, 256, 16 and 384 bytes: subgroups of 2, 4 (3 of
    them reading), 4, 16, 1 and 32 (24 reading) lanes a row."""
    from green_marl_tpu_torch.ops import binned
    bp = binned.binned_in(_bor_graph(), w_max=512).to(dev)
    table = _bor_planes(bp, dtype, lanes, lanes, dev)
    got = K.edge_map_bor(bp, table)
    assert torch.equal(got, K.edge_map_bor_ref(bp, table))


def test_edge_map_bor_routes(dev):
    """What the kernel cannot take (strided, 8-byte rows, int64) goes the
    plain way, with the same bits; the wrapper refuses it; a table that is
    not 16-byte aligned is copied."""
    from green_marl_tpu_torch.ops import binned
    bp = binned.binned_in(_bor_graph(), w_max=512).to(dev)
    wide = _bor_planes(bp, torch.int32, 8, 5, dev)
    K.reset_launch_counts()
    strided = wide[:, ::2]                      # 16-byte rows, strided
    assert torch.equal(binned.edge_map(bp, strided, "bor"),
                       K.edge_map_bor_ref(bp, strided))
    narrow = wide[:, :2].contiguous()           # 8-byte rows
    assert torch.equal(binned.edge_map(bp, narrow, "bor"),
                       K.edge_map_bor_ref(bp, narrow))
    i64 = _bor_planes(bp, torch.int64, 2, 6, dev)    # not a plane type
    assert torch.equal(binned.edge_map(bp, i64, "bor"),
                       K.edge_map_bor_ref(bp, i64))
    assert K.launch_counts()["edge_map_bor"] == 0
    for bad in (strided, narrow, i64):
        with pytest.raises(ValueError):
            K.edge_map_bor(bp, bad)
    flat = torch.zeros(wide.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(wide.shape)         # contiguous, 4 bytes off
    shifted.copy_(wide)
    assert shifted.data_ptr() % 16
    assert torch.equal(binned.edge_map(bp, shifted, "bor"),
                       K.edge_map_bor_ref(bp, wide))
    assert K.launch_counts()["edge_map_bor"] == 1


def _level_case(bp, dtype, lanes, seed, dev):
    """A sparse frontier (p = 1/16 a bit) and a denser ``visited`` (p =
    1/4) on ``dev``, the latter with bits in its pad and identity rows that
    a level must leave alone."""
    frontier = _bor_planes(bp, dtype, lanes, seed, dev)
    rng = np.random.default_rng(seed + 1)
    raw = rng.integers(0, 256, (2, bp.n_rows, lanes * dtype.itemsize),
                       dtype=np.uint8)
    return frontier, torch.from_numpy(raw[0] & raw[1]).view(dtype).to(dev)


def _level_equal(bp, frontier, visited, level=None):
    """The level kernel (``level``: the call, by default the wrapper)
    against its plain version on copies of ``visited``: the next frontier,
    ``visited`` (its pad rows untouched) and the row count equal; returns
    the count."""
    want_vis = visited.clone()
    want, want_rows = K.edge_map_bor_level_ref(bp, frontier, want_vis)
    vis = visited.clone()
    got, rows = (level or K.edge_map_bor_level)(bp, frontier, vis)
    torch.cuda.synchronize()
    assert got.dtype == frontier.dtype and torch.equal(got, want)
    assert torch.equal(vis, want_vis)
    assert torch.equal(vis[bp.n_nodes:], visited[bp.n_nodes:])
    assert rows.dtype == torch.int32 and rows.dim() == 0
    assert rows.device == frontier.device and int(rows) == int(want_rows)
    return int(rows)


@pytest.mark.parametrize("w_max", [64, 512, 4096])
@pytest.mark.parametrize("plane_bits", [8, 16, 32])
@pytest.mark.parametrize("B", [128, 1024, 4096])
def test_edge_map_bor_level_kernel_matches_ref(dev, B, plane_bits, w_max):
    """The level kernel equals its plain version bit for bit at the bit
    BFS's row widths (16, 128, 512 bytes), with thousands of hub rows (w_max
    64), a few (512) and none (4096): the next frontier, ``visited`` and
    the count of nonzero node rows, on every launch, one launch a call; an
    empty frontier gives zeros, no row and ``visited`` unchanged."""
    from green_marl_tpu_torch.models.batched import PLANE_DTYPES
    from green_marl_tpu_torch.ops import binned
    bp = binned.binned_in(_bor_graph(), w_max=w_max).to(dev)
    assert (bp.n_hub > 1000) == (w_max == 64)
    assert (bp.n_hub_chunks > 0) == (w_max < 4096)
    dtype = PLANE_DTYPES[plane_bits]
    frontier, visited = _level_case(bp, dtype, B // plane_bits,
                                     B + plane_bits + w_max, dev)
    K.reset_launch_counts()
    counts = [_level_equal(bp, frontier, visited) for _ in range(2)]
    counts.append(_level_equal(
        bp, frontier, visited,
        lambda *a: binned.edge_map_level(*a, slot_chunk=None)))
    assert K.launch_counts()["edge_map_bor_level"] == 3
    assert K.launch_counts()["edge_map_bor"] == 0
    assert len(set(counts)) == 1 and 0 < counts[0] < bp.n_nodes
    assert _level_equal(bp, torch.zeros_like(frontier), visited) == 0


@pytest.mark.parametrize("dtype,lanes", [
    (torch.int32, 8), (torch.int32, 12), (torch.uint8, 64),
    (torch.int16, 128), (torch.uint8, 16), (torch.int16, 192)])
def test_edge_map_bor_level_kernel_row_widths(dev, dtype, lanes):
    """Rows of 32, 48, 64, 256, 16 and 384 bytes (subgroups of 2, 4 with 3
    reading, 4, 16, 1 and 32 with 24 reading lanes a row), with hubs: the
    level kernel equals its plain version."""
    from green_marl_tpu_torch.ops import binned
    bp = binned.binned_in(_bor_graph(), w_max=512).to(dev)
    frontier, visited = _level_case(bp, dtype, lanes, lanes, dev)
    assert _level_equal(bp, frontier, visited) > 0


def test_edge_map_bor_level_routes(dev):
    """Planes off a 16-byte boundary, planes in one storage and planes the
    rule refuses (8-byte rows) raise on the card, in the wrapper and in
    ``binned.edge_map_level``, and launch nothing; aligned planes launch
    once."""
    from green_marl_tpu_torch.ops import binned
    bp = binned.binned_in(_bor_graph(), w_max=512).to(dev)
    frontier, visited = _level_case(bp, torch.int32, 8, 9, dev)
    flat = torch.zeros(2 * visited.numel() + 1, dtype=torch.int32,
                       device=dev)
    shifted_f = flat[1:1 + frontier.numel()].view(frontier.shape)
    other = torch.zeros(visited.numel() + 1, dtype=torch.int32, device=dev)
    shifted_v = other[1:].view(visited.shape)
    shifted_f.copy_(frontier)
    shifted_v.copy_(visited)
    assert shifted_f.data_ptr() % 16 and shifted_v.data_ptr() % 16
    K.reset_launch_counts()
    narrow_f, narrow_v = (t[:, :2].contiguous() for t in (frontier, visited))
    for level in (K.edge_map_bor_level, binned.edge_map_level):
        for f, v in ((shifted_f, visited), (frontier, shifted_v),
                     (shifted_f, shifted_v),            # off 16 bytes
                     (frontier, frontier),
                     (shifted_f, flat[-visited.numel():]
                      .view(visited.shape)),            # one storage
                     (narrow_f, narrow_v)):             # 8-byte rows
            with pytest.raises(ValueError):
                level(bp, f, v)
    assert K.launch_counts()["edge_map_bor_level"] == 0
    assert torch.equal(shifted_v, visited)
    _level_equal(bp, frontier, visited)
    assert K.launch_counts()["edge_map_bor_level"] == 1


@pytest.mark.parametrize("plane_bits,B", [(8, 1024), (32, 4096), (8, 40),
                                          (16, 200), (32, 100)])
def test_bit_bfs_on_the_kernel(dev, plane_bits, B):
    """``multi_source_bfs_bits`` on the card (one ``edge_map_bor_level``
    launch a level and no ``edge_map_bor``, one ``bit_popstats`` launch a
    call) equals the paged variant on the card (one ``edge_map_bor`` launch
    a level) and the CPU path (no launch), in planes, levels, reached and
    traversed; also where the planes' rows are padded to 16 bytes (B =
    40, 200, 100: 5, 26 and 16 bytes of instances)."""
    from green_marl_tpu_torch.models import batched
    g = _bor_graph()
    rng = np.random.default_rng(B)
    roots = rng.choice(np.flatnonzero(g.out_degree()[:g.num_nodes].numpy()),
                       B, replace=False)
    runs = {}
    for name, graph, fn in (
            ("cpu", g, batched.multi_source_bfs_bits),
            ("card", g.to(dev), batched.multi_source_bfs_bits),
            ("paged", g.to(dev), batched.multi_source_bfs_bits_paged)):
        bp, deg_rows, chunk = batched.bits_schedule(graph, B, plane_bits)
        K.reset_launch_counts()
        res = fn(bp, roots, deg_rows, plane_bits=plane_bits,
                 slot_chunk=chunk)
        counts = K.launch_counts()
        runs[name] = (res, counts["edge_map_bor"],
                      counts["edge_map_bor_level"], counts["bit_popstats"])
    cpu, card, paged = (runs[k][0] for k in ("cpu", "card", "paged"))
    assert runs["cpu"][1:] == (0, 0, 0) and cpu.levels_run > 2
    assert runs["card"][1:3] == (0, card.levels_run)
    assert card.levels_run == cpu.levels_run
    assert runs["paged"][1:3] == (paged.levels_run, 0)
    assert paged.levels_run == cpu.levels_run
    assert runs["card"][3] == runs["paged"][3] == 1    # one popcount a call
    for res in (card, paged):
        assert torch.equal(res.visited.cpu(), cpu.visited)
        assert torch.equal(res.reached.cpu(), cpu.reached)
        assert torch.equal(res.traversed.cpu(), cpu.traversed)


# -- the bit BFS's final popcount (csrc/popstats.cu) ---------------------

POP_ROWS = 70_001          # not a multiple of the kernel's 32-row tile


def _pop_case(kind, dtype, lanes, seed, n_rows=POP_ROWS):
    """A [n_rows, lanes] plane and [n_rows] int32 degrees, on the CPU.

    ``random``: every bit drawn, degrees over all of int32 (negative too);
    ``zero`` and ``ones``: every bit 0 or 1; ``mixed``: what the end of a
    bit BFS looks like, runs of rows reached by no source, by every
    source, or by all but a few (one mask repeated), with rows of sparse
    bits between, and five rows of degree 2^31 - 1 with every bit set, so
    that each instance's traversed count passes 2^32."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n_rows, lanes * dtype.itemsize),
                       dtype=np.uint8)
    deg = rng.integers(0, 1 << 12, n_rows).astype(np.int32)
    if kind == "random":
        deg = rng.integers(-(1 << 31), 1 << 31, n_rows).astype(np.int32)
    elif kind == "zero":
        raw[:] = 0
    elif kind == "ones":
        raw[:] = 255
    else:
        most = np.full(raw.shape[1], 255, np.uint8)
        most[rng.integers(0, raw.shape[1], 3)] = 0b1011_1111
        cut = np.sort(rng.integers(0, n_rows, 6))
        raw[cut[0]:cut[1]] = 0
        raw[cut[1]:cut[2]] = 255
        raw[cut[2]:cut[3]] = most
        raw[cut[4]:cut[5]] &= rng.integers(0, 256, raw[cut[4]:cut[5]].shape,
                                           dtype=np.uint8)
        raw[:5] = 255
        deg[:5] = (1 << 31) - 1
    return torch.from_numpy(raw).view(dtype), torch.from_numpy(deg)


@pytest.mark.parametrize("kind", ["random", "zero", "ones", "mixed"])
@pytest.mark.parametrize("lanes", [1, 3, 8, 32, 128])
@pytest.mark.parametrize("plane_bits", [8, 16, 32])
def test_bit_popstats_kernel_matches_ref(dev, plane_bits, lanes, kind):
    """The kernel equals the plain version bit for bit for each plane type
    and lane count (rows of 1 to 512 bytes, some not a multiple of 4), on
    70,001 rows, one launch a call."""
    from green_marl_tpu_torch.models.batched import PLANE_DTYPES
    plane, deg = _pop_case(kind, PLANE_DTYPES[plane_bits], lanes,
                           plane_bits * 1000 + lanes)
    want = K.bit_popstats_ref(plane, deg)
    K.reset_launch_counts()
    got = K.bit_popstats(plane.to(dev), deg.to(dev))
    assert K.launch_counts()["bit_popstats"] == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == (lanes * plane_bits,)
        assert torch.equal(g.cpu(), w)
    if kind == "mixed":
        assert bool((want[1] > 1 << 32).all())
    if kind == "ones":
        assert bool((want[0] == POP_ROWS).all())


@pytest.mark.parametrize("dtype,lanes,offset", [(torch.uint8, 8, 1),
                                                (torch.uint8, 12, 3),
                                                (torch.int16, 6, 2)])
def test_bit_popstats_unaligned_plane(dev, dtype, lanes, offset):
    """A plane whose rows are whole 4-byte words but that starts off a
    4-byte boundary is read a byte at a time: the same counts."""
    plane, deg = _pop_case("mixed", dtype, lanes, lanes)
    nbytes = plane.numel() * dtype.itemsize
    flat = torch.zeros(nbytes + offset, dtype=torch.uint8, device=dev)
    shifted = flat[offset:].view(dtype).view(plane.shape)
    shifted.copy_(plane.to(dev))
    assert shifted.data_ptr() % 4
    got = K.bit_popstats(shifted, deg.to(dev))
    want = K.bit_popstats_ref(plane, deg)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_bit_popstats_refusals_and_routes(dev):
    """What the rule refuses raises, in the wrapper and in
    ``_bit_popstats`` on the card, and launches nothing; what it admits
    launches once a call."""
    from green_marl_tpu_torch.models import batched
    plane, deg = _pop_case("mixed", torch.int32, 8, 3, n_rows=5000)
    plane, deg = plane.to(dev), deg.to(dev)
    strided = plane[:, ::2]
    K.reset_launch_counts()
    for bad in (strided, plane.long(), plane != 0):
        with pytest.raises(ValueError):
            K.bit_popstats(bad, deg)
    with pytest.raises(TypeError):
        K.bit_popstats(plane, deg.long())
    with pytest.raises(ValueError):
        K.bit_popstats(plane, deg[1:])
    with pytest.raises(ValueError):
        K.bit_popstats(plane, deg.cpu())
    for bad, bits in ((strided, 32), (plane, 8)):
        with pytest.raises(ValueError):
            batched._bit_popstats(bad, deg, bad.shape[1], bits)
    assert K.launch_counts()["bit_popstats"] == 0
    got = batched._bit_popstats(plane, deg, 8, 32)
    want = K.bit_popstats_ref(plane.cpu(), deg.cpu())
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert K.launch_counts()["bit_popstats"] == 1
