"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``green_marl_tpu/ops/pallas_kernels.py`` and of the Pallas
kernels of the gather probes (``scripts/probe_gather{,2,3,4}.py``):

* ``segment_reduce_sorted`` -- ``out[v] = op-reduce(vals[offsets[v]:offsets[v+1]])``
  for op add, min or max on int32 or float32 (``csrc/segment_reduce.cu``);
* ``plain_cumsum`` -- inclusive or exclusive prefix sum of a 1-D int32 or
  float32 tensor, int32 exact mod 2^32 (``csrc/cumsum.cu``);
* ``segmented_scan`` -- globally segmented inclusive scan, add/min/max on
  int32 or float32, segments = runs of equal ids (``csrc/segmented_scan.cu``);
* ``take_along_blocks`` -- the probes' blocked ``take_along_axis`` on
  [*, 128] float32 blocks (``csrc/gather_probe.cu``);
* ``row_gather_checksum`` -- the probes' K-in-flight row gather, returning
  ``sweeps * sum(table[idx, 0])`` mod 2^32 (``csrc/gather_probe.cu``).

Each wrapper checks its arguments, then dispatches on the tensor's device:
a CPU tensor takes the plain version (``*_ref``), a CUDA tensor launches the
kernel on the current stream or raises.  Nothing falls back.  Each wrapper
counts its kernel launches in its ``launches`` attribute, so that a run can
show that its main path went through the kernels.

Unlike the JAX CPU path (``jax.ops.segment_*``, which lets padded slots
collect into the sentinel row ``N``), both versions here follow the TPU
kernel: every empty segment and every row from ``len(offsets) - 1`` up to
``n_out`` gets the op's identity.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

OPS = ("add", "min", "max")
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
KERNEL_DTYPES = tuple(_DTYPE_CODE)   # what the segment kernels take
_SCATTER_REDUCE = {"add": "sum", "min": "amin", "max": "amax"}


def identity(op: str, dtype: torch.dtype):
    """The reduction identity: 0, the dtype's max (min) or -max (+inf)."""
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return math.inf if op == "min" else -math.inf
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _check_1d(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def _cuda_stream(t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# Sorted-segment reduction
# ---------------------------------------------------------------------------

def segment_reduce_sorted_ref(vals: torch.Tensor, ids: torch.Tensor,
                              offsets: torch.Tensor, n_out: int,
                              op: str = "add") -> torch.Tensor:
    """Plain version of :func:`segment_reduce_sorted` (scatter-reduce over
    segment numbers expanded from ``offsets``; ``ids`` is not read)."""
    n_seg = offsets.numel() - 1
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=vals.device), offsets.diff().long())
    lo = int(offsets[0])
    out = torch.full((n_out,), identity(op, vals.dtype), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, seg, vals[lo:lo + seg.numel()],
                               _SCATTER_REDUCE[op], include_self=True)


def segment_reduce_sorted(vals: torch.Tensor, ids: torch.Tensor,
                          offsets: torch.Tensor, n_out: int,
                          op: str = "add") -> torch.Tensor:
    """Sorted-segment reduction ``out[v] = op-reduce(vals[offsets[v]:offsets[v+1]])``.

    ``vals``/``ids``: [E_pad] edge-slot arrays (CSC or CSR order); ``ids``
    is the segment id of each slot and is checked for shape only, since the
    runs are read from ``offsets`` ([N+1] int32, sorted).  Returns [n_out];
    empty segments and rows ``N..n_out-1`` get the op's identity.

    ``offsets`` must ascend within ``[0, len(vals)]``, as a ``Graph``'s
    ``begin``/``r_begin`` do; the kernel does not check it (that would
    cost a device-to-host sync per call).  Slots outside
    ``[offsets[0], offsets[-1])`` do not count.

    On the card, persistent blocks walk tiles of consecutive edge slots
    (``csrc/segment_reduce.cu``); a segment cut by a tile edge is put
    together from the tiles' parts in an order that depends on the data
    alone.  So int32 and min/max equal the plain version bit for bit, and
    float32 add, which sums in another order than a sequential loop (within
    rounding: rtol 1e-5 against float64 for values of one sign), gives the
    same bits on every launch.  ``vals`` that is not 16-byte aligned (a
    view such as ``x[1:]``) is read with 4-byte loads: the same result,
    more slowly.  The launch is cooperative: it needs a device that
    supports ``cudaLaunchCooperativeKernel``.
    """
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    _check_1d("vals", vals, _DTYPE_CODE)
    _check_1d("offsets", offsets, (torch.int32,))
    if ids.shape != vals.shape:
        raise ValueError(f"ids shape {tuple(ids.shape)} != vals shape "
                         f"{tuple(vals.shape)}")
    if offsets.numel() < 1 or n_out < offsets.numel() - 1:
        raise ValueError(f"need 1 <= len(offsets) <= n_out + 1, got "
                         f"{offsets.numel()} and n_out={n_out}")
    if offsets.device != vals.device:
        raise ValueError(f"offsets on {offsets.device}, vals on {vals.device}")
    if vals.device.type == "cpu":
        return segment_reduce_sorted_ref(vals, ids, offsets, n_out, op)
    stream = _cuda_stream(vals)
    lib = _build.lib()
    out = torch.empty(n_out, dtype=vals.dtype, device=vals.device)
    # per tile of edge slots a status word and a row bound (and one more
    # bound); the C entry clears what must start at 0
    n_tiles = max(1, -(-vals.numel() // lib.gm_segment_reduce_tile_size()))
    scratch = torch.empty(2 * n_tiles + 1, dtype=torch.int64,
                          device=vals.device)
    with torch.cuda.device(vals.device):
        err = lib.gm_segment_reduce(
            vals.data_ptr(), vals.numel(), offsets.data_ptr(),
            offsets.numel() - 1, n_out, out.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODE[vals.dtype], OPS.index(op), stream)
    if err:
        raise RuntimeError(f"gm_segment_reduce: CUDA error {err}")
    segment_reduce_sorted.launches += 1
    return out


segment_reduce_sorted.launches = 0


# ---------------------------------------------------------------------------
# Prefix sum
# ---------------------------------------------------------------------------

def plain_cumsum_ref(vals: torch.Tensor,
                     exclusive: bool = False) -> torch.Tensor:
    """Plain version of :func:`plain_cumsum`.  ``dtype=`` keeps int32 in
    int32 (``torch.cumsum`` would promote it to int64), so it wraps too."""
    c = torch.cumsum(vals, 0, dtype=vals.dtype)
    return torch.cat([c.new_zeros(1), c]) if exclusive else c


def plain_cumsum(vals: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Prefix sum of a 1-D int32 or float32 tensor of any length.

    Inclusive: ``out[i] = sum(vals[:i+1])``, ``n`` values.  ``exclusive``:
    ``out[i] = sum(vals[:i])``, ``n + 1`` values (``out[0] = 0``,
    ``out[n]`` the total), written by the kernel directly.  int32 sums are
    exact mod 2^32 (the global prefix may wrap; differences of prefixes
    stay exact), with no bound on chunk sums.  On the card the kernel is a
    single pass with decoupled look-back: tile aggregates are added in an
    order that depends on timing, so float32 results may differ in the
    last bits from run to run (int32 never does).  An input that is not
    16-byte aligned (a view such as ``x[1:]``) is read with 4-byte loads:
    the same result, more slowly.
    """
    _check_1d("vals", vals, _DTYPE_CODE)
    if vals.device.type == "cpu":
        return plain_cumsum_ref(vals, exclusive)
    stream = _cuda_stream(vals)
    lib = _build.lib()
    n = vals.numel()
    out = torch.empty(n + 1 if exclusive else n, dtype=vals.dtype,
                      device=vals.device)
    if n == 0:
        return out.zero_()          # the exclusive form's single 0
    # one status word per tile and the tile counter, cleared by the C entry
    scratch = torch.empty(-(-n // lib.gm_cumsum_tile_size()) + 1,
                          dtype=torch.int64, device=vals.device)
    with torch.cuda.device(vals.device):
        err = lib.gm_cumsum(vals.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), n, _DTYPE_CODE[vals.dtype],
                            int(exclusive), stream)
    if err:
        raise RuntimeError(f"gm_cumsum: CUDA error {err}")
    plain_cumsum.launches += 1
    return out


plain_cumsum.launches = 0


# ---------------------------------------------------------------------------
# Segmented scan
# ---------------------------------------------------------------------------

# "or" has no kernel: ``ops.segment.sorted_segment_or`` takes the plain scan
_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum,
            "or": torch.bitwise_or}


def segmented_scan_ref(vals: torch.Tensor, ids: torch.Tensor,
                       op: str = "add") -> torch.Tensor:
    """Plain version of :func:`segmented_scan`: a Hillis-Steele doubling
    scan, each step combining only within a segment (log2(n) passes).
    ``vals`` may carry trailing dimensions ([n, W]): each column is scanned
    with the same segments."""
    n = vals.shape[0]
    if n == 0:
        return vals.clone()
    pos = torch.arange(n, device=vals.device)
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    start = torch.where(ids != prev, pos, 0).cummax(0).values
    out = vals.clone()
    k = 1
    while k < n:
        take = (pos[k:] - k >= start[k:]).view(
            (-1,) + (1,) * (vals.dim() - 1))
        out[k:] = torch.where(take, _COMBINE[op](out[:-k], out[k:]), out[k:])
        k *= 2
    return out


def segmented_scan(vals: torch.Tensor, ids: torch.Tensor,
                   op: str = "add") -> torch.Tensor:
    """Globally segmented inclusive scan of ``vals`` with sorted ``ids``.

    ``out[i]`` is the op-reduction of ``vals[s..i]``, where ``s`` starts the
    run of equal ids that holds ``i``; as in the TPU kernel, the run at
    position 0 starts there unless ``ids[0] == -1``.  Any length is
    accepted: unlike the TPU kernel, no padding to a multiple of its
    32,768-slot chunk is needed.  int32 add wraps mod 2^32; float32 add
    sums in another order than a sequential scan (a thread's four slots,
    then trees over the threads of an 8,192-slot tile, then across
    tiles), so it agrees to rounding: within 1e-5 of the segmented scan
    of ``|vals|``.  On the card the kernel is a single pass with decoupled
    look-back (``csrc/segmented_scan.cu``): a segment that spans three
    tiles or more is summed across tiles in an order that depends on
    timing, so float32 add may differ in the last bits from run to run on
    such segments; int32 and min/max never do.  Tensors that are not
    16-byte aligned take 4-byte loads and stores: the same result, more
    slowly.
    """
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    _check_1d("vals", vals, _DTYPE_CODE)
    _check_1d("ids", ids, (torch.int32,))
    if ids.shape != vals.shape:
        raise ValueError(f"ids shape {tuple(ids.shape)} != vals shape "
                         f"{tuple(vals.shape)}")
    if ids.device != vals.device:
        raise ValueError(f"ids on {ids.device}, vals on {vals.device}")
    if vals.device.type == "cpu":
        return segmented_scan_ref(vals, ids, op)
    stream = _cuda_stream(vals)
    lib = _build.lib()
    n = vals.numel()
    out = torch.empty_like(vals)
    if n == 0:
        return out
    # one status word per tile and the tile counter, cleared by the C entry
    scratch = torch.empty(-(-n // lib.gm_segmented_scan_tile_size()) + 1,
                          dtype=torch.int64, device=vals.device)
    with torch.cuda.device(vals.device):
        err = lib.gm_segmented_scan(
            vals.data_ptr(), ids.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, _DTYPE_CODE[vals.dtype], OPS.index(op),
            stream)
    if err:
        raise RuntimeError(f"gm_segmented_scan: CUDA error {err}")
    segmented_scan.launches += 1
    return out


segmented_scan.launches = 0


# ---------------------------------------------------------------------------
# Gather probes: blocked take-along-axis and the K-in-flight row gather
# ---------------------------------------------------------------------------

LANES = 128
TAKE_MODES = ("axis0", "axis1", "row", "composed")
TAKE_ROUTES = ("L2", "block", "slab", "row")   # the C entry's route codes
SMEM_BYTES = 232_448      # shared memory one Hopper block may use
SLAB_BYTES = 131_072      # shared memory of one axis0 column slab
SLAB_MIN_COLS = 8         # narrower slabs lose to the L2 route
ROW_GATHER_K = (1, 2, 4, 8, 16)
ROW_GATHER_BINS = 256     # kBins of csrc/gather_probe.cu: sizes the scratch


def take_along_slab_cols(table_rows: int) -> int:
    """Columns of the widest slab of a ``table_rows``-row table block that
    fits ``SLAB_BYTES`` of shared memory: a power of two from
    ``SLAB_MIN_COLS`` (a 32-byte sector of each row) to 128 (the whole
    block), or 0 where ``SLAB_MIN_COLS`` columns do not fit."""
    cols = LANES
    while cols >= SLAB_MIN_COLS and table_rows * cols * 4 > SLAB_BYTES:
        cols //= 2
    return cols if cols >= SLAB_MIN_COLS else 0


def take_along_route(table_rows: int, mode: str = "axis0") -> str:
    """The route :func:`take_along_blocks` takes on the card, by shape alone:

    * ``"row"``: the row mode copies whole rows, one warp each;
    * ``"slab"``: axis0 stages :func:`take_along_slab_cols` columns of the
      table block in shared memory per CUDA block (all 128 where the whole
      block fits);
    * ``"block"``: axis1 and composed stage the whole table block in shared
      memory where it fits;
    * ``"L2"``: everything else reads the table through L1/L2.
    """
    if mode == "row":
        return "row"
    if mode == "axis0":
        return "slab" if take_along_slab_cols(table_rows) else "L2"
    return "block" if table_rows * LANES * 4 <= SMEM_BYTES else "L2"


def _take_check(table, idx, mode, block_rows, table_rows, window):
    if mode not in TAKE_MODES:
        raise ValueError(f"mode must be one of {TAKE_MODES}, got {mode!r}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"need a float32 table and int32 idx, got "
                        f"{table.dtype} and {idx.dtype}")
    for name, t in (("table", table), ("idx", idx)):
        if t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"{name}: expected [*, {LANES}], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    R = idx.shape[0]
    if block_rows <= 0 or R % block_rows:
        raise ValueError(f"idx rows ({R}) must be a multiple of "
                         f"block_rows ({block_rows})")
    if mode == "axis1" and block_rows > table_rows:
        raise ValueError("axis1 needs block_rows <= table_rows")
    need = table_rows if window else R // block_rows * table_rows
    if table.shape[0] < need:
        raise ValueError(f"table has {table.shape[0]} rows, needs {need}")


def take_along_blocks_ref(table: torch.Tensor, idx: torch.Tensor, mode: str,
                          block_rows: int, table_rows: Optional[int] = None,
                          window: bool = False,
                          split: bool = False) -> torch.Tensor:
    """Plain version of :func:`take_along_blocks`: ``torch.gather`` on the
    reshaped blocks."""
    th = table_rows or block_rows
    R, bh = idx.shape[0], block_rows
    nb = R // bh
    tb = (table[:th].unsqueeze(0).expand(nb, th, LANES) if window
          else table[:nb * th].view(nb, th, LANES))
    ib = idx.view(nb, bh, LANES)

    def rpart(v):
        return (v >> 7 if split else v).clamp(0, th - 1).long()

    def lpart(v):
        return (v & 127 if split else v.clamp(0, LANES - 1)).long()

    if mode == "axis0":
        out = torch.gather(tb, 1, rpart(ib))
    elif mode == "axis1":
        out = torch.gather(tb, 2, lpart(ib))
    elif mode == "row":
        out = torch.gather(tb, 1, rpart(ib[:, :, :1]).expand(-1, -1, LANES))
    else:                                    # composed
        out = torch.gather(torch.gather(tb, 1, rpart(ib)), 2, lpart(ib))
    return out.reshape(R, LANES)


def take_along_blocks(table: torch.Tensor, idx: torch.Tensor, mode: str,
                      block_rows: int, table_rows: Optional[int] = None,
                      window: bool = False,
                      split: bool = False) -> torch.Tensor:
    """The gather probes' blocked ``take_along_axis`` on [*, 128] blocks.

    Grid step ``b`` covers idx rows ``[b*block_rows, (b+1)*block_rows)``
    and reads the table block of ``table_rows`` rows (default
    ``block_rows``) that starts at row ``b*table_rows``, or at row 0 for
    a fixed ``window``.  With ``i`` the row within the step and ``r()``,
    ``l()`` the row and lane parts of an index (the index itself, or with
    ``split`` its ``>> 7`` and ``& 127``), clipped to the block:

    * axis0: ``out[i,j] = tb[r(idx[i,j]), j]``
    * axis1: ``out[i,j] = tb[i, l(idx[i,j])]``
    * row: ``out[i,j] = tb[r(idx[i,0]), j]``
    * composed: ``l = l(idx[i,j]); out[i,j] = tb[r(idx[i,l]), l]``

    Returns [R, 128] float32.  On the card the shape picks the kernel
    (:func:`take_along_route`).
    """
    th = table_rows or block_rows
    _take_check(table, idx, mode, block_rows, th, window)
    if table.device.type == "cpu":
        return take_along_blocks_ref(table, idx, mode, block_rows, th,
                                     window, split)
    stream = _cuda_stream(table)
    if table.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("table and idx must be 16-byte aligned")
    route = take_along_route(th, mode)
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        err = _build.lib().gm_take_along(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            block_rows, th, 0 if window else th, TAKE_MODES.index(mode),
            int(split), TAKE_ROUTES.index(route), take_along_slab_cols(th),
            stream)
    if err:
        raise RuntimeError(f"gm_take_along: CUDA error {err}")
    take_along_blocks.launches += 1
    return out


take_along_blocks.launches = 0


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's value mod 2^32, as int32 (two's complement)."""
    x = torch.remainder(x, 1 << 32)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def row_gather_checksum_ref(table: torch.Tensor, idx: torch.Tensor,
                            sweeps: int = 1) -> torch.Tensor:
    """Plain version of :func:`row_gather_checksum`: gathers whole rows, as
    the kernel does (so the two times compare like work), and sums their
    element 0."""
    ids = idx.clamp(0, table.shape[0] - 1)
    first = table.index_select(0, ids)[:, 0].to(torch.int64)
    return _wrap_int32(first.sum() * sweeps)


def row_gather_scratch(n_ids: int) -> Tuple[int, int]:
    """Scratch of one :func:`row_gather_checksum` launch, in 4-byte words:
    ``(zeroed, binned)``.  ``zeroed`` holds the sum, the histogram of the
    ``ROW_GATHER_BINS`` table regions and a cursor per region, and must
    start at 0; ``binned`` takes the ``n_ids`` ids in binned order."""
    return 1 + 2 * ROW_GATHER_BINS, n_ids


def row_gather_checksum(table: torch.Tensor, idx: torch.Tensor,
                        sweeps: int = 1, k: int = 4) -> torch.Tensor:
    """The gather probe's K-in-flight row gather.

    ``table``: int32 [n_rows, roww] with roww a multiple of 4 up to 128
    (16 to 512-byte rows); ``idx``: int32 [R] row ids in ``[0, n_rows)``
    (clipped to it).  Gathers whole rows ``idx[j]``, each ``sweeps`` times,
    ``k`` copy steps in flight per warp (a step is one row, or as many rows
    of 256 bytes or less as a warp's 32 lanes cover, up to 8), and returns
    the 0-d int32 ``sweeps * sum(table[idx, 0])`` mod 2^32.  The sum does
    not depend on the order of the requests, so the kernel first bins the
    ids by table region (at most ``ROW_GATHER_BINS`` regions of a
    power-of-two number of rows) and walks them in that order: requests for
    one row meet in L2.
    """
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"need an int32 table and int32 idx, got "
                        f"{table.dtype} and {idx.dtype}")
    if table.dim() != 2 or table.shape[1] % 4 or not 0 < table.shape[1] <= 128:
        raise ValueError(f"table must be [n_rows, 4*m <= 128], got "
                         f"{tuple(table.shape)}")
    if not 1 <= table.shape[0] < 1 << 31:
        raise ValueError(f"table has {table.shape[0]} rows, need 1 to 2^31-1")
    _check_1d("idx", idx, (torch.int32,))
    if idx.numel() >= 1 << 31:
        raise ValueError(f"idx has {idx.numel()} ids, at most 2^31-1")
    if not table.is_contiguous():
        raise ValueError("table: tensor is not contiguous")
    if k not in ROW_GATHER_K:
        raise ValueError(f"k must be one of {ROW_GATHER_K}, got {k}")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if table.device.type == "cpu":
        return row_gather_checksum_ref(table, idx, sweeps)
    stream = _cuda_stream(table)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    n_zeroed, n_binned = row_gather_scratch(idx.numel())
    zeroed = torch.zeros(n_zeroed, dtype=torch.int32, device=table.device)
    binned = torch.empty(n_binned, dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        err = _build.lib().gm_row_gather(
            table.data_ptr(), table.shape[0], table.shape[1], idx.data_ptr(),
            idx.numel(), sweeps, k, zeroed.data_ptr(),
            binned.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gm_row_gather: CUDA error {err}")
    row_gather_checksum.launches += 1
    return zeroed[0]


row_gather_checksum.launches = 0

_WRAPPERS = (segment_reduce_sorted, plain_cumsum, segmented_scan,
             take_along_blocks, row_gather_checksum)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
