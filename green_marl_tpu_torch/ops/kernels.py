"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of ``green_marl_tpu/ops/pallas_kernels.py`` and of the Pallas
kernels of the gather probes (``scripts/probe_gather{,2,3,4}.py``):

* ``segment_reduce_sorted`` -- ``out[v] = op-reduce(vals[offsets[v]:offsets[v+1]])``
  for op add, min or max on int32 or float32 (``csrc/segment_reduce.cu``);
  its gather form takes node ids for ``vals`` and reduces, by min, the node
  values they pick where a node flag is set, plus a weight a slot: the
  superstep of hop_dist and sssp (``models/relax.py``) in one launch;
* ``plain_cumsum`` -- inclusive or exclusive prefix sum of an int32 or
  float32 tensor, int32 exact mod 2^32 (``csrc/cumsum.cu``);
* ``segmented_scan`` -- globally segmented inclusive scan, add/min/max on
  int32 or float32, segments = runs of equal ids (``csrc/segmented_scan.cu``);
* ``take_along_blocks`` -- the probes' blocked ``take_along_axis`` on
  [*, 128] float32 blocks (``csrc/gather_probe.cu``);
* ``row_gather_checksum`` -- the probes' K-in-flight row gather, returning
  ``sweeps * sum(table[idx, 0])`` mod 2^32 (``csrc/gather_probe.cu``);
* ``edge_map_bor`` -- the binned edge map's bitwise OR of integer bit
  planes (``ops/binned.py`` ``edge_map``, op ``"bor"``; ``csrc/edge_map.cu``);
* ``edge_map_bor_level`` -- a bit-BFS level: that edge map with the
  frontier's update (``hit & ~visited``, ORed into ``visited``) and the
  count of its nonzero rows taken into its row writes (``ops/binned.py``
  ``edge_map_level``; ``csrc/edge_map.cu``);
* ``bit_popstats`` -- the bit BFS's per-instance reached and traversed
  counts from its final plane (``models/batched.py`` ``_bit_popstats``;
  ``csrc/popstats.cu``);
* ``triangle_search`` -- triangle counting's wedge search over the
  degree-ordered DAG, the exact int64 count of the wedges that close a
  triangle (``models/triangle.py`` ``count_search``; ``csrc/triangle.cu``).

The first two also take lanes, as the TPU kernels take them under
``jax.vmap`` (a batched compiled program, ``lang.lower.CompiledProc.batch``):
``[B, n]`` values give ``[B, n_out]`` results, each row what the 1-D call
gives on it, with the offsets shared by the rows.

Each wrapper checks its arguments, then dispatches on the tensor's device:
a CPU tensor takes the plain version (``*_ref``), a CUDA tensor launches the
kernel on the current stream or raises.  Nothing falls back.  Each wrapper
counts its kernel launches in its ``launches`` attribute (the lane-batched
launches of the first two in ``lane_launches``), so that a run can show
that its main path went through the kernels.

Unlike the JAX CPU path (``jax.ops.segment_*``, which lets padded slots
collect into the sentinel row ``N``), both versions here follow the TPU
kernel: every empty segment and every row from ``len(offsets) - 1`` up to
``n_out`` gets the op's identity.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build

OPS = ("add", "min", "max")
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
KERNEL_DTYPES = tuple(_DTYPE_CODE)   # what the segment kernels take
_SCATTER_REDUCE = {"add": "sum", "min": "amin", "max": "amax"}


_COUNT_LOCK = threading.Lock()


def _count(name: str, lanes: bool = False, gather: bool = False) -> None:
    """One more launch of wrapper ``name``'s kernel, or of its lane-batched
    form; the gather form counts in ``launches`` and in ``gather_launches``
    (the shards of a sharded run launch from threads of their own).
    The wrapper is looked up among ``_WRAPPERS``, not in the module, so a
    caller that wraps a module attribute to watch its calls does not take
    the count."""
    fn = _wrapper(name)
    with _COUNT_LOCK:
        if lanes:
            fn.lane_launches += 1
        else:
            fn.launches += 1
        if gather:
            fn.gather_launches += 1


def _wrapper(name: str):
    """The wrapper function ``name`` itself, which holds its counts."""
    return next(f for f in _WRAPPERS if f.__name__ == name)


def identity(op: str, dtype: torch.dtype):
    """The reduction identity: 0, the dtype's max (min) or -max (+inf)."""
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return math.inf if op == "min" else -math.inf
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _check_1d(name: str, t: torch.Tensor, dtypes, dims=(1,)) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.dim() not in dims:
        raise ValueError(f"{name}: expected a {' or '.join(map(str, dims))}"
                         f"-D tensor, got {tuple(t.shape)}")
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
                              op: str = "add", *,
                              node_vals: Optional[torch.Tensor] = None,
                              node_mask: Optional[torch.Tensor] = None,
                              add: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of :func:`segment_reduce_sorted` (scatter-reduce over
    segment numbers expanded from ``offsets``; ``ids`` is not read).  Rows
    of ``[B, E]`` values are reduced alike.  The gather form: two
    ``index_select``, the add and a ``where`` make the values first."""
    if node_vals is not None:
        picked = node_vals.index_select(0, vals)
        vals = torch.where(node_mask.index_select(0, vals),
                           picked + (1 if add is None else add),
                           identity(op, node_vals.dtype))
    n_seg = offsets.numel() - 1
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=vals.device), offsets.diff().long())
    lo = int(offsets[0])
    out = torch.full(tuple(vals.shape[:-1]) + (n_out,),
                     identity(op, vals.dtype), dtype=vals.dtype,
                     device=vals.device)
    src = vals[..., lo:lo + seg.numel()]
    return out.scatter_reduce_(-1, seg.expand(src.shape), src,
                               _SCATTER_REDUCE[op], include_self=True)


def segment_reduce_sorted(vals: torch.Tensor, ids: torch.Tensor,
                          offsets: torch.Tensor, n_out: int,
                          op: str = "add", base: int = 0, *,
                          node_vals: Optional[torch.Tensor] = None,
                          node_mask: Optional[torch.Tensor] = None,
                          add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sorted-segment reduction ``out[v] = op-reduce(vals[offsets[v]:offsets[v+1]])``.

    ``vals``/``ids``: [E_pad] edge-slot arrays (CSC or CSR order); ``ids``
    is the segment id of each slot and is checked for shape only, since the
    runs are read from ``offsets`` ([N+1] int32, sorted).  Returns [n_out];
    empty segments and rows ``N..n_out-1`` get the op's identity.  Lanes:
    ``vals`` [B, E_pad] (``ids`` and ``offsets`` shared) gives [B, n_out]
    in one launch, each row the bits of the 1-D call on it.

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
    same bits on every launch.  Lanes go to a kernel of their own that
    takes a tile, finds its rows once and walks it for every lane, each
    lane's values streamed in by TMA bulk copies.  ``vals`` that is not
    16-byte aligned (a view such as ``x[1:]``), or lanes of a length that
    is not a multiple of 4, is read with 4-byte loads: the same result,
    more slowly.  The launch is cooperative: it needs a device that
    supports ``cudaLaunchCooperativeKernel``.

    ``base``: the position of ``vals[0]`` in a longer slot array that
    another call reduces whole, as a shard's slab of a graph's CSC sits in
    the CSC.  The float32 sum of a segment depends on where the tile edges
    fall; on the card the values are laid ``base`` mod the tile size slots
    into the launch (a copy of ``vals``), so that the tiles are cut where
    the whole array's are and every segment gets the whole call's bits,
    whatever the slab.  The plain version's order does not depend on the
    position.

    The gather form, with ``node_vals`` ([n_nodes] int32 or float32) and
    ``node_mask`` ([n_nodes] bool): ``vals`` is the int32 node id of each
    slot, and slot i contributes ``node_vals[vals[i]] + add[i]`` (``+ 1``
    where ``add``, [E_pad] of ``node_vals``' dtype, is None) where
    ``node_mask[vals[i]]`` is set, the identity where it is not.  The add
    is PyTorch's (int32 wraps; float32 rounds once), so the result has the
    bits of the plain version's ``index_select``, ``index_select``, add,
    ``where`` and segment min.  ``op`` must be ``"min"`` and ``vals`` 1-D;
    ``base`` changes nothing (a min does not depend on where the tiles are
    cut).  The ids of the slots in ``[offsets[0], offsets[-1])`` must lie
    in ``[0, n_nodes)``: the kernel reads the tables there unchecked, and
    reads nothing at the other slots.  Counted in ``launches`` and in
    ``gather_launches``.
    """
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    gather = node_vals is not None
    if gather:
        _check_gather(vals, op, node_vals, node_mask, add)
    elif node_mask is not None or add is not None:
        raise ValueError("node_mask and add need node_vals")
    else:
        _check_1d("vals", vals, _DTYPE_CODE, dims=(1, 2))
    _check_1d("offsets", offsets, (torch.int32,))
    if ids.shape != vals.shape[-1:]:
        raise ValueError(f"ids shape {tuple(ids.shape)} != vals shape "
                         f"{tuple(vals.shape)}")
    if offsets.numel() < 1 or n_out < offsets.numel() - 1:
        raise ValueError(f"need 1 <= len(offsets) <= n_out + 1, got "
                         f"{offsets.numel()} and n_out={n_out}")
    if offsets.device != vals.device:
        raise ValueError(f"offsets on {offsets.device}, vals on {vals.device}")
    if vals.device.type == "cpu":
        return segment_reduce_sorted_ref(vals, ids, offsets, n_out, op,
                                         node_vals=node_vals,
                                         node_mask=node_mask, add=add)
    stream = _cuda_stream(vals)
    lib = _build.lib()
    if gather:
        return _gather_launch(lib, stream, vals, offsets, n_out, node_vals,
                              node_mask, add)
    phase = base % lib.gm_segment_reduce_tile_size()
    if phase:
        # slots before offsets[0] count as the identity, whatever they hold
        vals = torch.cat([vals.new_zeros(tuple(vals.shape[:-1]) + (phase,)),
                          vals], -1)
        offsets = offsets + phase
    lanes, n_vals = (1, vals.shape[0]) if vals.dim() == 1 else vals.shape
    out = torch.empty(tuple(vals.shape[:-1]) + (n_out,), dtype=vals.dtype,
                      device=vals.device)
    if out.numel() == 0:
        return out
    # per lane and tile of edge slots a status word, per tile a row bound
    # (and one more bound), per chunk of rows the end of a run of empty
    # rows; the C entry clears what must start at 0
    n_tiles = max(1, -(-n_vals // lib.gm_segment_reduce_tile_size()))
    n_chunks = -(-(offsets.numel() - 1) // lib.gm_segment_reduce_row_chunk())
    scratch = torch.empty((lanes + 1) * n_tiles + 1 + n_chunks,
                          dtype=torch.int64, device=vals.device)
    with torch.cuda.device(vals.device):
        err = lib.gm_segment_reduce(
            vals.data_ptr(), lanes, n_vals, offsets.data_ptr(),
            offsets.numel() - 1, n_out, out.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODE[vals.dtype], OPS.index(op), stream)
    if err:
        raise RuntimeError(f"gm_segment_reduce: CUDA error {err}")
    _count("segment_reduce_sorted", lanes=vals.dim() == 2)
    return out


segment_reduce_sorted.launches = 0
segment_reduce_sorted.lane_launches = 0
segment_reduce_sorted.gather_launches = 0


def _check_gather(vals, op, node_vals, node_mask, add) -> None:
    """The arguments of :func:`segment_reduce_sorted`'s gather form."""
    if op != "min":
        raise ValueError(f"the gather form reduces by min, got op {op!r}")
    _check_1d("vals", vals, (torch.int32,))
    _check_1d("node_vals", node_vals, _DTYPE_CODE)
    if node_mask is None:
        raise ValueError("the gather form needs node_mask")
    _check_1d("node_mask", node_mask, (torch.bool,))
    if node_mask.shape != node_vals.shape:
        raise ValueError(f"node_mask shape {tuple(node_mask.shape)} != "
                         f"node_vals shape {tuple(node_vals.shape)}")
    tensors = [node_vals, node_mask]
    if add is not None:
        _check_1d("add", add, (node_vals.dtype,))
        if add.shape != vals.shape:
            raise ValueError(f"add shape {tuple(add.shape)} != vals shape "
                             f"{tuple(vals.shape)}")
        tensors.append(add)
    for t in tensors:
        if t.device != vals.device:
            raise ValueError(f"node tables on {t.device}, vals on "
                             f"{vals.device}")


def _gather_launch(lib, stream, ids, offsets, n_out, node_vals, node_mask,
                   add) -> torch.Tensor:
    """One launch of the gather form on the card (arguments checked).  The
    kernel reads ``ids`` and ``add`` 16 bytes at a time: a view that is not
    16-byte aligned is copied first."""
    out = torch.empty(n_out, dtype=node_vals.dtype, device=ids.device)
    if n_out == 0:
        return out
    if ids.data_ptr() % 16:
        ids = ids.clone()
    if add is not None and add.data_ptr() % 16:
        add = add.clone()
    n_vals = ids.numel()
    n_tiles = max(1, -(-n_vals // lib.gm_segment_reduce_tile_size()))
    n_chunks = -(-(offsets.numel() - 1) // lib.gm_segment_reduce_row_chunk())
    # one lane's scratch, then the summary of the flags
    scratch = torch.empty(2 * n_tiles + 1 + n_chunks
                          + lib.gm_segment_reduce_gather_scratch(),
                          dtype=torch.int64, device=ids.device)
    with torch.cuda.device(ids.device):
        err = lib.gm_segment_reduce_gather(
            ids.data_ptr(), n_vals, offsets.data_ptr(), offsets.numel() - 1,
            n_out, out.data_ptr(), scratch.data_ptr(), node_vals.data_ptr(),
            node_mask.data_ptr(), node_vals.numel(),
            None if add is None else add.data_ptr(),
            _DTYPE_CODE[node_vals.dtype], stream)
    if err:
        raise RuntimeError(f"gm_segment_reduce_gather: CUDA error {err}")
    _count("segment_reduce_sorted", gather=True)
    return out


# ---------------------------------------------------------------------------
# Prefix sum
# ---------------------------------------------------------------------------

def plain_cumsum_ref(vals: torch.Tensor,
                     exclusive: bool = False) -> torch.Tensor:
    """Plain version of :func:`plain_cumsum`.  ``dtype=`` keeps int32 in
    int32 (``torch.cumsum`` would promote it to int64), so it wraps too.
    Rows of ``[B, n]`` values are scanned alike."""
    c = torch.cumsum(vals, -1, dtype=vals.dtype)
    return torch.cat([c.new_zeros(tuple(c.shape[:-1]) + (1,)), c], -1) \
        if exclusive else c


def plain_cumsum(vals: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Prefix sum of an int32 or float32 tensor of any length, along its
    last axis: ``[n]``, or ``[B, n]`` lanes scanned in one launch.

    Inclusive: ``out[i] = sum(vals[:i+1])``, ``n`` values.  ``exclusive``:
    ``out[i] = sum(vals[:i])``, ``n + 1`` values (``out[0] = 0``,
    ``out[n]`` the total), written by the kernel directly; with lanes a
    ``[B, n + 1]`` view whose rows lie a multiple of 4 values apart, so
    that each starts 16-byte aligned.  int32 sums are
    exact mod 2^32 (the global prefix may wrap; differences of prefixes
    stay exact), with no bound on chunk sums.  On the card the kernel is a
    single pass with decoupled look-back: tile aggregates are added in an
    order that depends on timing, so float32 results may differ in the
    last bits from run to run (int32 never does).  An input that is not
    16-byte aligned (a view such as ``x[1:]``) is read with 4-byte loads:
    the same result, more slowly.
    """
    _check_1d("vals", vals, _DTYPE_CODE, dims=(1, 2))
    if vals.device.type == "cpu":
        return plain_cumsum_ref(vals, exclusive)
    stream = _cuda_stream(vals)
    lib = _build.lib()
    lanes, n = (1, vals.shape[0]) if vals.dim() == 1 else vals.shape
    m = n + 1 if exclusive else n
    if vals.dim() == 1:
        out = torch.empty(m, dtype=vals.dtype, device=vals.device)
        ld = m
    else:
        ld = -(-m // 4) * 4 if exclusive else m
        out = torch.empty((lanes, ld), dtype=vals.dtype,
                          device=vals.device)[:, :m]
    if n == 0 or lanes == 0:
        return out.zero_()          # the exclusive form's single 0
    # one status word per lane and tile and the tile counter, cleared by
    # the C entry
    scratch = torch.empty(lanes * -(-n // lib.gm_cumsum_tile_size()) + 1,
                          dtype=torch.int64, device=vals.device)
    with torch.cuda.device(vals.device):
        err = lib.gm_cumsum(vals.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), lanes, n, ld,
                            _DTYPE_CODE[vals.dtype], int(exclusive), stream)
    if err:
        raise RuntimeError(f"gm_cumsum: CUDA error {err}")
    _count("plain_cumsum", lanes=vals.dim() == 2)
    return out


plain_cumsum.launches = 0
plain_cumsum.lane_launches = 0


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
    _count("segmented_scan")
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
    _count("take_along_blocks")
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
    _count("row_gather_checksum")
    return zeroed[0]


row_gather_checksum.launches = 0


# ---------------------------------------------------------------------------
# The binned edge map's bitwise OR
# ---------------------------------------------------------------------------

# the bit BFS's plane types (models/batched.py PLANE_DTYPES): the OR and
# the popcount act on bytes, whatever they hold
PLANE_DTYPES = (torch.uint8, torch.int16, torch.int32)
EDGE_MAP_MAX_ROW_BYTES = 512     # a warp's 32 lanes, 16 bytes each


def edge_map_bor_refusal(dtype: torch.dtype, contiguous: bool,
                         row_bytes: int) -> Optional[str]:
    """Why :func:`edge_map_bor`'s kernel cannot take a table of this
    dtype, layout and row width, or None where it can: the one rule that
    the wrapper checks and ``binned.edge_map`` routes by."""
    if dtype not in PLANE_DTYPES:
        return f"dtype {dtype} not in {PLANE_DTYPES}"
    if not contiguous:
        return "tensor is not contiguous"
    if row_bytes % 16 or not 16 <= row_bytes <= EDGE_MAP_MAX_ROW_BYTES:
        return (f"rows of {row_bytes} bytes: the kernel takes 16 to "
                f"{EDGE_MAP_MAX_ROW_BYTES} in a multiple of 16")
    return None


def edge_map_bor_ref(bp, table: torch.Tensor,
                     slot_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`edge_map_bor`: ``ops/binned.py``'s gather of
    each bin's rows (``slot_chunk`` slots at a time), their in-place OR
    fold and the hubs' second stage."""
    from .binned import _edge_map
    return _edge_map(bp, table, "bor", None, None, slot_chunk)


def _bor_table(bp, table: torch.Tensor, name: str = "table") -> int:
    """The checks of :func:`edge_map_bor` and :func:`edge_map_bor_level` on
    a plane; returns its row's bytes."""
    if table.dim() != 2 or table.shape[0] != bp.n_rows:
        raise ValueError(f"{name} must be [n_rows={bp.n_rows}, B], got "
                         f"{tuple(table.shape)}")
    row_bytes = table.shape[1] * table.element_size()
    why = edge_map_bor_refusal(table.dtype, table.is_contiguous(), row_bytes)
    if why:
        raise ValueError(f"{name}: {why}")
    if bp.slot_src.device != table.device:
        raise ValueError(f"schedule on {bp.slot_src.device}, {name} on "
                         f"{table.device}")
    return row_bytes


def _bor_schedule(bp) -> tuple:
    """The schedule's C arguments after the slot ids: the bins' (width,
    count, slot_off, row_off) rows as int64, their count, the hub owners,
    the hub chunks, ``w_max``, the hub chunks' first slot and the hubs'
    first row."""
    flat = [v for row in bp.bins for v in row]
    bins = (ctypes.c_int64 * max(1, len(flat)))(*flat)
    hub_slot_off = bp.slot_src.numel() - bp.n_hub_chunks * bp.w_max
    return (bins, len(bp.bins), bp.hub_owner.data_ptr(), bp.n_hub_chunks,
            bp.w_max, hub_slot_off, bp.hub_row_off)


def edge_map_bor(bp, table: torch.Tensor) -> torch.Tensor:
    """The bitwise-OR edge map of ``binned.edge_map(bp, table, "bor")``.

    ``bp``: a ``binned.BinnedPull`` on ``table``'s device; ``table``:
    [n_rows, B] integer planes that :func:`edge_map_bor_refusal` admits
    (uint8, int16 or int32, contiguous, rows of 16 to 512 bytes in a
    multiple of 16).  Returns [n_rows, B]: per binned row the OR of its
    neighbours' rows, pad and identity rows 0.

    On the card one launch (``csrc/edge_map.cu``) reads each slot's row
    once into registers and writes each output row once; a table that is
    not 16-byte aligned is copied first.  OR is order-free, so the bits are
    the plain version's.  The slot ids must lie in ``[0, n_rows)``, as
    ``build_binned`` makes them: the kernel reads the table there
    unchecked.
    """
    row_bytes = _bor_table(bp, table)
    if table.device.type == "cpu":
        return edge_map_bor_ref(bp, table)
    stream = _cuda_stream(table)
    if table.data_ptr() % 16:
        table = table.clone()
    out = torch.empty_like(table)
    counter = torch.empty(1, dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        err = _build.lib().gm_edge_map_bor(
            table.data_ptr(), bp.n_rows, row_bytes, bp.slot_src.data_ptr(),
            *_bor_schedule(bp), out.data_ptr(), counter.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gm_edge_map_bor: CUDA error {err}")
    _count("edge_map_bor")
    return out


edge_map_bor.launches = 0


def edge_map_bor_level_ref(bp, frontier: torch.Tensor,
                           visited: torch.Tensor,
                           slot_chunk: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`edge_map_bor_level`: the plain edge map,
    then ``hit & ~visited`` on the node rows (0 on the others), ORed into
    ``visited`` in place, and the count of its nonzero node rows."""
    hit = edge_map_bor_ref(bp, frontier, slot_chunk)
    hit &= ~visited
    hit[bp.n_nodes:] = 0
    visited |= hit
    rows = (hit[:bp.n_nodes] != 0).any(1).sum().to(torch.int32)
    return hit, rows


def edge_map_bor_level(bp, frontier: torch.Tensor, visited: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of the bit BFS: ``(next_frontier, rows)``, where
    ``next_frontier`` is ``edge_map_bor(bp, frontier) & ~visited`` on the
    node rows and 0 on the pad and identity rows, ``visited`` is ORed with
    it in place, and ``rows`` (a 0-d int32 tensor on ``frontier``'s
    device) counts its node rows that have a bit set.

    ``frontier`` and ``visited``: [n_rows, B] planes of one dtype that
    :func:`edge_map_bor_refusal` admits; they must not share storage (the
    kernel gathers from the one while it rewrites the other).  On the card
    both must start on a 16-byte boundary, as the planes of
    ``models/batched.py`` do; one launch (``csrc/edge_map.cu``, its level
    form) and one more over the hub rows where the schedule has hubs: the
    edge map, with the update taken into its row writes; ``rows`` is the
    count the loop's predicate reads.  The bits are the plain version's.
    """
    row_bytes = _bor_table(bp, frontier, "frontier")
    _bor_table(bp, visited, "visited")
    if visited.dtype != frontier.dtype or visited.shape != frontier.shape:
        raise ValueError(f"visited is {visited.dtype} "
                         f"{tuple(visited.shape)}, frontier "
                         f"{frontier.dtype} {tuple(frontier.shape)}")
    if (visited.untyped_storage().data_ptr()
            == frontier.untyped_storage().data_ptr()):
        raise ValueError("visited shares storage with frontier")
    if frontier.device.type == "cpu":
        return edge_map_bor_level_ref(bp, frontier, visited)
    for name, t in (("frontier", frontier), ("visited", visited)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    stream = _cuda_stream(frontier)
    out = torch.empty_like(frontier)
    counter = torch.empty(2, dtype=torch.int32, device=frontier.device)
    with torch.cuda.device(frontier.device):
        err = _build.lib().gm_edge_map_bor_level(
            frontier.data_ptr(), bp.n_rows, row_bytes,
            bp.slot_src.data_ptr(), *_bor_schedule(bp), bp.n_nodes,
            visited.data_ptr(), out.data_ptr(), counter.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gm_edge_map_bor_level: CUDA error {err}")
    _count("edge_map_bor_level")
    return out, counter[1]


edge_map_bor_level.launches = 0


# ---------------------------------------------------------------------------
# The bit BFS's final popcount
# ---------------------------------------------------------------------------

POP_CHUNK = 1 << 20     # rows a pass of the plain version expands


def bit_popstats_refusal(dtype: torch.dtype,
                         contiguous: bool) -> Optional[str]:
    """Why :func:`bit_popstats`' kernel cannot take a plane of this dtype
    and layout, or None where it can: the one rule of the wrapper's
    checks."""
    if dtype not in PLANE_DTYPES:
        return f"dtype {dtype} not in {PLANE_DTYPES}"
    if not contiguous:
        return "tensor is not contiguous"
    return None


def bit_popstats_ref(visited: torch.Tensor, deg_rows: torch.Tensor,
                     chunk: int = POP_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bit_popstats`: per bit of the dtype's width,
    a shift, a mask and two int64 sums over ``chunk`` rows at a time
    (chunking caps the per-bit int64 transients).

    The bit planes are widened to int64 once: torch sums integers into
    int64 and would widen an int32 input itself, on each of the two sums
    (slower on an H100: 509 ms against 467 ms at B=4096, LJ scale)."""
    n_rows, lanes = visited.shape
    bits = torch.iinfo(visited.dtype).bits
    cnt = torch.zeros((lanes, bits), dtype=torch.int64,
                      device=visited.device)
    trav = torch.zeros_like(cnt)
    for s in range(0, n_rows, chunk):
        blk = visited[s:s + chunk]
        dblk = deg_rows[s:s + chunk].to(torch.int64)[:, None]
        for i in range(bits):
            p = ((blk >> i) & 1).to(torch.int64)          # [<=chunk, lanes]
            cnt[:, i] += p.sum(0)
            trav[:, i] += (p * dblk).sum(0)
    return cnt.reshape(-1), trav.reshape(-1)


def bit_popstats(visited: torch.Tensor, deg_rows: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bit BFS's per-instance counts from its final plane:
    ``(cnt, trav)``, each ``[lanes * bits]`` int64 with ``bits`` the
    dtype's width, where instance ``b = lane * bits + bit`` counts the rows
    whose ``bit`` of ``lane`` is set and sums ``deg_rows`` ([n_rows] int32)
    over them, exactly.

    ``visited``: [n_rows, lanes] planes that :func:`bit_popstats_refusal`
    admits (uint8, int16 or int32, contiguous), any lane count; it raises
    on any other.  On the card one memset and one launch
    (``csrc/popstats.cu``) read each plane word and each degree once and
    sum in registers; integer sums are order-free, so the results are the
    plain version's bit for bit.  Rows whose bytes are not a multiple of 4
    are read a byte at a time: the same result, more slowly."""
    if visited.dim() != 2:
        raise ValueError(f"visited must be [n_rows, lanes], got "
                         f"{tuple(visited.shape)}")
    why = bit_popstats_refusal(visited.dtype, visited.is_contiguous())
    if why:
        raise ValueError(f"visited: {why}")
    _check_1d("deg_rows", deg_rows, (torch.int32,))
    if deg_rows.shape[0] != visited.shape[0]:
        raise ValueError(f"deg_rows has {deg_rows.shape[0]} rows, visited "
                         f"{visited.shape[0]}")
    if deg_rows.device != visited.device:
        raise ValueError(f"deg_rows on {deg_rows.device}, visited on "
                         f"{visited.device}")
    if visited.device.type == "cpu":
        return bit_popstats_ref(visited, deg_rows)
    stream = _cuda_stream(visited)
    n_rows, lanes = visited.shape
    bits = torch.iinfo(visited.dtype).bits
    if n_rows == 0 or lanes == 0:
        out = torch.zeros((2, lanes * bits), dtype=torch.int64,
                          device=visited.device)
        return out[0], out[1]
    out = torch.empty((2, lanes * bits), dtype=torch.int64,
                      device=visited.device)       # the C entry clears it
    with torch.cuda.device(visited.device):
        err = _build.lib().gm_bit_popstats(
            visited.data_ptr(), n_rows, lanes * visited.element_size(),
            deg_rows.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gm_bit_popstats: CUDA error {err}")
    _count("bit_popstats")
    return out[0], out[1]


bit_popstats.launches = 0


# ---------------------------------------------------------------------------
# Triangle counting's wedge search
# ---------------------------------------------------------------------------

SEARCH_CHUNK = 1 << 24    # wedges a pass of the plain version tests


def search_steps(dag_begin: torch.Tensor) -> int:
    """The plain search's bisection passes: the bit length of the longest
    DAG row, plus one (one read from the tensor's device)."""
    longest = int(dag_begin.diff().max()) if dag_begin.numel() > 1 else 0
    return max(1, longest.bit_length()) + 1


def triangle_search_refusal(begin_dtype: torch.dtype,
                            dst_dtype: torch.dtype, cum_dtype: torch.dtype,
                            contiguous: bool) -> Optional[str]:
    """Why :func:`triangle_search` cannot take a DAG of these dtypes and
    layout, or None where it can: the one rule of the wrapper's checks."""
    for name, dtype, want in (("dag_begin", begin_dtype, torch.int32),
                              ("dag_dst", dst_dtype, torch.int32),
                              ("pair_cum", cum_dtype, torch.int64)):
        if dtype != want:
            return f"{name} dtype {dtype} is not {want}"
    if not contiguous:
        return "a tensor is not contiguous"
    return None


def triangle_search_ref(dag_begin: torch.Tensor, dag_dst: torch.Tensor,
                        pair_cum: torch.Tensor, num_wedges: int,
                        chunk: int = SEARCH_CHUNK) -> torch.Tensor:
    """Plain version of :func:`triangle_search`, ``chunk`` wedge ids a
    pass: anchor slot i is the last with ``pair_cum[i] <= k``
    (``torch.searchsorted``), the wedge is ``(dag_dst[i], dag_dst[i + 1 +
    k - pair_cum[i]])``, membership :func:`search_steps` vectorised
    bisection steps in row b (``ops/segment.py`` ``row_contains``).  Ids
    from ``pair_cum[-1]`` on are no wedges, as in the kernel."""
    from .segment import row_contains    # segment imports this module
    steps = search_steps(dag_begin)
    num_wedges = min(num_wedges, int(pair_cum[-1]))
    dev = dag_dst.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for k0 in range(0, num_wedges, chunk):
        k = torch.arange(k0, min(k0 + chunk, num_wedges), device=dev)
        i = torch.searchsorted(pair_cum, k, right=True) - 1
        j = i + 1 + k - pair_cum[i]
        total += row_contains(dag_begin, dag_dst, dag_dst[i],
                              dag_dst[j], steps).sum()
    return total


def triangle_search(dag_begin: torch.Tensor, dag_dst: torch.Tensor,
                    pair_cum: torch.Tensor, num_wedges: int,
                    chunk: int = SEARCH_CHUNK) -> torch.Tensor:
    """0-d int64: the wedge ids ``k < num_wedges`` of the degree-ordered
    DAG whose wedge closes a triangle, exactly (:func:`triangle_search_ref`
    gives the wedge of an id; ids from ``pair_cum[-1]``, the DAG's wedge
    total, on count nothing).  ``dag_begin`` [N+1] int32 row offsets,
    ``dag_dst`` [D_pad] int32 rows sorted ascending, ``pair_cum``
    [D_pad+1] int64 wedges anchored before each slot, as
    ``models/triangle.py`` ``DagContext`` holds them; it raises on what
    :func:`triangle_search_refusal` refuses.

    On the card one memset and one launch (``csrc/triangle.cu``): each
    wedge's decode and row bisection in registers, no per-wedge temporary,
    any row length; integer sums are order-free, so the count is the plain
    version's.  No wedge: nothing is launched.  On the CPU the plain
    version, ``chunk`` wedge ids a pass."""
    tensors = (dag_begin, dag_dst, pair_cum)
    why = triangle_search_refusal(dag_begin.dtype, dag_dst.dtype,
                                  pair_cum.dtype,
                                  all(t.is_contiguous() for t in tensors))
    if why:
        raise ValueError(f"triangle_search: {why}")
    if any(t.dim() != 1 for t in tensors) or dag_begin.numel() < 1:
        raise ValueError("triangle_search: expected 1-D tensors and at "
                         "least one row offset")
    if pair_cum.numel() != dag_dst.numel() + 1:
        raise ValueError(f"pair_cum has {pair_cum.numel()} entries, dag_dst "
                         f"{dag_dst.numel()} slots (one more wanted)")
    if {t.device for t in tensors} != {dag_dst.device}:
        raise ValueError("dag_begin, dag_dst and pair_cum on different "
                         "devices")
    if num_wedges < 0:
        raise ValueError(f"num_wedges={num_wedges} < 0")
    if dag_dst.device.type == "cpu":
        return triangle_search_ref(dag_begin, dag_dst, pair_cum, num_wedges,
                                   chunk)
    stream = _cuda_stream(dag_dst)
    if num_wedges == 0 or dag_dst.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=dag_dst.device)
    out = torch.empty(2, dtype=torch.int64,
                      device=dag_dst.device)     # the C entry clears it
    with torch.cuda.device(dag_dst.device):
        err = _build.lib().gm_triangle_search(
            dag_begin.data_ptr(), dag_dst.data_ptr(), dag_dst.numel(),
            pair_cum.data_ptr(), num_wedges, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"gm_triangle_search: CUDA error {err}")
    _count("triangle_search")
    return out[0]


triangle_search.launches = 0


_WRAPPERS = (segment_reduce_sorted, plain_cumsum, segmented_scan,
             take_along_blocks, row_gather_checksum, edge_map_bor,
             edge_map_bor_level, bit_popstats, triangle_search)
_LANE_WRAPPERS = (segment_reduce_sorted, plain_cumsum)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0
    for fn in _LANE_WRAPPERS:
        fn.lane_launches = 0
    _wrapper("segment_reduce_sorted").gather_launches = 0


def launch_counts() -> dict:
    """The launches by wrapper, and under ``"segment_reduce_sorted[gather]"``
    those of the segment reduce's gather form (counted in its wrapper's
    too)."""
    out = {fn.__name__: fn.launches for fn in _WRAPPERS}
    out["segment_reduce_sorted[gather]"] = \
        _wrapper("segment_reduce_sorted").gather_launches
    return out


def lane_launch_counts() -> dict:
    """The lane-batched launches, by ``"<wrapper>[lanes]"``."""
    return {f"{fn.__name__}[lanes]": fn.lane_launches
            for fn in _LANE_WRAPPERS}
