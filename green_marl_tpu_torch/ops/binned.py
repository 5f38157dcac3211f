"""Degree-binned batched edge map: the engine of the batched models.

Counterpart of ``green_marl_tpu/ops/binned.py``.  Every neighbourhood
reduction over B batched instances is a gather of *rows* of a node table
``[n_rows, B]`` (instances in the trailing axis) at per-slot indices,
followed by a dense reduction of fixed-width runs: ``.view(cc, W, B)``
reduced along dim 1.

Fixed widths come from degree binning (:func:`build_binned`, host numpy):
nodes are grouped by a ~1.25x ladder of neighbour counts and each node's
slot run is padded to its bin width ``W``; padded slots point at a
dedicated identity row of the table.  Nodes with more than ``w_max``
neighbours ("hubs") get ``ceil(d / w_max)`` chunks of ``w_max`` slots and a
second-stage segment reduction over their chunks.  The node relabelling
lives only in the slot arrays, so the superstep loop never permutes.

The schedule is built on the host and moved to a device with
:meth:`BinnedPull.to`.  ``edge_map`` is plain PyTorch: the JAX package
left it to XLA, and it has no Pallas kernel.  Unlike XLA, eager PyTorch
writes every gathered bin before reducing it; ``slot_chunk`` caps that
transient at ``slot_chunk`` rows with the same results.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..graph.csr import Graph, round_up

# Top bin width: hubs beyond this get chunked + second-stage reduce.
W_MAX = 4096

OPS = ("sum", "min", "max", "or", "bor")


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def op_identity(op: str, dtype) -> np.generic:
    """The identity of ``op`` in ``dtype`` (a numpy or torch dtype)."""
    dtype = _np_dtype(dtype)
    if op in ("sum", "or", "bor"):
        return dtype.type(0)
    big = np.inf if dtype.kind == "f" else np.iinfo(dtype).max
    small = -np.inf if dtype.kind == "f" else np.iinfo(dtype).min
    return dtype.type(big if op == "min" else small)


def _scalar(x):
    return x.item() if isinstance(x, np.generic) else x


_TENSOR_FIELDS = ("slot_src", "slot_edge", "hub_owner", "perm", "inv_perm")


@dataclasses.dataclass(frozen=True)
class BinnedPull:
    """Static slot schedule for one traversal direction of one graph.

    ``slot_src[s]`` is the *binned* row index of the neighbour gathered at
    slot ``s`` (identity row for pads).  Bin ``k`` owns slots
    ``[slot_off_k, slot_off_k + count_k * width_k)`` and produces output
    rows ``[row_off_k, row_off_k + count_k)``.  Hub chunks live at the
    tail of the slot array; ``hub_owner[c]`` is the hub-local output row
    of chunk ``c``.
    """

    slot_src: torch.Tensor   # [S_tot] int32, binned neighbour row per slot
    slot_edge: torch.Tensor  # [S_tot] int32, CSC/CSR slot per slot (pad=e_pad)
    hub_owner: torch.Tensor  # [n_hub_chunks] int32 (hub-local row)
    perm: torch.Tensor       # [N] int32: perm[row] = original node id
    inv_perm: torch.Tensor   # [N] int32: inv_perm[orig] = binned row

    bins: Tuple[Tuple[int, int, int, int], ...]  # (width, count, slot_off, row_off)
    n_nodes: int
    n_rows: int
    n_hub: int
    hub_row_off: int
    n_hub_chunks: int
    e_pad: int
    w_max: int

    @property
    def ident_row(self) -> int:
        """Row index of the dedicated identity row."""
        return self.n_rows - 1

    @property
    def device(self) -> torch.device:
        return self.slot_src.device

    def to(self, device, with_edges: bool = True) -> "BinnedPull":
        """The schedule with every tensor on ``device`` (the JAX package's
        ``device_put_lite``).  With ``with_edges=False``, ``slot_edge``
        (needed only for edge-weighted maps, and as large as ``slot_src``)
        is left behind as an empty sentinel, so that
        :func:`edge_slot_vals` fails loudly on it."""
        moved = {f: getattr(self, f).to(device) for f in _TENSOR_FIELDS
                 if f != "slot_edge"}
        moved["slot_edge"] = (self.slot_edge.to(device) if with_edges else
                              torch.zeros(0, dtype=torch.int32,
                                          device=device))
        return dataclasses.replace(self, **moved)

    # ---- table management -------------------------------------------------
    def make_table(self, rows_binned: torch.Tensor, ident) -> torch.Tensor:
        """Pad a [n_nodes, B] binned array into a [n_rows, B] table with
        pad + identity rows set to ``ident``."""
        out = torch.full((self.n_rows, rows_binned.shape[1]), _scalar(ident),
                         dtype=rows_binned.dtype, device=rows_binned.device)
        out[:rows_binned.shape[0]] = rows_binned
        return out

    def pin_identity(self, table: torch.Tensor, ident) -> torch.Tensor:
        """Restore pad/identity rows after an elementwise table update."""
        return torch.where(self.node_rows_mask(table.device), table,
                           torch.full((), _scalar(ident), dtype=table.dtype,
                                      device=table.device))

    def node_rows_mask(self, device=None) -> torch.Tensor:
        """[n_rows, 1] bool -- True for real node rows."""
        device = self.device if device is None else device
        return (torch.arange(self.n_rows, device=device)
                < self.n_nodes)[:, None]

    def to_binned(self, x: torch.Tensor) -> torch.Tensor:
        """Reorder a node-indexed array ([N_any, ...]) into binned row
        order ([n_nodes, ...]).  One row gather: use at algorithm entry
        only, not inside the superstep loop."""
        return x.index_select(0, self.perm.to(x.device))

    def from_binned(self, rows: torch.Tensor) -> torch.Tensor:
        """Inverse of ``to_binned`` (algorithm exit)."""
        return rows.index_select(0, self.inv_perm.to(rows.device))


def build_binned(offsets: np.ndarray, neigh: np.ndarray,
                 num_nodes: int, e_pad: int,
                 w_max: int = W_MAX) -> BinnedPull:
    """Host-side construction of the slot schedule from a CSC/CSR view.

    ``offsets``: [N+1]; ``neigh``: [>=offsets[-1]] neighbour per slot.
    Direction semantics are the caller's: pass (r_begin, r_node_idx) for
    in-neighbour pulls, (begin, node_idx) for out-neighbour pulls.  The
    tensors of the result lie on the CPU.
    """
    offsets = np.asarray(offsets)
    neigh = np.asarray(neigh)
    N = int(num_nodes)
    deg = np.diff(offsets[:N + 1]).astype(np.int64)

    # width ladder with ~1.25x steps (1,2,3,4,5,7,9,11,... w_max): slot
    # padding ~1.10x E at LJ scale against ~1.55x for powers of two
    lad = set()
    w = 1.0
    while w <= w_max:
        lad.add(int(np.ceil(w)))
        w *= 1.25
    lad.add(int(w_max))
    ladder = sorted(lad)
    lad = np.asarray(ladder, np.int64)
    cls = np.searchsorted(lad, np.maximum(deg, 1)).astype(np.int32)
    max_cls = len(ladder) - 1
    is_hub = deg > w_max

    # binned order: non-hubs grouped by class ascending, hubs last;
    # stable within groups (original id ascending)
    sort_key = np.where(is_hub, max_cls + 1, cls)
    order = np.argsort(sort_key, kind="stable").astype(np.int32)
    inv_order = np.empty(N, np.int32)
    inv_order[order] = np.arange(N, dtype=np.int32)

    n_hub = int(is_hub.sum())
    n_rows = round_up(N + 1, 8)
    ident_row = n_rows - 1

    # map neighbour original id -> binned row (graph sentinel id N -> ident)
    nbr_map = np.empty(N + 1, np.int32)
    nbr_map[:N] = inv_order
    nbr_map[N] = ident_row

    slot_src_parts = []
    slot_edge_parts = []
    bins = []
    slot_off = 0
    row_off = 0
    sorted_key = sort_key[order]
    for k in range(max_cls + 1):
        W = ladder[k]
        sel = order[sorted_key == k]
        cnt = int(sel.shape[0])
        if cnt == 0:
            continue          # zero-count bins stay out of the schedule
        base = offsets[sel].astype(np.int64)
        d = deg[sel]
        pos = np.arange(W, dtype=np.int64)[None, :]
        eidx = base[:, None] + pos                      # [cnt, W]
        valid = pos < d[:, None]
        eidx_c = np.where(valid, eidx, 0)
        srcs = np.where(valid, neigh[eidx_c], N)        # sentinel when pad
        slot_src_parts.append(nbr_map[srcs].ravel())
        slot_edge_parts.append(
            np.where(valid, eidx, e_pad).astype(np.int32).ravel())
        bins.append((W, cnt, slot_off, row_off))
        slot_off += cnt * W
        row_off += cnt

    # hubs: chunked at w_max
    hub_sel = order[sorted_key == max_cls + 1]
    hub_row_off = row_off
    if n_hub:
        d = deg[hub_sel]
        chunks = ((d + w_max - 1) // w_max).astype(np.int64)
        n_chunks = int(chunks.sum())
        owner = np.repeat(np.arange(n_hub, dtype=np.int32), chunks)
        # chunk-local base offset within each hub's run
        chunk_pos = (np.arange(n_chunks, dtype=np.int64)
                     - np.repeat(np.cumsum(chunks) - chunks, chunks))
        base = offsets[hub_sel].astype(np.int64)
        cbase = np.repeat(base, chunks) + chunk_pos * w_max
        limit = np.repeat(base + d, chunks)
        pos = np.arange(w_max, dtype=np.int64)[None, :]
        eidx = cbase[:, None] + pos
        valid = eidx < limit[:, None]
        eidx_c = np.where(valid, eidx, 0)
        srcs = np.where(valid, neigh[eidx_c], N)
        slot_src_parts.append(nbr_map[srcs].ravel())
        slot_edge_parts.append(
            np.where(valid, eidx, e_pad).astype(np.int32).ravel())
        hub_owner = owner
    else:
        n_chunks = 0
        hub_owner = np.zeros(0, np.int32)

    slot_src = (np.concatenate(slot_src_parts) if slot_src_parts
                else np.zeros(0, np.int32)).astype(np.int32)
    slot_edge = (np.concatenate(slot_edge_parts) if slot_edge_parts
                 else np.zeros(0, np.int32)).astype(np.int32)
    return BinnedPull(
        slot_src=torch.from_numpy(slot_src),
        slot_edge=torch.from_numpy(slot_edge),
        hub_owner=torch.from_numpy(hub_owner.astype(np.int32)),
        perm=torch.from_numpy(order),
        inv_perm=torch.from_numpy(inv_order),
        bins=tuple(bins),
        n_nodes=N,
        n_rows=n_rows,
        n_hub=n_hub,
        hub_row_off=hub_row_off,
        n_hub_chunks=n_chunks,
        e_pad=int(e_pad),
        w_max=int(w_max),
    )


def binned_in(g: Graph, w_max: int = W_MAX) -> BinnedPull:
    """Pull over in-neighbours (CSC): out[v] = reduce over {w : w->v}."""
    return build_binned(g.r_begin.cpu().numpy(), g.r_node_idx.cpu().numpy(),
                        g.num_nodes, g.e_pad, w_max)


def binned_out(g: Graph, w_max: int = W_MAX) -> BinnedPull:
    """Pull over out-neighbours (CSR): out[v] = reduce over {w : v->w}."""
    return build_binned(g.begin.cpu().numpy(), g.node_idx.cpu().numpy(),
                        g.num_nodes, g.e_pad, w_max)


# ---------------------------------------------------------------------------
# The edge map
# ---------------------------------------------------------------------------

def _bor_fold(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of ``x`` [cc, W, B] along dim 1, folded in place.

    Torch has no OR reduction.  Each fold ORs the top ``W // 2`` columns
    onto the bottom ones, which do not overlap; an odd ``W`` keeps its
    middle column as it is.  log2(W) in-place passes, no extra memory.
    """
    w = x.shape[1]
    while w > 1:
        h = w // 2
        x[:, :h].bitwise_or_(x[:, w - h:w])
        w -= h
    return x[:, 0]


def _reduce(rows: torch.Tensor, op: str, dtype: torch.dtype) -> torch.Tensor:
    """Reduce [cc, W, B] along dim 1 (``rows`` may be overwritten)."""
    if op == "sum":
        return rows.sum(1, dtype=dtype)
    if op == "min":
        return rows.amin(1)
    if op in ("max", "or"):          # "or": boolean OR as max over {0, 1}
        return rows.amax(1)
    return _bor_fold(rows)


def _gather(bp: BinnedPull, table: torch.Tensor, s0: int, n: int,
            slot_vals: Optional[torch.Tensor], combine) -> torch.Tensor:
    rows = table.index_select(0, bp.slot_src[s0:s0 + n])
    if slot_vals is not None:
        w = slot_vals[s0:s0 + n]
        rows = combine(rows, w if w.dim() > 1 else w[:, None])
    return rows


def _hub_part(chunk_red: torch.Tensor, owners: torch.Tensor, n_hub: int,
              op: str) -> torch.Tensor:
    """Second stage: reduce chunk results into their hubs' rows."""
    B = chunk_red.shape[1]
    dtype = chunk_red.dtype
    idx = owners.long()[:, None].expand(-1, B)
    if op == "bor":
        # bitwise OR across chunks: a segment max of each bit plane
        bits = torch.iinfo(dtype).bits
        acc = torch.zeros((n_hub, B), dtype=dtype, device=chunk_red.device)
        for i in range(bits):
            plane = (chunk_red >> i) & 1
            m = torch.zeros_like(acc).scatter_reduce_(
                0, idx, plane, "amax", include_self=True)
            acc |= m << i
        return acc
    # segment_sum / segment_min / segment_max, with their empty-segment
    # values: 0, the dtype's max (+inf), the dtype's min (-inf)
    seg_op = {"sum": "sum", "min": "min", "or": "max", "max": "max"}[op]
    init = op_identity(seg_op, dtype).item()
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[seg_op]
    out = torch.full((n_hub, B), init, dtype=dtype, device=chunk_red.device)
    return out.scatter_reduce_(0, idx, chunk_red, reduce, include_self=True)


_COMBINE2 = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
             "or": torch.maximum, "bor": torch.bitwise_or}


def edge_map(bp: BinnedPull, table: torch.Tensor, op: str = "sum",
             slot_vals: Optional[torch.Tensor] = None,
             combine: Optional[Callable] = None,
             slot_chunk: Optional[int] = None) -> torch.Tensor:
    """Batched neighbourhood reduction.

    ``table``: [n_rows, B] node table in binned order with identity rows
    maintained (see ``make_table`` / ``pin_identity``).  ``op``: sum, min,
    max, or (boolean OR as max over {0, 1}) or bor (bitwise OR of integer
    bit planes).
    ``slot_vals``: optional [S_tot] or [S_tot, B] per-slot values (e.g.
    edge weights laid out by ``edge_slot_vals``) combined into the
    gathered rows with ``combine`` (default: add for min/max --
    relaxation -- and multiply otherwise).
    ``slot_chunk``: optional cap on the slots gathered at once; larger
    bins split along the node axis.  The results do not change.

    Returns a new [n_rows, B] table: per binned node, the ``op``
    reduction over its neighbours' table rows; pad/identity rows hold the
    op identity.
    """
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if table.dim() != 2 or table.shape[0] != bp.n_rows:
        raise ValueError(f"table must be [n_rows={bp.n_rows}, B], got "
                         f"{tuple(table.shape)}")
    if op == "bor" and table.dtype.is_floating_point:
        raise TypeError("op 'bor' needs an integer table")
    B = table.shape[1]
    dtype = table.dtype
    if combine is None:
        combine = (lambda x, w: x + w) if op in ("min", "max") \
            else (lambda x, w: x * w)
    out = torch.full((bp.n_rows, B), op_identity(op, dtype).item(),
                     dtype=dtype, device=table.device)

    for (W, cnt, soff, roff) in bp.bins:
        cnt_ch = cnt
        if slot_chunk is not None and cnt * W > slot_chunk:
            cnt_ch = max(slot_chunk // W, 1)
        for c0 in range(0, cnt, cnt_ch):
            cc = min(cnt_ch, cnt - c0)
            rows = _gather(bp, table, soff + c0 * W, cc * W, slot_vals,
                           combine)
            out[roff + c0:roff + c0 + cc] = _reduce(rows.view(cc, W, B), op,
                                                    dtype)

    if bp.n_hub_chunks:
        wm = bp.w_max
        soff0 = int(bp.slot_src.shape[0]) - bp.n_hub_chunks * wm
        h_ch = bp.n_hub_chunks
        if slot_chunk is not None and h_ch * wm > slot_chunk:
            h_ch = max(slot_chunk // wm, 1)
        hub_acc = None
        for h0 in range(0, bp.n_hub_chunks, h_ch):
            hc = min(h_ch, bp.n_hub_chunks - h0)
            rows = _gather(bp, table, soff0 + h0 * wm, hc * wm, slot_vals,
                           combine)
            chunk_red = _reduce(rows.view(hc, wm, B), op, dtype)
            part = _hub_part(chunk_red, bp.hub_owner[h0:h0 + hc], bp.n_hub,
                             op)
            # hub segments may span slot chunks: combine partials with
            # the op itself (associative)
            hub_acc = part if hub_acc is None else _COMBINE2[op](hub_acc,
                                                                 part)
        out[bp.hub_row_off:bp.hub_row_off + bp.n_hub] = hub_acc
    return out


GATHER_BUDGET = 4 << 30   # bytes of gathered rows one edge_map step may hold


def slot_chunk_for(row_bytes: int) -> int:
    """The ``slot_chunk`` that keeps one gather of ``row_bytes`` rows
    within ``GATHER_BUDGET`` (4 GiB)."""
    return max(1, GATHER_BUDGET // max(1, row_bytes))


def to_arrays(bp: BinnedPull) -> dict:
    """Flatten to a dict of numpy arrays for ``np.savez``: build the
    schedule once, reload it per run."""
    d = {f: getattr(bp, f).cpu().numpy() for f in _TENSOR_FIELDS}
    d["bins"] = np.asarray(bp.bins, np.int64).reshape(-1, 4)
    d["meta"] = np.asarray([bp.n_nodes, bp.n_rows, bp.n_hub,
                            bp.hub_row_off, bp.n_hub_chunks, bp.e_pad,
                            bp.w_max], np.int64)
    return d


def from_arrays(d) -> BinnedPull:
    """Inverse of :func:`to_arrays`; the tensors lie on the CPU."""
    meta = [int(x) for x in np.asarray(d["meta"])]
    return BinnedPull(
        **{f: torch.from_numpy(np.array(d[f], np.int32))
           for f in _TENSOR_FIELDS},
        bins=tuple(tuple(int(v) for v in row)
                   for row in np.asarray(d["bins"])),
        n_nodes=meta[0], n_rows=meta[1], n_hub=meta[2],
        hub_row_off=meta[3], n_hub_chunks=meta[4], e_pad=meta[5],
        w_max=meta[6])


def edge_slot_vals(bp: BinnedPull, edge_vals: torch.Tensor,
                   pad_val) -> torch.Tensor:
    """Lay an [e_pad(+1)]-indexed edge property out in slot order
    ([S_tot]).  Build once per run (static layout)."""
    if bp.slot_edge.shape[0] != bp.slot_src.shape[0]:
        raise ValueError(
            "edge values requested on a 'lite' schedule (slot_edge was "
            "skipped at transfer); move it with "
            "bp.to(device, with_edges=True)")
    ev = torch.cat([edge_vals, torch.full((1,), pad_val,
                                          dtype=edge_vals.dtype,
                                          device=edge_vals.device)])
    idx = bp.slot_edge.clamp(max=edge_vals.shape[0])
    return ev.index_select(0, idx)
