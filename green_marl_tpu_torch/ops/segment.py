"""Edge-map and segment-reduction operations over a ``Graph``.

Counterpart of ``green_marl_tpu/ops/segment.py``.  Every neighbourhood
operation is a gather over the padded edge arrays followed by a
fixed-order segment reduction; padded slots carry the sentinel id and
route into the junk row, so reductions whose identity is safe need no mask.

"Pull" operations read CSC slots (``r_node_idx`` = sources, sorted by
destination, the reference's ``t.InNbrs``); "push" operations read CSR
slots (``node_idx`` = destinations, sorted by source, ``n.Nbrs``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..graph.csr import Graph
from . import kernels, scan_reduce


def sorted_segment_reduce(vals: torch.Tensor, ids: torch.Tensor,
                          offsets: torch.Tensor, n_out: int,
                          op: str, base: int = 0) -> torch.Tensor:
    """Segment reduction over the sorted runs that ``offsets`` describes.

    Routed by dtype, on whichever device ``vals`` is on:

    * int32 and float32, the types the kernels have: integer add goes
      through the exact prefix-sum path, float add, min and max through the
      segment-reduce kernel (both wrappers take their plain versions for
      CPU tensors and launch or raise for CUDA tensors);
    * float64, int64, int16 and uint8: integer add through
      ``torch.cumsum``, the rest through
      ``kernels.segment_reduce_sorted_ref``, on the CPU and on the card;
    * bool min and max reduce as uint8 and come back bool; a bool sum is
      refused, as ``jax.ops.segment_sum`` refuses it.

    ``vals`` may be [B, E] lanes (a batched compiled program): one launch
    for all of them, [B, n_out] out, by the same dtype rules.  ``base``:
    where ``vals[0]`` sits in a longer slot array (a shard's slab in the
    CSC), so that a float sum on the card gets the whole array's bits
    (``kernels.segment_reduce_sorted``).
    """
    if vals.dtype == torch.bool:
        if op == "add":
            raise TypeError("add does not accept dtype bool")
        return sorted_segment_reduce(vals.to(torch.uint8), ids, offsets,
                                     n_out, op) > 0
    if op == "add" and not vals.dtype.is_floating_point:
        return scan_reduce.segment_sum_by_offsets(vals, offsets, n_out)
    if vals.dtype in kernels.KERNEL_DTYPES:
        return kernels.segment_reduce_sorted(vals, ids, offsets, n_out, op=op,
                                             base=base)
    return kernels.segment_reduce_sorted_ref(vals, ids, offsets, n_out, op)


def sorted_segment_or(words: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Bitwise-OR segment reduction over sorted segment ids.

    ``words``: [E] or [E, W] integer words (bit-packed instance planes);
    ``ids``: [E] ascending.  Returns ``[num_segments(, W)]``; empty segments
    get 0.  Torch has no OR reduction, so this is the doubling scan
    ``kernels.segmented_scan_ref`` with ``|`` as the combine (log2(E)
    passes, on either device), read at each segment's last slot.
    """
    dev = words.device
    out = words.new_zeros((num_segments,) + tuple(words.shape[1:]))
    if words.shape[0] == 0:
        return out
    scanned = kernels.segmented_scan_ref(words, ids, "or")
    off = torch.searchsorted(ids, torch.arange(num_segments + 1, device=dev,
                                               dtype=ids.dtype))
    nonempty = off[1:] > off[:-1]
    out[nonempty] = scanned[off[1:][nonempty] - 1]
    return out


def _unsorted(vals, ids, num_segments, op):
    out = torch.full((num_segments,), kernels.identity(op, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids.long(), vals,
                               {"add": "sum", "min": "amin",
                                "max": "amax"}[op], include_self=True)


def segment_sum(vals, ids, num_segments, sorted_ids=False):
    """Segment sum (``jax.ops.segment_sum``); empty segments 0.
    ``sorted_ids`` is a hint the JAX package passes on; it changes no
    result and is accepted here for the same call sites."""
    return _unsorted(vals, ids, num_segments, "add")


def segment_min(vals, ids, num_segments, sorted_ids=False):
    """Segment min; empty segments get the dtype's max (+inf)."""
    return _unsorted(vals, ids, num_segments, "min")


def segment_max(vals, ids, num_segments, sorted_ids=False):
    """Segment max; empty segments get the dtype's min (-inf)."""
    return _unsorted(vals, ids, num_segments, "max")


# ---------------------------------------------------------------------------
# Pull (in-neighbour) reductions: out[v] = reduce over (w -> v) of f(w, e)
# ---------------------------------------------------------------------------

def pull_edge_values(g: Graph, node_vals: torch.Tensor,
                     edge_vals: Optional[torch.Tensor] = None,
                     combine: Optional[Callable] = None) -> torch.Tensor:
    """[E_pad] values per CSC slot: ``node_vals`` at the source endpoint,
    optionally combined with an edge property given in CSR slot order
    (permuted through ``e_rev2idx``)."""
    x = node_vals.index_select(0, g.r_node_idx)
    if edge_vals is not None:
        w = edge_vals.index_select(0, g.e_rev2idx)
        x = combine(x, w) if combine else x * w
    return x


def in_nbr_sum(g: Graph, node_vals, edge_vals=None, combine=None):
    """``Sum(w: t.InNbrs){ f(w) }`` for every t (e.g. pagerank.gm:12)."""
    vals = pull_edge_values(g, node_vals, edge_vals, combine)
    return sorted_segment_reduce(vals, g.r_node_idx_dst, g.r_begin,
                                 g.n_pad, "add")


def in_nbr_min(g: Graph, node_vals, edge_vals=None, combine=None):
    vals = pull_edge_values(g, node_vals, edge_vals, combine)
    return sorted_segment_reduce(vals, g.r_node_idx_dst, g.r_begin,
                                 g.n_pad, "min")


def in_nbr_max(g: Graph, node_vals, edge_vals=None, combine=None):
    vals = pull_edge_values(g, node_vals, edge_vals, combine)
    return sorted_segment_reduce(vals, g.r_node_idx_dst, g.r_begin,
                                 g.n_pad, "max")


def in_nbr_any(g: Graph, node_mask: torch.Tensor) -> torch.Tensor:
    """``out[v] = Exist(w: v.InNbrs){ node_mask[w] }`` (bool)."""
    vals = node_mask.index_select(0, g.r_node_idx).to(torch.int32)
    return segment_max(vals, g.r_node_idx_dst, g.n_pad, sorted_ids=True) > 0


# ---------------------------------------------------------------------------
# Push (out-neighbour) reductions: out[v] = reduce over (v -> s) of f(s, e)
# ---------------------------------------------------------------------------

def push_edge_values(g: Graph, node_vals: torch.Tensor,
                     edge_vals: Optional[torch.Tensor] = None,
                     combine: Optional[Callable] = None) -> torch.Tensor:
    """[E_pad] values per CSR slot, gathered at the source endpoint."""
    x = node_vals.index_select(0, g.node_idx_src)
    if edge_vals is not None:
        x = combine(x, edge_vals) if combine else x * edge_vals
    return x


def _push_vals(g: Graph, node_vals, edge_vals, combine):
    x = node_vals.index_select(0, g.node_idx)
    if edge_vals is not None:
        x = combine(x, edge_vals) if combine else x * edge_vals
    return x


def out_nbr_sum(g: Graph, node_vals, edge_vals=None, combine=None):
    """``Sum(s: v.Nbrs){ f(s) }``: gather at the destination, reduce by
    source (CSR slots are sorted by source)."""
    return sorted_segment_reduce(_push_vals(g, node_vals, edge_vals, combine),
                                 g.node_idx_src, g.begin, g.n_pad, "add")


def out_nbr_min(g: Graph, node_vals, edge_vals=None, combine=None):
    return sorted_segment_reduce(_push_vals(g, node_vals, edge_vals, combine),
                                 g.node_idx_src, g.begin, g.n_pad, "min")


def scatter_min_to_dst(g: Graph, edge_vals_csr: torch.Tensor) -> torch.Tensor:
    """Push-style ``s.prop min= value`` over CSR slots: an unsorted
    scatter-min keyed by destination."""
    return segment_min(edge_vals_csr, g.node_idx, g.n_pad)


def scatter_sum_to_dst(g: Graph, edge_vals_csr: torch.Tensor) -> torch.Tensor:
    return segment_sum(edge_vals_csr, g.node_idx, g.n_pad)


# ---------------------------------------------------------------------------
# Whole-graph reductions over node properties
# ---------------------------------------------------------------------------

def masked_node_sum(g: Graph, vals: torch.Tensor, where=None):
    mask = g.node_mask() if where is None else g.node_mask() & where
    return torch.where(mask, vals, torch.zeros((), dtype=vals.dtype,
                                               device=vals.device)).sum()


def masked_node_max(g: Graph, vals: torch.Tensor, init, where=None):
    mask = g.node_mask() if where is None else g.node_mask() & where
    return torch.where(mask, vals, torch.full((), init, dtype=vals.dtype,
                                              device=vals.device)).max()


def masked_node_min(g: Graph, vals: torch.Tensor, init, where=None):
    mask = g.node_mask() if where is None else g.node_mask() & where
    return torch.where(mask, vals, torch.full((), init, dtype=vals.dtype,
                                              device=vals.device)).min()


def node_any(g: Graph, mask_vals: torch.Tensor) -> torch.Tensor:
    """``Exist(n: G.Nodes){ p(n) }``."""
    return (mask_vals & g.node_mask()).any()


# ---------------------------------------------------------------------------
# Neighbourhood membership (rows sorted by value: binary search)
# ---------------------------------------------------------------------------

def row_contains(begin: torch.Tensor, values: torch.Tensor,
                 rows: torch.Tensor, targets: torch.Tensor,
                 steps: int) -> torch.Tensor:
    """bool per query: is ``targets[q]`` in the ascending run
    ``values[begin[rows[q]] : begin[rows[q] + 1]]``?

    A host loop of ``steps`` vectorised bisection steps over all queries at
    once (int64 positions); ``steps`` must reach ``bit_length`` of the
    longest row.  Positions past the last slot are clamped for the read
    and masked in the answer.
    """
    rows = rows.long()
    lo = begin[rows].long()
    end = begin[rows + 1].long()
    hi = end
    last = values.numel() - 1
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = active & (values[mid.clamp(max=last)] < targets)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo < end) & (values[lo.clamp(max=last)] == targets)


def has_edge_to(g: Graph, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Vectorised ``HasEdgeTo``: each query binary-searches row ``src`` of
    the CSR (rows are sorted by destination) for ``dst``.  ``src``/``dst``:
    equal-shaped integer tensors of node ids; returns bool."""
    steps = max(1, int(g.num_nodes).bit_length()) + 1
    return row_contains(g.begin, g.node_idx, src, dst, steps)
