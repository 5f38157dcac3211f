"""Sorted-segment sums through a prefix sum.

Counterpart of ``green_marl_tpu/ops/scan_reduce.py``.  CSC/CSR slot arrays
are sorted by segment, so a segment sum is two gathers of one prefix sum::

    c = exclusive_cumsum(vals)               # one pass over E
    out[v] = c[begin[v+1]] - c[begin[v]]     # two gathers over N

Exact for int32 (the prefix wraps mod 2^32, its differences do not); the
prefix is ``kernels.plain_cumsum(..., exclusive=True)``, the CUDA scan on
the card, which writes the leading 0 itself (no copy of the prefix).

The prefix is routed by dtype: int32 and float32, the types the kernel has,
go to ``kernels.plain_cumsum``; every other dtype (int64, float64, int16,
uint8) takes ``torch.cumsum`` on the device the tensor is on.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.csr import Graph
from . import kernels


def segment_sum_by_offsets(vals: torch.Tensor, offsets: torch.Tensor,
                           n_out: int) -> torch.Tensor:
    """``out[v] = sum(vals[offsets[v]:offsets[v+1]])``, padded with 0 to
    ``n_out``.  ``vals``: [E_pad], or [B, E_pad] lanes (one prefix-sum
    launch for all of them, [B, n_out] out); slots past ``offsets[-1]`` are
    never read back."""
    if vals.dtype in kernels.KERNEL_DTYPES:
        ex = kernels.plain_cumsum(vals, exclusive=True)
    else:
        c = torch.cumsum(vals, -1, dtype=vals.dtype)
        ex = torch.cat([c.new_zeros(tuple(c.shape[:-1]) + (1,)), c], -1)
    out = ex.index_select(-1, offsets[1:]) - ex.index_select(-1, offsets[:-1])
    return torch.nn.functional.pad(out, (0, n_out - out.shape[-1]))


def in_nbr_count_true(g: Graph, node_mask_vals: torch.Tensor) -> torch.Tensor:
    """[N_pad] int32: per node, the number of in-neighbours w with
    ``node_mask_vals[w]`` true ([B, N_pad] for [B, N_pad] lanes)."""
    vals = node_mask_vals.index_select(-1, g.r_node_idx).to(torch.int32)
    return segment_sum_by_offsets(vals, g.r_begin, g.n_pad)


def in_nbr_any_fast(g: Graph, node_mask_vals: torch.Tensor) -> torch.Tensor:
    """``Exist(w: v.InNbrs){ mask[w] }`` as count > 0."""
    return in_nbr_count_true(g, node_mask_vals) > 0


def out_nbr_count_true(g: Graph, node_mask_vals: torch.Tensor) -> torch.Tensor:
    """[N_pad] int32: per node, the number of out-neighbours s with
    ``node_mask_vals[s]`` true ([B, N_pad] for [B, N_pad] lanes)."""
    vals = node_mask_vals.index_select(-1, g.node_idx).to(torch.int32)
    return segment_sum_by_offsets(vals, g.begin, g.n_pad)


def out_nbr_any_fast(g: Graph, node_mask_vals: torch.Tensor) -> torch.Tensor:
    return out_nbr_count_true(g, node_mask_vals) > 0


def in_nbr_sum_int(g: Graph, node_vals: torch.Tensor,
                   edge_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact integer pull-sum over in-edges (int32 or int64 values)."""
    x = node_vals.index_select(0, g.r_node_idx)
    if edge_vals is not None:
        x = x * edge_vals.index_select(0, g.e_rev2idx)
    return segment_sum_by_offsets(x, g.r_begin, g.n_pad)
