"""Sorted-segment sums through a prefix sum.

Counterpart of ``green_marl_tpu/ops/scan_reduce.py``.  CSC/CSR slot arrays
are sorted by segment, so a segment sum is two gathers of one prefix sum::

    c = exclusive_cumsum(vals)               # one pass over E
    out[v] = c[begin[v+1]] - c[begin[v]]     # two gathers over N

Exact for int32 (the prefix wraps mod 2^32, its differences do not); the
prefix is ``kernels.plain_cumsum(..., exclusive=True)``, the CUDA scan on
the card, which writes the leading 0 itself (no copy of the prefix).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.csr import Graph
from . import kernels


def segment_sum_by_offsets(vals: torch.Tensor, offsets: torch.Tensor,
                           n_out: int) -> torch.Tensor:
    """``out[v] = sum(vals[offsets[v]:offsets[v+1]])``, padded with 0 to
    ``n_out``.  ``vals``: [E_pad]; slots past ``offsets[-1]`` are never
    read back."""
    ex = kernels.plain_cumsum(vals, exclusive=True)
    out = ex.index_select(0, offsets[1:]) - ex.index_select(0, offsets[:-1])
    return torch.nn.functional.pad(out, (0, n_out - out.shape[0]))


def in_nbr_count_true(g: Graph, node_mask_vals: torch.Tensor) -> torch.Tensor:
    """[N_pad] int32: per node, the number of in-neighbours w with
    ``node_mask_vals[w]`` true."""
    vals = node_mask_vals.index_select(0, g.r_node_idx).to(torch.int32)
    return segment_sum_by_offsets(vals, g.r_begin, g.n_pad)


def out_nbr_count_true(g: Graph, node_mask_vals: torch.Tensor) -> torch.Tensor:
    """[N_pad] int32: per node, the number of out-neighbours s with
    ``node_mask_vals[s]`` true."""
    vals = node_mask_vals.index_select(0, g.node_idx).to(torch.int32)
    return segment_sum_by_offsets(vals, g.begin, g.n_pad)


def in_nbr_sum_int(g: Graph, node_vals: torch.Tensor,
                   edge_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact int32 pull-sum over in-edges."""
    x = node_vals.index_select(0, g.r_node_idx)
    if edge_vals is not None:
        x = x * edge_vals.index_select(0, g.e_rev2idx)
    return segment_sum_by_offsets(x, g.r_begin, g.n_pad)
