"""Small analytic procedures: avg_teen_cnt, adamicAdar, potential_friends,
triangle_counting_directed.

Counterpart of ``green_marl_tpu/models/analytics.py``; each docstring cites
the ``.gm`` source it follows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops import scan_reduce
from ..ops import segment as ops


def avg_teen_cnt(g: Graph, age: torch.Tensor,
                 k) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apps/src/avg_teen_cnt.gm``: ``teen_cnt[n]`` = the in-neighbours
    with age in [10, 20), counted through the prefix-sum path; returns
    ``(avg, teen_cnt)``, avg the float32 mean of ``teen_cnt`` over the nodes
    with ``age > k`` (0 where there is none, as the reference's Avg over an
    empty set)."""
    teen = (age >= 10) & (age < 20)
    cnt = scan_reduce.in_nbr_count_true(g, teen)
    sel = (age > k) & g.node_mask()
    num = torch.where(sel, cnt, 0).sum().to(torch.float32)
    den = sel.sum().to(torch.float32)
    return torch.where(den > 0, num / den.clamp(min=1), 0.0), cnt


def adamic_adar_edges(g: Graph, chunk: int = 1 << 16) -> np.ndarray:
    """``apps/src/adamicAdar.gm``: per edge (from -> to), the sum over the
    common out-neighbours n of both ends of ``1 / log(degree(n))``.  Returns
    [E] float32 in CSR slot order.  The pair space (edge, slot of ``from``'s
    row) is walked flat in chunks; float32 sums by ``index_add_``."""
    dev = g.device
    E = g.num_edges
    deg = g.begin.diff().long()
    cum = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg[g.node_idx_src[:E].long()], 0, out=cum[1:])
    total = int(cum[-1])
    acc = torch.zeros(g.e_pad, dtype=torch.float32, device=dev)
    w = 1.0 / torch.log(g.out_degree().to(torch.float32).clamp(min=1.0000001))
    for k0 in range(0, total, chunk):
        k = torch.arange(k0, min(k0 + chunk, total), device=dev)
        e = torch.searchsorted(cum, k, right=True) - 1       # CSR slot
        frm = g.node_idx_src[e].long()
        n = g.node_idx[g.begin[frm].long() + k - cum[e]]     # candidate
        hit = ops.has_edge_to(g, g.node_idx[e], n)
        acc.index_add_(0, e, torch.where(hit, w[n.long()], 0.0))
    return acc[:E].cpu().numpy()


def potential_friends(g: Graph) -> torch.Tensor:
    """``apps/src/potential_friends.gm``: per node v, the 2-hop neighbours w
    (w in N(u), u in N(v), w != v) with no edge v -> w, as a dense
    [N_pad, N_pad] bool matrix: for moderate N."""
    n_pad = g.n_pad
    mask = g.node_mask()
    a = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=g.device)
    a[g.node_idx_src.long(), g.node_idx.long()] = 1.0
    a = a * mask[:, None] * mask[None, :]
    pot = ((a @ a) > 0) & (a == 0)
    pot.fill_diagonal_(False)
    return pot


def triangle_directed_count(g: Graph, chunk: int = 1 << 16) -> int:
    """``apps/src/triangle_counting_directed.gm``: for every v, the ordered
    pairs (u, w) of its out-neighbours with w > u for which the edge u -> w
    or w -> u exists.  The pairs of a row of length d are numbered flat by
    anchor slot i (``base(i) = i * (2d - i - 1) / 2``), inverted by a
    bisection on i."""
    dev = g.device
    deg = g.begin.diff().long()
    cum = torch.zeros(g.num_nodes + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg * (deg - 1) // 2, 0, out=cum[1:])
    total = int(cum[-1])
    if total == 0:
        return 0
    steps = max(1, int(deg.max()).bit_length()) + 1
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for k0 in range(0, total, chunk):
        k = torch.arange(k0, min(k0 + chunk, total), device=dev)
        v = torch.searchsorted(cum, k, right=True) - 1
        off = k - cum[v]
        d = deg[v]
        lo = torch.zeros_like(d)
        hi = (d - 2).clamp(min=0)
        for _ in range(steps):      # the largest i with base(i) <= off
            mid = (lo + hi + 1) >> 1
            go = mid * (2 * d - mid - 1) // 2 <= off
            lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
        row = g.begin[v].long()
        u = g.node_idx[row + lo]
        ww = g.node_idx[row + lo + 1 + off - lo * (2 * d - lo - 1) // 2]
        # rows are sorted by destination, so ww >= u; parallel edges give
        # equal pairs, which the reference's strict > leaves out
        hit = (ww > u) & (ops.has_edge_to(g, u, ww)
                          | ops.has_edge_to(g, ww, u))
        count += hit.sum()
    return int(count)
