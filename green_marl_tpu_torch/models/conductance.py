"""Conductance of a cut (``apps/src/conduct.gm:1-16``).

Counterpart of ``green_marl_tpu/models/conductance.py``::

    Din   = Sum(u)(u.member == num){ u.Degree() };
    Dout  = Sum(u)(u.member != num){ u.Degree() };
    Cross = Sum(u)(u.member == num){ Count(j: u.Nbrs)(j.member != num) };
    m = min(Din, Dout);  return m == 0 ? (Cross==0 ? 0 : INF) : Cross/m;

Masked reductions only; the sums are ``torch.int64``.
"""

from __future__ import annotations

import torch

from ..graph.csr import Graph


def conductance(g: Graph, member: torch.Tensor, num) -> torch.Tensor:
    """``member``: [N_pad] integer labels; returns the float32 conductance
    (0-d, on ``g``'s device) of the cut between ``member == num`` and the
    rest."""
    mask = g.node_mask()
    inside = (member == num) & mask
    deg = g.out_degree().long()
    din = torch.where(inside, deg, 0).sum()
    dout = torch.where(mask & ~inside, deg, 0).sum()
    # edge (u -> j) crosses when u is inside and j is a real node outside
    src_in = inside.index_select(0, g.node_idx_src)
    dst_out = ~inside.index_select(0, g.node_idx) & (g.node_idx < g.num_nodes)
    cross = (src_in & dst_out).sum()
    m = torch.minimum(din, dout).to(torch.float32)
    inf = torch.full((), float("inf"), device=g.device)
    return torch.where(m == 0, torch.where(cross == 0, 0.0, inf),
                       cross.to(torch.float32) / m.clamp(min=1.0))
