"""Strongly connected components (kosaraju.gm / tarjan_scc.gm).

Counterpart of ``green_marl_tpu/models/scc.py``: the coloring /
forward-backward decomposition (Orzan; FW-BW of Fleischer et al.) in place
of the reference's sequential DFS algorithms.  Repeat until every node is
assigned:

1. colour fixpoint: within the unassigned nodes, ``color[v] = max(color of
   in-neighbours)``, so every node ends with the largest id that reaches
   it;
2. each colour root r (``color[r] == r``) takes, within its colour, every
   node that reaches r backward: that is r's SCC;
3. assign those SCCs and remove them.

Both fixpoints are masked edge maps through ``ops.sorted_segment_reduce``
(int32 max: the segment-reduce kernel on the card), one host loop each
over ``engine.superstep.while_loop``.  ``comp[v]`` is the SCC's smallest
member id (the reference numbers components in traversal order; the
partition is the same).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops

INT32_MAX = torch.iinfo(torch.int32).max


class SCCResult(NamedTuple):
    comp: torch.Tensor  # [N_pad] int32, min member id per SCC; -1 pad
    rounds: int         # outer rounds


def scc(g: Graph, max_rounds: Optional[int] = None) -> SCCResult:
    """``max_rounds`` bounds the outer loop and each of its two fixpoints,
    as in the JAX version."""
    n_pad = g.n_pad
    mask = g.node_mask()
    ids = torch.arange(n_pad, dtype=torch.int32, device=g.device)
    none = torch.full((), -1, dtype=torch.int32, device=g.device)
    if max_rounds is None:
        max_rounds = g.num_nodes + 1

    def color_fixpoint(unassigned):
        src_ok = unassigned.index_select(0, g.r_node_idx)

        def step(state):
            color, _ = state
            # pull: max over the in-neighbours' colours
            src_c = torch.where(src_ok, color.index_select(0, g.r_node_idx),
                                none)
            best = ops.sorted_segment_reduce(src_c, g.r_node_idx_dst,
                                             g.r_begin, n_pad, "max")
            new = torch.where(unassigned, torch.maximum(color, best), color)
            return new, (new != color).any()

        color0 = torch.where(unassigned, ids, none)
        (color, _), _ = while_loop(step, lambda s: s[1], (color0, True),
                                   max_rounds)
        return color

    def backward_within_color(color, unassigned):
        """Every node that reaches its colour root backward, within its
        colour; all colours at once."""
        # v joins if an out-neighbour w is a member of the same colour
        same = (color.index_select(0, g.node_idx)
                == color.index_select(0, g.node_idx_src))

        def step(state):
            member, _ = state
            w_ok = member.index_select(0, g.node_idx) & same
            hit = ops.sorted_segment_reduce(w_ok.to(torch.int32),
                                            g.node_idx_src, g.begin, n_pad,
                                            "max") > 0
            new = member | (hit & unassigned)
            return new, (new != member).any()

        member0 = unassigned & (color == ids)
        (member, _), _ = while_loop(step, lambda s: s[1], (member0, True),
                                    max_rounds)
        return member

    def outer_step(state):
        comp, unassigned = state
        color = color_fixpoint(unassigned)
        member = backward_within_color(color, unassigned)
        return torch.where(member, color, comp), unassigned & ~member

    comp0 = torch.full((n_pad,), -1, dtype=torch.int32, device=g.device)
    (comp, _), stats = while_loop(outer_step, lambda s: s[1].any(),
                                  (comp0, mask), max_rounds)

    # canonicalise: each component's id becomes its smallest member id.
    # Nodes a max_rounds cut left at -1 index from the end, as JAX's
    # .at[-1] does
    rep = torch.full((n_pad,), INT32_MAX, dtype=torch.int32, device=g.device)
    idx = torch.where(mask, comp, n_pad - 1).long().remainder(n_pad)
    rep.scatter_reduce_(0, idx,
                        torch.where(mask, ids, INT32_MAX), "amin",
                        include_self=True)
    comp = torch.where(mask, rep.index_select(0, comp.clamp(0, n_pad - 1)),
                       none)
    return SCCResult(comp=comp, rounds=stats.iterations)


def scc_np(begin, node_idx):
    """Host oracle: Tarjan (iterative), canonicalised to min member id."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    index = np.full(N, -1)
    low = np.zeros(N, dtype=np.int64)
    on_stack = np.zeros(N, bool)
    comp = np.full(N, -1)
    stack: list = []
    counter = 0

    for root in range(N):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            row = node_idx[begin[v]:begin[v + 1]]
            for k in range(pi, len(row)):
                w = row[k]
                if index[w] == -1:
                    work[-1] = (v, k + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                members = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    members.append(w)
                    if w == v:
                        break
                comp[members] = min(members)
            work.pop()
            if work:
                p, _ = work[-1]
                low[p] = min(low[p], low[v])
    return comp
