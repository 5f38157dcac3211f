"""Community detection by label propagation (``apps/src/communities.gm``).

Counterpart of ``green_marl_tpu/models/communities.py``.  Reference
semantics: each node counts the community labels of its out-neighbours in a
``Map<Node, Int>`` and adopts ``T.GetMaxKey()`` unless its own label already
has the maximal count (``T.HasMaxValue(x.Comm)``).

A superstep sorts the (source node, neighbour label) pairs, run-length
encodes them and reduces per source:

* the sort key ``src * n_pad + label`` is ``torch.int64``: one
  ``torch.sort`` over E a step;
* a run's length is the count of its (source, label) pair;
* per source, two ``max`` segment reductions: the largest count with its
  smallest label (ties are normalised that way; the reference's hash-map
  order is unspecified), encoded ``count * n_pad + (n_pad - 1 - label)``,
  and the count of the node's own label.  The encoding is int32, and the
  reductions run in the segment-reduce kernel on the card, where
  ``(max out-degree + 1) * n_pad`` fits int32; otherwise it is int64 and
  they take the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..engine.superstep import converge_loop
from ..graph.csr import Graph
from ..ops import segment as ops


# an encoded (count, label) pair up to this bound stays int32 (the kernel's
# type); a module constant so that tests can reach the int64 route
_ENC_LIMIT = 2 ** 31


class CommunitiesResult(NamedTuple):
    comm: torch.Tensor   # [N_pad] int32 node label; -1 on padding
    iterations: int


def communities(g: Graph, max_iter: int = 100) -> CommunitiesResult:
    dev = g.device
    n_pad = g.n_pad
    mask = g.node_mask()
    ids = torch.arange(n_pad, dtype=torch.int32, device=dev)
    comm0 = torch.where(mask, ids, n_pad - 1)
    e_src = g.node_idx_src.long()
    e_dst = g.node_idx.long()
    idx = torch.arange(g.e_pad, dtype=torch.int32, device=dev)
    max_deg = int(g.begin.diff().max()) if g.num_nodes else 0
    enc_t = (torch.int32 if (max_deg + 1) * n_pad < _ENC_LIMIT else torch.int64)

    def step(state):
        comm, _ = state
        lbl = torch.where(e_dst < g.num_nodes, comm[e_dst], n_pad - 1)
        skey = torch.sort(e_src * n_pad + lbl).values
        s_src = skey // n_pad
        s_lbl = (skey % n_pad).to(torch.int32)
        brk = skey[1:] != skey[:-1]
        first = torch.cat([brk.new_ones(1), brk])
        last = torch.cat([brk, brk.new_ones(1)])
        # position within the run; a run's count stands at its last slot
        run_len = idx - torch.cummax(torch.where(first, idx, -1), 0).values + 1
        at = last & (s_src < g.num_nodes)
        enc = torch.where(at & (s_lbl < n_pad - 1),
                          run_len.to(enc_t) * n_pad + (n_pad - 1 - s_lbl), 0)
        best = ops.sorted_segment_reduce(enc, s_src, g.begin, n_pad, "max")
        best_cnt = (best // n_pad).to(torch.int32)
        best_lbl = ((n_pad - 1) - best % n_pad).to(torch.int32)
        # HasMaxValue(x.Comm): keep the label whose count is the maximum
        own = s_lbl == comm[s_src.clamp(max=n_pad - 1)]
        cur_cnt = ops.sorted_segment_reduce(
            torch.where(at & own, run_len, 0), s_src, g.begin, n_pad, "max")
        take_new = (best_cnt > 0) & (cur_cnt < best_cnt) & mask
        new = torch.where(take_new, best_lbl, comm)
        return new, (new == comm).all()

    (comm, _), stats = converge_loop(
        step, lambda st: ~st[1],
        (comm0, torch.zeros((), dtype=torch.bool, device=dev)), max_iter)
    return CommunitiesResult(comm=torch.where(mask, comm, -1),
                             iterations=stats.iterations)


def communities_np(begin, node_idx, max_iter=100):
    """Host oracle with the same tie-break."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    comm = np.arange(N)
    for _ in range(max_iter):
        changed = False
        new = comm.copy()
        for x in range(N):
            nbrs = node_idx[begin[x]:begin[x + 1]]
            if len(nbrs) == 0:
                continue
            cnt = {}
            for y in nbrs:
                cnt[comm[y]] = cnt.get(comm[y], 0) + 1
            mx = max(cnt.values())
            if cnt.get(comm[x], 0) == mx:
                continue
            new[x] = min(l for l, c in cnt.items() if c == mx)
            changed = True
        comm = new
        if not changed:
            break
    return comm
