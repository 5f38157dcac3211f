"""Direction-optimizing level-synchronous BFS.

Counterpart of ``green_marl_tpu/models/bfs.py`` (the reference's BFS
template, ``gm_bfs_template.h:14-756``).  Each level takes one of two
directions, chosen on the host from the frontier's out-edge count:

* top-down ("push", the reference's ST_QUE): compact the frontier, enumerate
  its CSR slots into an edge buffer of a fixed budget (4K/64K/1M/2M tiers,
  as in the JAX version) and mark the destinations.  The work follows the
  budget, not E;
* bottom-up ("pull", ST_RD): every node counts its in-neighbours in the
  frontier with one sweep over all edges, through the prefix-sum kernel on
  the card.  Taken when the frontier's out-edges overflow every tier.

``reverse=True`` runs the same over the transposed graph: the push reads
the CSC (``r_begin``/``r_node_idx``), the pull the CSR.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import scan_reduce
from ..utils.timing import span

PUSH_TIERS = (4096, 65536, 1 << 20, 1 << 21)


class BfsResult(NamedTuple):
    level: torch.Tensor  # [N_pad] int32, -1 = unreached
    levels_run: int      # number of levels expanded
    reached: int         # total reached node count


def _push_expand(g: Graph, frontier: torch.Tensor, push_begin: torch.Tensor,
                 push_nbr: torch.Tensor, e_cap: int) -> torch.Tensor:
    """Top-down expansion within an edge budget of ``e_cap`` slots.

    Sort the masked ids to compact the frontier, mark each frontier node's
    run start in the slot buffer, propagate run owners with ``cummax``,
    then gather the destinations and set ``hit`` there.  Work is
    O(n_pad + e_cap).

    Where the JAX version drops marks and dead slots (``mode="drop"``, or
    the one junk row), each gets a junk slot of its own past the buffer's
    end: millions of atomics on one word took ~58 ms a level on an H100.
    The run starts are distinct and every ``hit`` write is ``True``, so
    plain stores do, with no atomics at all.
    """
    n_pad, N = g.n_pad, g.num_nodes
    dev = frontier.device
    pos = torch.arange(n_pad, dtype=torch.int32, device=dev)
    ids = torch.sort(torch.where(frontier, pos, n_pad)).values
    valid = ids < N
    idc = ids.clamp(max=N - 1)
    deg = torch.where(valid, push_begin[idc + 1] - push_begin[idc], 0)
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    total = cum[-1]                     # the frontier's out-edges
    start = cum - deg                   # run start of each frontier position
    kept = valid & (deg > 0) & (start < e_cap)
    marks = torch.zeros(e_cap + n_pad, dtype=torch.int32, device=dev)
    marks[torch.where(kept, start, e_cap + pos).long()] = pos + 1
    owner = (torch.cummax(marks[:e_cap], 0).values - 1).clamp(min=0)
    i = torch.arange(e_cap, dtype=torch.int32, device=dev)
    base = push_begin[idc[owner]]
    slot = (base + i - start[owner]).clamp(0, g.e_pad - 1)
    live = i < torch.clamp(total, max=e_cap)
    dst = push_nbr.index_select(0, slot)
    hit = torch.zeros(n_pad + e_cap, dtype=torch.bool, device=dev)
    # PyTorch copies the Python ``True`` to the card from pageable memory
    # before the scatter: a copy that waits for the stream
    with span("gm:sync:bfs_push_mark"):
        hit[torch.where(live, dst, n_pad + i).long()] = True
    return hit[:n_pad]


def bfs(g: Graph, root: int, max_iter: Optional[int] = None,
        reverse: bool = False, direction: str = "auto") -> BfsResult:
    """BFS from ``root`` over out-edges (in-edges if ``reverse``).

    ``direction``: "auto" picks push or pull per level as described above;
    "pull" and "push" force one (push with the full ``e_pad`` budget, which
    never truncates).
    """
    with span("gm:setup"):
        if direction not in ("auto", "pull", "push"):
            raise ValueError(f"direction must be auto, pull or push, "
                             f"got {direction!r}")
        if max_iter is None:
            max_iter = g.num_nodes + 1
        dev = g.device
        node_mask = g.node_mask()
        if reverse:
            pull_src, pull_off = g.node_idx, g.begin
            push_begin, push_nbr = g.r_begin, g.r_node_idx
            out_deg = g.in_degree().to(torch.int32)
        else:
            pull_src, pull_off = g.r_node_idx, g.r_begin
            push_begin, push_nbr = g.begin, g.node_idx
            out_deg = g.out_degree().to(torch.int32)
        tiers = [cap for cap in PUSH_TIERS if cap < g.e_pad // 2]

        ids = torch.arange(g.n_pad, dtype=torch.int32, device=dev)
        frontier0 = (ids == root) & node_mask
        level0 = torch.where(frontier0, 0, -1).to(torch.int32)
        state0 = (level0, frontier0, 0, frontier0.sum())

    def expand_pull(frontier):
        vals = frontier.index_select(0, pull_src).to(torch.int32)
        return scan_reduce.segment_sum_by_offsets(vals, pull_off,
                                                  g.n_pad) > 0

    def step(state):
        level, frontier, depth, count = state
        if direction == "pull" or not tiers:
            hit = expand_pull(frontier)
        elif direction == "push":
            hit = _push_expand(g, frontier, push_begin, push_nbr, g.e_pad)
        else:
            with span("gm:sync:bfs_direction"):
                fe = int(torch.where(frontier, out_deg, 0).sum())
            fits = [cap for cap in tiers if fe <= cap]
            hit = (_push_expand(g, frontier, push_begin, push_nbr, fits[0])
                   if fits else expand_pull(frontier))
        nxt = hit & (level < 0) & node_mask
        level = torch.where(nxt, depth + 1, level)
        return level, nxt, depth + 1, count + nxt.sum()

    (level, _, _, count), stats = while_loop(step, lambda s: s[1].any(),
                                             state0, max_iter)
    with span("gm:sync:bfs_reached"):
        reached = int(count)
    return BfsResult(level=level, levels_run=stats.iterations,
                     reached=reached)


def bfs_many_sequential(g: Graph, roots, max_iter: Optional[int] = None):
    """A full BFS from each of ``roots`` in turn: ``(total levels, total
    reached, traversed edges per root [R] int32, the last root's level
    array)``, traversed edges being the out-degrees of the reached set.
    The JAX version runs the loop on the device to pay the TPU link's round
    trip once; here it is a host loop over :func:`bfs`."""
    deg = g.out_degree().to(torch.int32)
    roots = [int(r) for r in roots]
    trav = torch.zeros(len(roots), dtype=torch.int32, device=g.device)
    level = torch.zeros(g.n_pad, dtype=torch.int32, device=g.device)
    total_levels = total_reached = 0
    for i, r in enumerate(roots):
        res = bfs(g, r, max_iter=max_iter)
        level = res.level
        trav[i] = torch.where(level >= 0, deg, 0).sum()
        total_levels += res.levels_run
        total_reached += res.reached
    return total_levels, total_reached, trav, level


def level_masks(level: torch.Tensor, max_levels: int) -> torch.Tensor:
    """[max_levels, N_pad] bool: per-level membership, for reverse sweeps."""
    return (torch.arange(max_levels, dtype=torch.int32,
                         device=level.device)[:, None] == level[None, :])


def bfs_np(begin, node_idx, root):
    """Host oracle for tests."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    level = np.full(begin.shape[0] - 1, -1, np.int64)
    level[root] = 0
    q = collections.deque([root])
    while q:
        u = q.popleft()
        for v in node_idx[begin[u]:begin[u + 1]]:
            if level[v] < 0:
                level[v] = level[u] + 1
                q.append(v)
    return level
