"""Batched multi-instance algorithms: many roots or configurations in
lockstep.

Counterpart of ``green_marl_tpu/models/batched.py``.  Instance state is
``[rows, B]`` with the batch in the trailing axis, so an edge map touches
one contiguous B-wide row per endpoint.

* ``multi_source_bfs`` / ``multi_pagerank``: the edge-chunked scatter forms
  over the graph's CSC arrays; the oracles of the binned forms.
* ``multi_source_bfs_binned`` / ``multi_pagerank_binned`` /
  ``multi_source_bfs_bits``: the same algorithms on the degree-binned
  engine (``ops/binned.py``); their state lies in binned row order (use
  ``bp.from_binned`` on the results).
* ``*_paged``: the JAX package's memory-paged variants.  Eager PyTorch
  loops on the host anyway, so here they differ from the fused forms only
  in what they compute: the paged PageRank folds ``1/out_degree`` into
  per-slot weights and does not freeze converged instances one by one;
  the paged bit BFS iterates ``visited |= edge_map(visited)``.

Bit planes: ``plane_bits`` instances per lane, instance ``b`` at lane
``b // plane_bits``, bit ``b % plane_bits``.  The planes are uint8, int16
or int32: the same bits as JAX's uint8/uint16/uint32 (CPU torch has no
``>>`` or ``amax`` for uint16/uint32).  Compare them with ``.view`` as the
unsigned type.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import binned as _binned
from ..ops.binned import BinnedPull

INT32_MAX = torch.iinfo(torch.int32).max
PLANE_DTYPES = {8: torch.uint8, 16: torch.int16, 32: torch.int32}


class MultiBfsResult(NamedTuple):
    dist: torch.Tensor     # [rows, B] int32 (INT32_MAX = unreached)
    levels_run: int


class MultiPageRankResult(NamedTuple):
    rank: torch.Tensor     # [rows, B]
    diff: torch.Tensor     # [B]
    iterations: int


class BitBfsResult(NamedTuple):
    visited: torch.Tensor    # [n_rows, lanes] bit planes, binned order
    levels_run: int
    reached: torch.Tensor    # [B] int64 per-instance reached-node counts
    traversed: torch.Tensor  # [B] int64 per-instance traversed edges


def _edge_chunks(g: Graph, chunk: int):
    chunk = max(1, min(chunk, g.e_pad))
    return range(0, g.e_pad, chunk), chunk


def _roots(roots, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(roots), dtype=torch.int64,
                           device=device)


def multi_source_bfs(g: Graph, roots, max_iter: Optional[int] = None,
                     chunk: int = 1 << 20) -> MultiBfsResult:
    """Level-synchronous BFS from ``roots[b]`` for every instance b.

    The frontier is implicit (``dist == depth``); supersteps run until no
    instance has a live frontier.  Result ``dist`` is [N_pad, B].
    """
    if max_iter is None:
        max_iter = g.num_nodes + 1
    dev = g.device
    roots = _roots(roots, dev)
    B = roots.shape[0]
    mask = g.node_mask()[:, None]
    starts, chunk = _edge_chunks(g, chunk)

    dist0 = torch.full((g.n_pad, B), INT32_MAX, dtype=torch.int32,
                       device=dev)
    dist0[roots, torch.arange(B, device=dev)] = 0
    dist0 = torch.where(mask, dist0, INT32_MAX)

    def step(state):
        dist, depth = state
        frontier = (dist == depth).to(torch.uint8)       # [N_pad, B]
        hit = torch.zeros_like(frontier)
        for c0 in starts:
            src = g.r_node_idx[c0:c0 + chunk]
            dst = g.r_node_idx_dst[c0:c0 + chunk].long()
            hit.scatter_reduce_(0, dst[:, None].expand(-1, B),
                                frontier.index_select(0, src), "amax")
        newly = (hit != 0) & (dist == INT32_MAX) & mask
        return torch.where(newly, depth + 1, dist), depth + 1

    (dist, _), stats = while_loop(
        step, lambda st: (st[0] == st[1]).any(), (dist0, 0), max_iter)
    return MultiBfsResult(dist=dist, levels_run=stats.iterations)


def _pagerank_loop(step, rank0, B, max_iter):
    dev = rank0.device
    state0 = (rank0, torch.zeros(B, dtype=rank0.dtype, device=dev),
              torch.ones(B, dtype=torch.bool, device=dev))
    (rank, diff, _), stats = while_loop(step, lambda st: st[2].any(),
                                        state0, max_iter)
    return MultiPageRankResult(rank=rank, diff=diff,
                               iterations=stats.iterations)


def _pagerank_step(pull, inv_deg, mask, d, inv_n, e):
    """One superstep of every active instance; converged ones freeze."""
    zero = torch.zeros((), dtype=inv_deg.dtype, device=inv_deg.device)

    def step(state):
        rank, diff, active = state
        s = pull(rank * inv_deg)
        val = torch.where(mask, (1 - d) * inv_n + d * s, zero)
        new_diff = (val - rank).abs().sum(0)               # [B]
        rank = torch.where(active[None, :], val, rank)
        return (rank, torch.where(active, new_diff, diff),
                active & (new_diff > e))
    return step


def _inv(deg: torch.Tensor) -> torch.Tensor:
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1),
                       torch.zeros((), dtype=deg.dtype, device=deg.device))


def multi_pagerank(g: Graph, damping, e=0.001, max_iter: int = 100,
                   chunk: int = 1 << 20,
                   dtype=torch.float32) -> MultiPageRankResult:
    """PageRank with a per-instance damping factor ``damping[b]``.

    Converged instances are frozen while the rest keep iterating; the
    loop exits when all have converged or at ``max_iter``.
    """
    dev = g.device
    damping = torch.as_tensor(np.asarray(damping), device=dev).to(dtype)
    B = damping.shape[0]
    starts, chunk = _edge_chunks(g, chunk)
    mask = g.node_mask()[:, None]
    inv_n = torch.tensor(1.0 / g.num_nodes, dtype=dtype, device=dev)
    e = torch.tensor(e, dtype=dtype, device=dev)
    inv_deg = _inv(g.out_degree().to(dtype))[:, None]
    rank0 = torch.where(mask, inv_n, 0).to(dtype).expand(-1, B).clone()

    def pull(contrib):
        s = torch.zeros_like(contrib)
        for c0 in starts:
            s.index_add_(0, g.r_node_idx_dst[c0:c0 + chunk],
                         contrib.index_select(0, g.r_node_idx[c0:c0 + chunk]))
        return s

    step = _pagerank_step(pull, inv_deg, mask, damping[None, :], inv_n, e)
    return _pagerank_loop(step, rank0, B, max_iter)


# ---------------------------------------------------------------------------
# Degree-binned engine variants
# ---------------------------------------------------------------------------

def multi_source_bfs_binned(bp: BinnedPull, roots,
                            max_iter: Optional[int] = None,
                            slot_chunk: Optional[int] = None
                            ) -> MultiBfsResult:
    """Multi-source BFS on the binned engine.

    ``bp``: a schedule over the *in*-neighbour view (``binned_in``): a node
    joins the frontier when any in-neighbour is in it.  ``roots``: [B]
    original node ids.  Result ``dist`` is [n_rows, B] in binned row
    order (INT32_MAX = unreached).
    """
    if max_iter is None:
        max_iter = bp.n_nodes + 1
    dev = bp.device
    root_rows = bp.inv_perm.index_select(0, _roots(roots, dev))
    B = root_rows.shape[0]
    node_rows = bp.node_rows_mask()

    dist0 = torch.full((bp.n_rows, B), INT32_MAX, dtype=torch.int32,
                       device=dev)
    dist0[root_rows.long(), torch.arange(B, device=dev)] = 0
    dist0 = torch.where(node_rows, dist0, INT32_MAX)
    f0 = (dist0 == 0).to(torch.float32)

    def step(state):
        dist, f, depth = state
        hit = _binned.edge_map(bp, f, "or", slot_chunk=slot_chunk)
        newly = (hit > 0) & (dist == INT32_MAX) & node_rows
        return (torch.where(newly, depth + 1, dist),
                newly.to(torch.float32), depth + 1)

    (dist, _, _), stats = while_loop(step, lambda st: (st[1] > 0).any(),
                                     (dist0, f0, 0), max_iter)
    return MultiBfsResult(dist=dist, levels_run=stats.iterations)


def _binned_inv_deg(bp: BinnedPull, out_deg_binned: torch.Tensor,
                    dtype) -> torch.Tensor:
    """[n_rows] 1/out-degree in binned order; 0 in pad rows."""
    inv = torch.zeros(bp.n_rows, dtype=dtype, device=bp.device)
    inv[:bp.n_nodes] = _inv(out_deg_binned[:bp.n_nodes].to(bp.device)
                            .to(dtype))
    return inv


def multi_pagerank_binned(bp: BinnedPull, out_deg_binned: torch.Tensor,
                          damping, e=0.001, max_iter: int = 100,
                          dtype=torch.float32,
                          slot_chunk: Optional[int] = None
                          ) -> MultiPageRankResult:
    """PageRank (per-instance damping) on the binned engine.

    ``out_deg_binned``: [n_nodes] out-degrees in binned row order
    (``bp.to_binned(g.out_degree()[:N])``); ``bp`` is over in-neighbours.
    Result rank is [n_rows, B] in binned row order.
    """
    dev = bp.device
    damping = torch.as_tensor(np.asarray(damping), device=dev).to(dtype)
    B = damping.shape[0]
    node_rows = bp.node_rows_mask()
    inv_n = torch.tensor(1.0 / bp.n_nodes, dtype=dtype, device=dev)
    e = torch.tensor(e, dtype=dtype, device=dev)
    inv_deg = _binned_inv_deg(bp, out_deg_binned, dtype)[:, None]
    rank0 = torch.where(node_rows, inv_n, 0).to(dtype).expand(-1, B).clone()

    def pull(contrib):                                # pad rows stay 0
        return _binned.edge_map(bp, contrib, "sum", slot_chunk=slot_chunk)

    step = _pagerank_step(pull, inv_deg, node_rows, damping[None, :], inv_n,
                          e)
    return _pagerank_loop(step, rank0, B, max_iter)


def multi_pagerank_binned_paged(bp: BinnedPull, out_deg_binned: torch.Tensor,
                                damping, e=0.001, max_iter: int = 100,
                                dtype=torch.float32,
                                slot_chunk: Optional[int] = None
                                ) -> MultiPageRankResult:
    """The paged variant of ``multi_pagerank_binned``: the contrib product
    is folded into per-slot weights ``inv_deg[slot_src]`` (no [n_rows, B]
    contrib plane), and ALL instances iterate until every diff <= e (no
    per-instance freeze).  Values match the fused form to float32 ulps;
    identical protocol for the fixed-iteration e=0 runs."""
    dev = bp.device
    damping = torch.as_tensor(np.asarray(damping), device=dev).to(dtype)
    B = damping.shape[0]
    node_rows = bp.node_rows_mask()
    inv_n = torch.tensor(1.0 / bp.n_nodes, dtype=dtype, device=dev)
    w_slot = _binned_inv_deg(bp, out_deg_binned, dtype) \
        .index_select(0, bp.slot_src)                 # [S_tot], one gather
    zero = torch.zeros((), dtype=dtype, device=dev)
    rank = torch.where(node_rows, inv_n, 0).to(dtype).expand(-1, B).clone()
    diff = torch.zeros(B, dtype=dtype, device=dev)
    it = 0
    while it < max_iter:
        s = _binned.edge_map(bp, rank, "sum", slot_vals=w_slot,
                             combine=lambda x, w: x * w,
                             slot_chunk=slot_chunk)
        val = torch.where(node_rows, (1 - damping)[None, :] * inv_n
                          + damping[None, :] * s, zero)
        diff = (val - rank).abs().sum(0)
        rank = val
        it += 1
        if float(diff.max()) <= float(e):
            break
    return MultiPageRankResult(rank=rank, diff=diff, iterations=it)


# Row-chunk size for the popstats bit expansion: the per-bit int32 view of
# a chunk costs 4x its bytes; chunking caps that transient.
_POP_CH = 1 << 20


def _bit_popstats(visited: torch.Tensor, deg_rows: torch.Tensor, lanes: int,
                  bits: int = 8):
    """Per-instance (``lane * bits + bit``) counts and out-degree-weighted
    counts from a [n_rows, lanes] plane, as int64 (exact).

    The bit planes are widened to int64 once: torch sums integers into
    int64 and would widen an int32 input itself, on each of the two sums
    (slower on an H100: 509 ms against 467 ms at B=4096, LJ scale)."""
    n_rows = visited.shape[0]
    cnt = torch.zeros((lanes, bits), dtype=torch.int64,
                      device=visited.device)
    trav = torch.zeros_like(cnt)
    for s in range(0, n_rows, _POP_CH):
        blk = visited[s:s + _POP_CH]
        dblk = deg_rows[s:s + _POP_CH].to(torch.int64)[:, None]
        for i in range(bits):
            p = ((blk >> i) & 1).to(torch.int64)          # [<=CH, lanes]
            cnt[:, i] += p.sum(0)
            trav[:, i] += (p * dblk).sum(0)
    return cnt.reshape(-1), trav.reshape(-1)


def _bits_seed(bp: BinnedPull, roots, plane_bits: int) -> torch.Tensor:
    """[n_rows, lanes] plane with instance b's bit set in its root's row.

    A scatter-add is exact: every instance owns a distinct bit (a
    scatter-max would keep only the highest bit where two roots share a
    row and a lane)."""
    if plane_bits not in PLANE_DTYPES:
        raise ValueError(f"plane_bits must be 8, 16 or 32, got {plane_bits}")
    dt = PLANE_DTYPES[plane_bits]
    dev = bp.device
    root_rows = bp.inv_perm.index_select(0, _roots(roots, dev)).long()
    B = root_rows.shape[0]
    lanes = (B + plane_bits - 1) // plane_bits
    b_ix = torch.arange(B, device=dev)
    bits0 = torch.zeros((bp.n_rows, lanes), dtype=dt, device=dev)
    one = torch.ones(B, dtype=dt, device=dev)
    bits0.index_put_((root_rows, b_ix // plane_bits),
                     one << (b_ix % plane_bits).to(dt), accumulate=True)
    return bits0


def multi_source_bfs_bits(bp: BinnedPull, roots, deg_rows: torch.Tensor,
                          max_iter: Optional[int] = None,
                          plane_bits: int = 8,
                          slot_chunk: Optional[int] = None) -> BitBfsResult:
    """Bit-packed multi-source BFS: ``plane_bits`` instances per lane, up
    to 128 * 32 = 4096 instances in 512-byte rows.

    ``roots``: [B] original node ids.  ``deg_rows``: [n_rows] out-degrees
    in binned order, 0 in pad rows, for the Graph500 accounting.
    Per-instance reached/traversed are computed once from the final
    visited planes; level arrays are not materialised (use
    ``multi_source_bfs_binned`` for distances).
    """
    if max_iter is None:
        max_iter = bp.n_nodes + 1
    B = len(roots)
    bits0 = _bits_seed(bp, roots, plane_bits)
    zero = torch.zeros((), dtype=bits0.dtype, device=bits0.device)
    node_rows = bp.node_rows_mask()

    def step(state):
        visited, frontier, depth = state
        hit = _binned.edge_map(bp, frontier, "bor", slot_chunk=slot_chunk)
        newly = torch.where(node_rows, hit & ~visited, zero)
        return visited | newly, newly, depth + 1

    (visited, _, _), stats = while_loop(step, lambda st: (st[1] != 0).any(),
                                        (bits0, bits0, 0), max_iter)
    cnt, trav = _bit_popstats(visited, deg_rows, visited.shape[1],
                              bits=plane_bits)
    return BitBfsResult(visited=visited, levels_run=stats.iterations,
                        reached=cnt[:B], traversed=trav[:B])


def multi_source_bfs_bits_paged(bp: BinnedPull, roots,
                                deg_rows: torch.Tensor,
                                max_iter: Optional[int] = None,
                                plane_bits: int = 8,
                                slot_chunk: Optional[int] = None
                                ) -> BitBfsResult:
    """The paged variant of ``multi_source_bfs_bits``: the closure
    ``visited |= edge_map(visited)`` over the visited plane alone, updated
    in place, with no frontier plane.  It converges in as many supersteps
    as the frontier BFS and counts the last, unchanged one too, as the JAX
    version does.  Same planes and counts, bit for bit."""
    if max_iter is None:
        max_iter = bp.n_nodes + 1
    B = len(roots)
    visited = _bits_seed(bp, roots, plane_bits)
    node_rows = bp.node_rows_mask()
    depth = 0
    while depth < max_iter:
        hit = _binned.edge_map(bp, visited, "bor", slot_chunk=slot_chunk)
        hit &= ~visited
        hit.masked_fill_(~node_rows, 0)
        visited |= hit
        depth += 1
        if not bool((hit != 0).any()):        # one device sync per level
            break
    cnt, trav = _bit_popstats(visited, deg_rows, visited.shape[1],
                              bits=plane_bits)
    return BitBfsResult(visited=visited, levels_run=depth,
                        reached=cnt[:B], traversed=trav[:B])
