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
* ``bits_schedule``: what ``multi_source_bfs_bits`` needs of a graph
  (the binned schedule over in-neighbours on the graph's device, the
  out-degrees in binned order, the gather's ``slot_chunk``), built once;
  the ``multi_bfs`` app and the benchmark both call it.
* ``*_paged``: the JAX package's memory-paged variants.  Eager PyTorch
  loops on the host anyway, so here they differ from the fused forms only
  in what they compute: the paged PageRank folds ``1/out_degree`` into
  per-slot weights and does not freeze converged instances one by one;
  the paged bit BFS iterates ``visited |= edge_map(visited)``.

Bit planes: ``plane_bits`` instances per lane, instance ``b`` at lane
``b // plane_bits``, bit ``b % plane_bits``.  The planes are uint8, int16
or int32: the same bits as JAX's uint8/uint16/uint32 (CPU torch has no
``>>`` or ``amax`` for uint16/uint32).  Compare them with ``.view`` as the
unsigned type.  Inside a call a row has zero lanes past the last
instance's up to a multiple of 16 bytes, at least 16 (the rows the
edge-map kernels take, so that every batch of up to 4,096 instances runs
on them); the result's planes have ``ceil(B / plane_bits)`` lanes, as the
JAX package's.

On the card a bit BFS level is one launch of
``kernels.edge_map_bor_level`` (``binned.edge_map_level``: the edge map
with the frontier's update and the count of its rows in its row writes;
the paged form's edge map is ``kernels.edge_map_bor``), and its final
counts one of ``kernels.bit_popstats``.

Under a profiler a ``multi_source_bfs_bits`` call opens ``gm:setup``
around its seed plane, ``gm:superstep`` a level (``engine/superstep.py``),
``gm:edge_map`` inside it (``ops/binned.py``) and ``gm:popstats`` around
the final counts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import binned as _binned
from ..ops import kernels as _kernels
from ..ops.binned import BinnedPull
from ..utils.timing import span

INT32_MAX = torch.iinfo(torch.int32).max
PLANE_DTYPES = {torch.iinfo(d).bits: d for d in _kernels.PLANE_DTYPES}


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


class BitSchedule(NamedTuple):
    bp: BinnedPull           # over in-neighbours, without ``slot_edge``
    deg_rows: torch.Tensor   # [n_rows] int32 out-degrees, binned order
    slot_chunk: int          # slots a gather holds (``GATHER_BUDGET``)


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


# Row-chunk size of the plain popcount's bit expansion (the CPU's path)
_POP_CH = _kernels.POP_CHUNK


def _bit_popstats(visited: torch.Tensor, deg_rows: torch.Tensor, lanes: int,
                  bits: int = 8):
    """Per-instance (``lane * bits + bit``) counts and out-degree-weighted
    counts from a [n_rows, lanes] plane, as int64 (exact).

    ``bits`` is the plane dtype's width.  On the card the plane takes
    ``kernels.bit_popstats`` (one launch), which raises on a plane its
    rule refuses; on the CPU the plain version, ``_POP_CH`` rows a pass."""
    if visited.shape[1] != lanes:
        raise ValueError(f"visited has {visited.shape[1]} lanes, not {lanes}")
    if bits != torch.iinfo(visited.dtype).bits:
        raise ValueError(f"bits={bits}: the counts cover all "
                         f"{torch.iinfo(visited.dtype).bits} bits of a "
                         f"{visited.dtype} lane")
    if visited.device.type == "cuda":
        return _kernels.bit_popstats(visited, deg_rows)
    return _kernels.bit_popstats_ref(visited, deg_rows, _POP_CH)


def _plane_lanes(B: int, plane_bits: int) -> int:
    """Lanes of a call's planes for ``B`` instances: ``ceil(B /
    plane_bits)`` up to a multiple of 16 bytes, at least 16."""
    per_16 = 128 // plane_bits
    return max(1, -(-B // (plane_bits * per_16))) * per_16


def _unpadded(visited: torch.Tensor, B: int, plane_bits: int
              ) -> torch.Tensor:
    """``visited`` without the lanes past instance ``B - 1``'s."""
    lanes = -(-B // plane_bits)
    if visited.shape[1] == lanes:
        return visited
    return visited[:, :lanes].contiguous()


def _bits_seed(bp: BinnedPull, roots, plane_bits: int) -> torch.Tensor:
    """[n_rows, _plane_lanes(B, plane_bits)] plane with instance b's bit
    set in its root's row, the pad lanes 0.

    A scatter-add is exact: every instance owns a distinct bit (a
    scatter-max would keep only the highest bit where two roots share a
    row and a lane)."""
    if plane_bits not in PLANE_DTYPES:
        raise ValueError(f"plane_bits must be 8, 16 or 32, got {plane_bits}")
    dt = PLANE_DTYPES[plane_bits]
    dev = bp.device
    root_rows = bp.inv_perm.index_select(0, _roots(roots, dev)).long()
    B = root_rows.shape[0]
    lanes = _plane_lanes(B, plane_bits)
    b_ix = torch.arange(B, device=dev)
    bits0 = torch.zeros((bp.n_rows, lanes), dtype=dt, device=dev)
    one = torch.ones(B, dtype=dt, device=dev)
    bits0.index_put_((root_rows, b_ix // plane_bits),
                     one << (b_ix % plane_bits).to(dt), accumulate=True)
    return bits0


def bits_schedule(g: Graph, num_roots: int, plane_bits: int) -> BitSchedule:
    """The schedule of ``multi_source_bfs_bits`` over ``g`` for
    ``num_roots`` instances at ``plane_bits``, on ``g``'s device: the
    binned pull over in-neighbours (built on the host), the out-degrees in
    binned order (0 in pad rows) and the ``slot_chunk`` that keeps a gather
    of the planes' rows within ``binned.GATHER_BUDGET`` where the edge map
    takes the plain path (the CPU; on the card the kernels
    ``kernels.edge_map_bor_level`` and ``kernels.edge_map_bor`` gather
    nothing into memory): eager PyTorch
    writes each gathered bin before reducing it (the results do not
    change)."""
    bp = _binned.binned_in(g).to(g.device, with_edges=False)
    out_deg = g.out_degree().cpu().numpy()
    deg_rows = np.zeros(bp.n_rows, np.int32)
    deg_rows[:bp.n_nodes] = out_deg[:bp.n_nodes][bp.perm.cpu().numpy()]
    lanes = _plane_lanes(num_roots, plane_bits)
    chunk = _binned.slot_chunk_for(lanes * plane_bits // 8)
    return BitSchedule(bp, torch.from_numpy(deg_rows).to(g.device), chunk)


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
    with span("gm:setup"):
        # two planes: a level gathers the frontier and rewrites visited (a
        # second seed writes 2.48 GB at the cell's shape, a clone 4.96)
        visited, frontier = (_bits_seed(bp, roots, plane_bits)
                             for _ in range(2))

    def step(state):
        visited, frontier, depth, _ = state
        nxt, rows = _binned.edge_map_level(bp, frontier, visited,
                                           slot_chunk=slot_chunk)
        return visited, nxt, depth + 1, rows

    # the predicate is the level's count of frontier rows: one 4-byte read
    (visited, _, _, _), stats = while_loop(step, lambda st: st[3],
                                           (visited, frontier, 0, B > 0),
                                           max_iter)
    with span("gm:popstats"):
        cnt, trav = _bit_popstats(visited, deg_rows, visited.shape[1],
                                  bits=plane_bits)
    return BitBfsResult(visited=_unpadded(visited, B, plane_bits),
                        levels_run=stats.iterations,
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
    return BitBfsResult(visited=_unpadded(visited, B, plane_bits),
                        levels_run=depth,
                        reached=cnt[:B], traversed=trav[:B])
