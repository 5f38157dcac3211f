"""Vertex-sharded execution: owned node state is O(N/S) per shard.

Counterpart of ``green_marl_tpu/parallel/vertex_sharded.py`` (the GPS /
Giraph vertex partitioning of the reference, ``src/inc/gps_comminfo.h``):

* **vertex ownership**: shard ``t`` owns global vertices ``[t*L, (t+1)*L)``
  and holds their properties as a local ``[L]`` slab;
* **edge placement by destination owner**: the CSC is sorted by
  destination, so shard ``t``'s edges are a contiguous CSC slice and every
  per-vertex reduction is local, in the single device's slot order.  Each
  shard's segment offsets are computed once here (``dst_off``), so the pull
  reductions run on ``ops.segment.sorted_segment_reduce`` (the
  segment-reduce kernel on the card);
* **ghost exchange**: per superstep the boundary values ride one
  ``Axis.all_to_all``, from the precomputed ``send_idx`` lists;
* **master scalars** (convergence diff, frontier liveness) finish with
  ``Axis.psum``, and the host reads them once per superstep.

The host build (:func:`build_vertex_sharded`) is numpy, and its arrays
equal the JAX package's bit for bit.  The bit planes of
:func:`multi_bfs_vsharded` are int32 words with the bits of JAX's uint32
ones (torch has no unsigned shifts or popcount on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..graph.csr import Graph, round_up
from ..ops.segment import sorted_segment_or, sorted_segment_reduce
from .comm import Mesh, P, place_rows, shard_map

INT32_MAX = torch.iinfo(torch.int32).max

_FIELDS = ("dst_local", "src_vidx", "emask", "csc_slot", "send_idx",
           "deg_owned")


@dataclasses.dataclass(frozen=True)
class VertexShardedGraph:
    """Destination-owner edge placement + ghost-exchange schedule.  Every
    ``[S, ...]`` array shards over the mesh axis on dim 0."""

    dst_local: torch.Tensor   # [S, E_s] owner-local destination, pad = L
    src_vidx: torch.Tensor    # [S, E_s] index into the [S*cap] ghost table
    emask: torch.Tensor       # [S, E_s] real-edge mask
    csc_slot: torch.Tensor    # [S, E_s] global CSC slot id (edge props)
    send_idx: torch.Tensor    # [S, S, cap] owner-local indices to send
    deg_owned: torch.Tensor   # [S, L] out-degree of owned vertices
    dst_off: torch.Tensor     # [S, L+1] segment offsets of dst_local

    num_nodes: int
    num_edges: int
    num_shards: int
    L: int
    E_s: int
    cap: int
    ghost_total: int
    slot_base: Tuple[int, ...]  # CSC slot of each shard's first edge

    @property
    def n_glob(self) -> int:
        return self.num_shards * self.L


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def unique_ids(ids: np.ndarray, n: int) -> np.ndarray:
    """``np.unique(ids)`` for ids in ``[0, n)``, by a presence map: one
    pass over ``ids`` instead of a sort."""
    seen = np.zeros(n, bool)
    seen[ids] = True
    return np.flatnonzero(seen)


def build_vertex_sharded(g: Graph, num_shards: int) -> VertexShardedGraph:
    """Host (numpy) partition build: one pass over the CSC arrays, a
    presence map per shard for its boundary sets and a slot table per shard
    for the edges' ghost pointers."""
    S = num_shards
    N, E = g.num_nodes, g.num_edges
    L = max(8, round_up(-(-N // S), 8))
    csc_dst = _np(g.r_node_idx_dst)[:E]
    csc_src = _np(g.r_node_idx)[:E]

    bounds = np.searchsorted(csc_dst, np.arange(S + 1) * L).astype(np.int64)
    counts = np.diff(bounds)
    E_s = max(8, round_up(int(counts.max()) if S else 8, 8))

    dst_local = np.full((S, E_s), L, np.int32)
    src_glob = np.zeros((S, E_s), np.int32)
    emask = np.zeros((S, E_s), bool)
    csc_slot = np.zeros((S, E_s), np.int32)
    for t in range(S):
        c = int(counts[t])
        sl = slice(int(bounds[t]), int(bounds[t + 1]))
        dst_local[t, :c] = csc_dst[sl] - t * L
        src_glob[t, :c] = csc_src[sl]
        emask[t, :c] = True
        csc_slot[t, :c] = np.arange(bounds[t], bounds[t + 1])

    # boundary sets: per consumer t, the unique sources grouped by owner
    send_lists = [[np.empty(0, np.int64)] * S for _ in range(S)]
    cap = 8
    ghost_total = 0
    for t in range(S):
        uniq = unique_ids(src_glob[t][emask[t]], S * L)
        cut = np.searchsorted(uniq // L, np.arange(S + 1))
        for s in range(S):
            lst = uniq[cut[s]:cut[s + 1]]
            send_lists[s][t] = lst
            cap = max(cap, len(lst))
            ghost_total += len(lst)
    cap = max(8, round_up(cap, 8))

    send_idx = np.zeros((S, S, cap), np.int32)
    for s in range(S):
        for t in range(S):
            lst = send_lists[s][t]
            send_idx[s, t, : len(lst)] = lst - s * L

    # per-edge ghost pointer: src u owned by s at rank p in
    # send_lists[s][t]  ->  s*cap + p in the consumer's ghost table
    src_vidx = np.zeros((S, E_s), np.int32)
    slot = np.zeros(S * L, np.int32)
    for t in range(S):
        for s in range(S):
            lst = send_lists[s][t]
            slot[lst] = s * cap + np.arange(len(lst), dtype=np.int32)
        m = emask[t]
        src_vidx[t][m] = slot[src_glob[t][m]]

    deg = _np(g.out_degree())
    deg_owned = np.zeros((S, L), deg.dtype)
    flat_n = min(S * L, deg.shape[0])
    deg_owned.reshape(-1)[:flat_n] = deg[:flat_n]

    dst_off = np.stack([np.searchsorted(dst_local[t], np.arange(L + 1))
                        for t in range(S)]).astype(np.int32)

    T = torch.from_numpy
    return VertexShardedGraph(
        dst_local=T(dst_local), src_vidx=T(src_vidx), emask=T(emask),
        csc_slot=T(csc_slot), send_idx=T(send_idx),
        deg_owned=T(deg_owned), dst_off=T(dst_off),
        num_nodes=N, num_edges=E, num_shards=S,
        L=L, E_s=E_s, cap=cap, ghost_total=int(ghost_total),
        slot_base=tuple(int(b) for b in bounds[:S]))


def place(vsg: VertexShardedGraph, mesh: Mesh,
          axis: str = "v") -> VertexShardedGraph:
    """Pin the ``[S, ...]`` slabs to their shards' devices (Shoal's
    distribute placement)."""
    return dataclasses.replace(vsg, **{
        f: place_rows(getattr(vsg, f), mesh, axis)
        for f in _FIELDS + ("dst_off",)})


def shard_edge_prop(vsg: VertexShardedGraph, g: Graph,
                    w_csr) -> torch.Tensor:
    """A CSR-slot edge property rearranged into the shards' CSC slices
    ``[S, E_s]`` (host side, once)."""
    w_csc = _np(w_csr)[_np(g.e_rev2idx)]
    slab = w_csc[_np(vsg.csc_slot)]
    return torch.from_numpy(np.ascontiguousarray(
        np.where(_np(vsg.emask), slab, 0).astype(slab.dtype)))


def _exchange(vals, send_idx_l, ax):
    """One ghost exchange: gather the boundary values, all_to_all, flatten
    to the ``[S*cap]`` ghost table (row s = values from owner s)."""
    send = vals[send_idx_l.long()]                # [S, cap, ...]
    return ax.all_to_all(send).reshape((-1,) + tuple(vals.shape[1:]))


def _local(x):
    """Drop the leading sharded dim a shard's cut leaves as size 1."""
    return x.reshape(x.shape[1:])


def _run(fn, vsg, mesh, extra, extra_specs, out_specs, axis):
    arrays = (vsg.dst_local, vsg.src_vidx, vsg.emask, vsg.send_idx,
              vsg.dst_off)
    specs = tuple(P(axis) for _ in arrays)
    return shard_map(fn, mesh, specs + extra_specs, out_specs)(
        *arrays, *extra)


# ---------------------------------------------------------------------------
# Algorithms
# ---------------------------------------------------------------------------

def pagerank_vsharded(vsg: VertexShardedGraph, mesh: Mesh,
                      e: float = 0.001, d: float = 0.85,
                      max_iter: int = 100, dtype=torch.float32,
                      axis: str = "v"):
    """PageRank with O(N/S) state: rank lives only on its owner.  Per
    superstep one ghost all_to_all of rank/deg, a local sorted segment sum
    (the segment-reduce kernel) and a psum'd L1 diff.  Each shard's sums
    are cut where the whole CSC's are (``slot_base``), so the ranks have
    the same bits at every shard count.  Returns ``(rank [N], diff,
    iterations)``."""
    N, L = vsg.num_nodes, vsg.L

    def run(axes, dst_l, vidx, emask, send_idx, off, deg):
        ax = axes[axis]
        dst_l, vidx, emask, send_idx, off, deg = map(
            _local, (dst_l, vidx, emask, send_idx, off, deg))
        dev = dst_l.device
        base = vsg.slot_base[ax.index()]
        gid = ax.index() * L + torch.arange(L, dtype=torch.int32,
                                            device=dev)
        owned = gid < N
        inv_n = torch.tensor(1.0 / N, dtype=dtype, device=dev)
        e_ = torch.tensor(e, dtype=dtype, device=dev)
        d_ = torch.tensor(d, dtype=dtype, device=dev)
        degf = deg.to(dtype)
        inv_deg = torch.where(degf > 0, 1.0 / degf.clamp(min=1),
                              0.0).to(dtype)
        zero = torch.zeros((), dtype=dtype, device=dev)
        rank = torch.where(owned, inv_n, zero)
        vidx = vidx.long()
        diff = zero
        it = 0
        while ax.agree(it < max_iter and (it == 0 or bool(diff > e_))):
            ghost = _exchange(rank * inv_deg, send_idx, ax)
            contrib = torch.where(emask, ghost[vidx], zero)
            part = sorted_segment_reduce(contrib, dst_l, off, L, "add",
                                         base=base)
            val = torch.where(owned, (1 - d_) * inv_n + d_ * part, zero)
            diff = ax.psum((val - rank).abs().sum())
            rank = val
            it += 1
        return rank, diff, it

    rank, diff, it = _run(run, vsg, mesh, (vsg.deg_owned,), (P(axis),),
                          (P(axis), P(), P()), axis)
    return rank.reshape(-1)[:N], diff, it


def hop_dist_vsharded(vsg: VertexShardedGraph, mesh: Mesh, root: int,
                      max_iter: int = 0, axis: str = "v"):
    """Level-synchronous BFS (hop_dist.gm) with sharded dist: frontier flags
    ride the ghost exchange, the expansion is a local sorted segment max.
    Returns ``(dist [N] int32, depth)``."""
    N, L = vsg.num_nodes, vsg.L
    if max_iter <= 0:
        max_iter = N

    def run(axes, dst_l, vidx, emask, send_idx, off):
        ax = axes[axis]
        dst_l, vidx, emask, send_idx, off = map(
            _local, (dst_l, vidx, emask, send_idx, off))
        dev = dst_l.device
        gid = ax.index() * L + torch.arange(L, dtype=torch.int32,
                                            device=dev)
        owned = gid < N
        dist = torch.where((gid == root) & owned, 0, INT32_MAX).to(
            torch.int32)
        vidx = vidx.long()
        depth, live = 0, 1
        while ax.agree(depth < max_iter and live > 0):
            frontier = (dist == depth).to(torch.int32)
            ghost = _exchange(frontier, send_idx, ax)
            hit = sorted_segment_reduce(
                torch.where(emask, ghost[vidx], 0).to(torch.int32), dst_l,
                off, L, "max")
            newly = (hit > 0) & (dist == INT32_MAX) & owned
            dist = torch.where(newly, depth + 1, dist).to(torch.int32)
            live = int(ax.psum(newly.sum(dtype=torch.int32)))
            depth += 1
        return dist, depth

    dist, depth = _run(run, vsg, mesh, (), (), (P(axis), P()), axis)
    return dist.reshape(-1)[:N], depth


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word of an int32 tensor (as int32)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def multi_bfs_vsharded(vsg: VertexShardedGraph, mesh: Mesh, roots,
                       max_iter: int = 0, axis: str = "v"):
    """Batched multi-source BFS with bit-packed instance planes and O(N/S)
    owned state: per superstep one ghost all_to_all of the frontier words
    and a local segment-OR over the CSC slice.

    ``roots`` [B] global node ids (B padded to a multiple of 32; W = B/32
    words; pad-instance bits are cleared in the returned planes).  Returns
    ``(visited [N, W] int32 planes, depth)``: bit b of word w at row v is
    set iff v is reachable from ``roots[w*32+b]``."""
    N, L = vsg.num_nodes, vsg.L
    roots = torch.as_tensor(np.asarray(roots), dtype=torch.int32).reshape(-1)
    B = int(roots.shape[0])
    Bp = round_up(B, 32)
    if Bp != B:
        # pad with root 0; the pad planes are cleared below
        roots = torch.cat([roots, torch.zeros(Bp - B, dtype=torch.int32)])
    W = Bp // 32
    if max_iter <= 0:
        max_iter = N

    def run(axes, dst_l, vidx, emask, send_idx, off, roots_):
        ax = axes[axis]
        dst_l, vidx, emask, send_idx = map(
            _local, (dst_l, vidx, emask, send_idx))
        dev = dst_l.device
        t = ax.index()
        gid = t * L + torch.arange(L, dtype=torch.int32, device=dev)
        owned_rows = (gid < N)[:, None]
        # seed planes: bit (b % 32) of word (b // 32) at the owner's local
        # slot of roots[b]; distinct b is a distinct (word, bit), so the
        # adds never carry
        lpos = roots_.to(dev) - t * L
        in_shard = (lpos >= 0) & (lpos < L)
        b = torch.arange(Bp, dtype=torch.int32, device=dev)
        one = torch.ones((), dtype=torch.int32, device=dev)
        contrib = torch.where(in_shard, one << (b % 32), 0).to(torch.int32)
        plane0 = torch.zeros((L + 1, W), dtype=torch.int32, device=dev)
        plane0.index_put_((torch.where(in_shard, lpos, L).long(),
                           (b // 32).long()), contrib, accumulate=True)
        visited = plane0[:L]
        frontier = visited
        vidx = vidx.long()
        depth, live = 0, 1.0
        while ax.agree(depth < max_iter and live > 0):
            ghost = _exchange(frontier, send_idx, ax)      # [S*cap, W]
            gathered = torch.where(emask[:, None], ghost[vidx], 0)
            hit = sorted_segment_or(gathered, dst_l, L + 1)[:L]
            newly = torch.where(owned_rows, hit & ~visited, 0)
            visited = visited | newly
            # liveness in float32: popcount sums can exceed int32 at scale
            live = float(ax.psum(
                popcount32(newly).to(torch.float32).sum()))
            frontier = newly
            depth += 1
        return visited, depth

    vis, depth = _run(run, vsg, mesh, (roots,), (P(),), (P(axis), P()),
                      axis)
    vis = vis.reshape(-1, W)[:N]
    if Bp != B:
        # clear the pad-instance bits (seeded with root 0) so that word
        # popcounts never over-count
        vis[:, W - 1] &= (1 << (B % 32)) - 1
    return vis, depth


def sssp_vsharded(vsg: VertexShardedGraph, mesh: Mesh, w_slab,
                  root: int, max_iter: int = 0, axis: str = "v"):
    """Bellman-Ford (sssp.gm) with sharded dist and edge weights: the
    relaxation is a local sorted segment min over ghost dist + w.  Returns
    ``(dist [N], supersteps)``."""
    N, L = vsg.num_nodes, vsg.L
    if max_iter <= 0:
        max_iter = N
    wdt = w_slab.dtype
    # the unreached sentinel of the single-device path: INT32_MAX for
    # integer weights ((int)+INF), +inf for float ones
    big = (torch.iinfo(wdt).max if not wdt.is_floating_point
           else float("inf"))

    def run(axes, dst_l, vidx, emask, send_idx, off, w):
        ax = axes[axis]
        dst_l, vidx, emask, send_idx, off, w = map(
            _local, (dst_l, vidx, emask, send_idx, off, w))
        dev = dst_l.device
        gid = ax.index() * L + torch.arange(L, dtype=torch.int32,
                                            device=dev)
        owned = gid < N
        BIG = torch.full((), big, dtype=wdt, device=dev)
        dist = torch.where((gid == root) & owned,
                           torch.zeros((), dtype=wdt, device=dev), BIG)
        vidx = vidx.long()
        it, changed = 0, 1
        while ax.agree(it < max_iter and changed > 0):
            gv = _exchange(dist, send_idx, ax)[vidx]
            # never add to the sentinel (INT32_MAX + w would wrap)
            cand = torch.where(emask & (gv < BIG), gv + w, BIG)
            m = sorted_segment_reduce(cand, dst_l, off, L, "min")
            newd = torch.where(owned, torch.minimum(dist, m), BIG)
            changed = int(ax.psum((newd < dist).sum(dtype=torch.int32)))
            dist = newd
            it += 1
        return dist, it

    dist, it = _run(run, vsg, mesh, (w_slab,), (P(axis),), (P(axis), P()),
                    axis)
    return dist.reshape(-1)[:N], it


# ---------------------------------------------------------------------------
# Placement report (Shoal decision table, gm_cpp_gen.cc:229-305)
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def placement_report(vsg: VertexShardedGraph, mesh: Mesh,
                     axis: str = "v") -> str:
    """Per-array placement table: name, global shape, per-device shape,
    bytes/device, policy (the JAX package's lines)."""
    S = mesh.shape[axis]
    rows = []
    for f in _FIELDS:
        a = getattr(vsg, f)
        size = a.numel()
        per_dev = (size // S) * _itemsize(a.dtype)
        shp = "x".join(str(d) for d in a.shape)
        rows.append(f"Array[{f}]: elements={size} global={shp} "
                    f"bytes/device={per_dev} -- "
                    f"replication=[ ] distribution=[X] axis={axis}")
    rows.append(f"Array[node_prop]: elements={vsg.n_glob} "
                f"global={vsg.num_shards}x{vsg.L} "
                f"bytes/device={vsg.L * 4} -- "
                f"replication=[ ] distribution=[X] axis={axis}")
    rows.append(f"# ghost exchange: total={vsg.ghost_total} ids, "
                f"cap={vsg.cap}/pair, "
                f"bytes/superstep/device={vsg.num_shards * vsg.cap * 4}")
    return "\n".join(rows)
