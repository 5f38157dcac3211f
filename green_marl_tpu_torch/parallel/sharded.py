"""Edge-sharded execution over a mesh: node state replicated, edges split.

Counterpart of ``green_marl_tpu/parallel/sharded.py`` (the Shoal
distribute placement of the reference's ``scripts/run.sh:66-105``): the
padded CSC/CSR slot arrays are cut into equal ``[S, E_s]`` slabs over the
``"v"`` axis, the offset arrays are replicated, and every superstep's
partial reductions are combined with a collective over ``"v"``.  A 2-D
mesh ``("batch", "v")`` shards whole algorithm instances over ``"batch"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph.csr import Graph, round_up
from ..ops.segment import sorted_segment_reduce
from .comm import Mesh, P, devices, shard_map

INT32_MAX = torch.iinfo(torch.int32).max

_SLABS = ("csc_src", "csc_dst", "csc_eidx", "csr_src", "csr_dst")


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Edge-sharded view of a ``Graph``: [S, E_s] slabs of the CSC/CSR slot
    arrays (sentinel-padded), plus replicated O(N) offset arrays."""

    csc_src: torch.Tensor    # [S, E_s] source endpoint per CSC slot
    csc_dst: torch.Tensor    # [S, E_s] destination endpoint per CSC slot
    csc_eidx: torch.Tensor   # [S, E_s] CSR slot id (for edge properties)
    csr_src: torch.Tensor    # [S, E_s] source endpoint per CSR slot
    csr_dst: torch.Tensor    # [S, E_s] destination endpoint per CSR slot
    begin: torch.Tensor      # [N+1] replicated
    r_begin: torch.Tensor    # [N+1] replicated

    num_nodes: int
    num_edges: int
    num_shards: int

    @property
    def n_pad(self) -> int:
        return round_up(self.num_nodes + 1)

    @property
    def sentinel(self) -> int:
        return self.num_nodes


def shard_graph(g: Graph, num_shards: int) -> ShardedGraph:
    """Split the padded edge arrays into ``num_shards`` equal slabs (host
    side, numpy)."""
    E_s = round_up(-(-g.e_pad // num_shards))
    total = E_s * num_shards
    sent = g.sentinel

    def slab(arr, fill):
        a = arr.cpu().numpy()
        out = np.full(total, fill, a.dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out.reshape(num_shards, E_s))

    return ShardedGraph(
        csc_src=slab(g.r_node_idx, sent),
        csc_dst=slab(g.r_node_idx_dst, sent),
        csc_eidx=slab(g.e_rev2idx, 0),
        csr_src=slab(g.node_idx_src, sent),
        csr_dst=slab(g.node_idx, sent),
        begin=g.begin.cpu(), r_begin=g.r_begin.cpu(),
        num_nodes=g.num_nodes, num_edges=g.num_edges,
        num_shards=num_shards)


def make_mesh(batch: int = 1, v: Optional[int] = None,
              kind: str = "cuda") -> Mesh:
    """A 2-D mesh ``("batch", "v")`` over :func:`comm.devices`: ``batch``
    shards whole algorithm instances, ``"v"`` the edge set."""
    devs = devices(kind)
    if v is None:
        v = len(devs) // batch
    if batch * v > len(devs):
        raise ValueError(f"a {batch}x{v} mesh needs {batch * v} devices, "
                         f"{len(devs)} available")
    arr = np.empty(batch * v, dtype=object)
    arr[:] = devs[: batch * v]
    return Mesh(arr.reshape(batch, v), ("batch", "v"))


def place(sg: ShardedGraph, mesh: Mesh) -> ShardedGraph:
    """Edge slabs and offset arrays on the mesh's device.  On a mesh of
    several devices they stay on the host and each call copies a shard's
    slab to its device."""
    dev = mesh.single_device()
    if dev is None:
        return sg
    return dataclasses.replace(sg, **{
        f: getattr(sg, f).to(dev) for f in _SLABS + ("begin", "r_begin")})


def _slab_offsets(dst: torch.Tensor, n: int) -> torch.Tensor:
    """Segment offsets of a sorted slab of destination ids over rows
    ``[0, n)``."""
    return torch.searchsorted(
        dst, torch.arange(n + 1, dtype=dst.dtype, device=dst.device),
        out_int32=True)


# ---------------------------------------------------------------------------
# Sharded algorithms
# ---------------------------------------------------------------------------

def pagerank_sharded(sg: ShardedGraph, mesh: Mesh, e=0.001, d=0.85,
                     max_iter: int = 100, dtype=torch.float32):
    """PageRank over the mesh: local partial pull-sums per edge slab (the
    segment-reduce kernel on the card), combined with ``psum`` over "v"
    each superstep; rank is replicated.  Returns ``(rank [n_pad], diff,
    iterations)``."""
    n = sg.num_nodes
    n_pad = sg.n_pad

    def run(axes, csc_src, csc_dst, begin):
        ax = axes["v"]
        dev = csc_src.device
        mask = torch.arange(n_pad, device=dev) < n
        inv_n = torch.tensor(1.0 / n, dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        deg = torch.nn.functional.pad(begin[1:] - begin[:-1],
                                      (0, n_pad - n)).to(dtype)
        inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1), zero)
        rank = torch.where(mask, inv_n, zero)
        src = csc_src.reshape(-1).long()
        dst = csc_dst.reshape(-1).contiguous()
        off = _slab_offsets(dst, n_pad)
        diff, it = zero, 0
        while ax.agree(it < max_iter and (it == 0 or bool(diff > e))):
            contrib = (rank * inv_deg)[src]
            part = sorted_segment_reduce(contrib, dst, off, n_pad, "add")
            s = ax.psum(part)
            val = torch.where(mask, (1 - d) * inv_n + d * s, zero)
            diff = (val - rank).abs().sum()
            rank = val
            it += 1
        return rank, diff, it

    return shard_map(run, mesh, (P("v", None), P("v", None), P()),
                     (P(), P(), P()))(sg.csc_src, sg.csc_dst, sg.begin)


def multi_source_bfs_sharded(sg: ShardedGraph, mesh: Mesh, roots,
                             max_iter: int):
    """Batched BFS over the 2-D mesh: instances over "batch", edges over
    "v".  Per superstep a local frontier expansion, ``pmax`` over "v", and
    liveness by ``psum`` over "batch".  Returns ``(dist [n_pad, B],
    depth)``."""
    n = sg.num_nodes
    n_pad = sg.n_pad
    roots = torch.as_tensor(np.asarray(roots), dtype=torch.int32)

    def run(axes, csc_src, csc_dst, roots_l):
        dev = csc_src.device
        B_l = roots_l.shape[0]
        mask = torch.arange(n_pad, device=dev) < n
        dist = torch.full((n_pad, B_l), INT32_MAX, dtype=torch.int32,
                          device=dev)
        dist[roots_l.long(), torch.arange(B_l, device=dev)] = 0
        dist = torch.where(mask[:, None], dist, INT32_MAX).to(torch.int32)
        src = csc_src.reshape(-1).long()
        dst = csc_dst.reshape(-1).long()
        depth, live = 0, 1
        while axes["batch"].agree(depth < max_iter and live > 0):
            frontier = (dist == depth).to(torch.int32)
            part = torch.full((n_pad, B_l), torch.iinfo(torch.int32).min,
                              dtype=torch.int32, device=dev)
            part.scatter_reduce_(0, dst[:, None].expand(-1, B_l),
                                 frontier[src], "amax", include_self=True)
            hit = axes["v"].pmax(part) > 0
            newly = hit & (dist == INT32_MAX) & mask[:, None]
            dist = torch.where(newly, depth + 1, dist).to(torch.int32)
            live = int(axes["batch"].psum(newly.sum(dtype=torch.int32)))
            depth += 1
        return dist, depth

    return shard_map(run, mesh, (P("v", None), P("v", None), P("batch")),
                     (P(None, "batch"), P()))(sg.csc_src, sg.csc_dst, roots)
