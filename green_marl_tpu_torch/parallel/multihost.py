"""Multi-process runtime bootstrap over ``torch.distributed``.

Counterpart of ``green_marl_tpu/parallel/multihost.py`` (the reference's
Barrelfish XOMP bootstrap, ``common_main.h:100-150``): every process calls
:func:`init` before any computation, :func:`global_mesh` then spans the
shards of all processes, and the vertex-sharded engine
(``parallel.vertex_sharded``) runs unchanged: its ghost ``all_to_all`` and
its ``psum`` master scalars become cross-process collectives
(``comm.DistGroup``).  gloo carries CPU shards, NCCL CUDA ones.

Each process holds the whole host build (it is deterministic) and
materialises only the rows its own shards own (:func:`shard_rows_to_mesh`).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence

import torch

from .comm import DistGroup, Mesh, RowShards

_STATE = {}


def init(coordinator_address: str, num_processes: int, process_id: int,
         local_device_ids: Optional[Sequence[int]] = None,
         local_cpu_devices: int = 0, timeout_s: float = 600.0) -> None:
    """Join the process group (call before any collective).

    ``local_cpu_devices > 0`` gives this process that many CPU shards and
    the gloo backend; otherwise its shards are the CUDA devices
    ``local_device_ids`` (all of them by default) and the backend is NCCL.
    ``coordinator_address`` is ``host:port`` of process 0."""
    import torch.distributed as dist
    if local_cpu_devices:
        devs = [torch.device("cpu")] * local_cpu_devices
        backend, coll_dev = "gloo", torch.device("cpu")
    else:
        ids = (list(local_device_ids) if local_device_ids is not None
               else list(range(torch.cuda.device_count())))
        devs = [torch.device("cuda", i) for i in ids]
        backend, coll_dev = "nccl", devs[0]
        torch.cuda.set_device(devs[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.update(devices=devs, group=DistGroup(
        process_id, num_processes, len(devs), coll_dev))


def shutdown() -> None:
    """Leave the process group."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def global_mesh(axis: str = "v") -> Mesh:
    """1-D mesh over every shard of every process (process r's shards at
    positions ``[r*k, (r+1)*k)``)."""
    if not _STATE:
        raise RuntimeError("multihost.init() has not run")
    grp = _STATE["group"]
    return Mesh(list(_STATE["devices"]) * grp.world, (axis,), dist=grp)


def shard_rows_to_mesh(arrs, mesh: Mesh, axis: str = "v"):
    """``[S, ...]`` arrays as :class:`comm.RowShards` holding only the rows
    this process's shards own."""
    out = []
    for a in arrs:
        a = torch.as_tensor(a)
        pieces = [None] * mesh.shape[axis]
        for pos in mesh.local_positions:
            t = mesh.coords(pos)[axis]
            pieces[t] = a[t:t + 1].to(mesh.device_of(pos))
        out.append(RowShards(pieces, a.shape, a.dtype))
    return out


def place_multihost(vsg, mesh: Mesh, axis: str = "v"):
    """Multi-process ``vertex_sharded.place``: every process holds the full
    host build and materialises its own shards' rows only."""
    fields = ("dst_local", "src_vidx", "emask", "csc_slot", "send_idx",
              "deg_owned", "dst_off")
    arrs = shard_rows_to_mesh([getattr(vsg, f) for f in fields], mesh, axis)
    return dataclasses.replace(vsg, **dict(zip(fields, arrs)))
