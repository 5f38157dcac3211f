"""One program over many shards: the port's ``shard_map`` and collectives.

Counterpart of ``jax.shard_map`` together with ``jax.lax.axis_index``,
``all_to_all``, ``psum``, ``pmin`` and ``pmax``, which the JAX package's
sharded paths (``parallel/``, ``lang/lower_vertex.py``,
``lang/distribute.py``) are written in:

* a :class:`Mesh` is an array of ``torch.device`` s with axis names: 1-D
  ``("v",)`` for most callers, 2-D ``("batch", "v")`` for
  ``parallel.sharded.make_mesh``;
* :func:`shard_map` runs ``fn`` once per shard, one Python thread per shard
  of this process.  ``fn`` gets an :class:`Axes` handle first (``axes["v"]``
  is the :class:`Axis` of that name) and then its arguments, each cut to the
  shard as its :class:`P` spec says;
* an :class:`Axis` reduces within the group of shards that share every other
  mesh coordinate: :meth:`Axis.all_to_all` follows
  ``jax.lax.all_to_all(x, axis, 0, 0)`` (shard t receives ``recv[s] =
  send_s[t]``), :meth:`Axis.psum` adds the group's values in rank order, so
  every shard of the group holds the same bits;
* outputs that ``out_specs`` marks replicated (``P()``) are rank 0's; sharded
  outputs are concatenated in rank order.

Shards of one process exchange values through shared slots and a
``threading.Barrier`` (the ``LocalComm`` of this module).  Across processes
(``parallel.multihost``) the first shard of each process also runs the
``torch.distributed`` collective for its process: gloo on the CPU, NCCL on
GPUs.  Every collective carries its kind, axis, shape and dtype, and shards
that disagree raise :class:`CollectiveMismatch`, so a program whose shards
take different paths fails loudly instead of deadlocking.  A shard that
raises aborts the barrier; the others stop at their next collective and the
first real error is raised to the caller.  Every wait has a timeout
(:func:`shard_map`'s ``timeout``, :data:`TIMEOUT` seconds by default).

Shards on one card share its current stream (the default one, as nothing
here sets another), so a value one shard's thread produced is read by
another's kernels in launch order.

``GM_TORCH_VIRTUAL_DEVICES=k`` lets k shards share each device
(:func:`devices`): the port's counterpart of the JAX tests' virtual CPU
devices (``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

VIRTUAL_ENV = "GM_TORCH_VIRTUAL_DEVICES"
TIMEOUT = 600.0           # seconds a shard waits at a collective

# collectives the first shard of a process has called, by kind (a run's
# count: reset, run, read)
COUNTS = {"all_to_all": 0, "psum": 0, "pmin": 0, "pmax": 0, "agree": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class CollectiveMismatch(RuntimeError):
    """Shards called different collectives, or one with other shapes."""


class CollectiveTimeout(RuntimeError):
    """A shard did not reach a collective within the timeout."""


def virtual_devices() -> int:
    """Shards per device from ``GM_TORCH_VIRTUAL_DEVICES`` (1 if unset)."""
    v = os.environ.get(VIRTUAL_ENV, "")
    return max(1, int(v)) if v.strip() else 1


def devices(kind: str = "cuda") -> List[torch.device]:
    """The devices a mesh can take on this host: every CUDA device (or the
    CPU), each repeated ``GM_TORCH_VIRTUAL_DEVICES`` times."""
    k = virtual_devices()
    if kind == "cpu":
        return [torch.device("cpu")] * k
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n) for _ in range(k)]


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading dim, as
    ``jax.sharding.PartitionSpec``; ``P()`` is replicated."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


class RowShards:
    """A ``[S, ...]`` array whose rows live on their shards' devices (a
    mesh with more than one device, or a process that holds only its own
    rows).  ``pieces[i]`` is row ``i`` as ``[1, ...]``, or None where
    another process holds it."""

    def __init__(self, pieces: List[Optional[torch.Tensor]], shape, dtype):
        self.pieces = pieces
        self.shape = tuple(shape)
        self.dtype = dtype

    def numel(self) -> int:
        return int(np.prod(self.shape))


class DistGroup:
    """This process's place in a ``torch.distributed`` world: ``rank`` of
    ``world`` processes, each with ``local`` shards; collectives run on
    tensors on ``device`` (the CPU for gloo, the card for NCCL)."""

    def __init__(self, rank: int, world: int, local: int,
                 device: torch.device):
        self.rank, self.world, self.local = rank, world, local
        self.device = device


class Mesh:
    """Devices in an array with named axes (``jax.sharding.Mesh``).

    With ``dist`` the array spans every process of a ``torch.distributed``
    world; process r runs the flat positions ``[r*k, (r+1)*k)``, k =
    ``dist.local``, and the devices of the other processes' positions are
    only names here."""

    def __init__(self, devices, axis_names: Sequence[str] = ("v",),
                 dist: Optional[DistGroup] = None):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        shape = np.shape(np.asarray(devices, dtype=object))
        arr = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            arr[i] = torch.device(d)
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")
        self.dist = dist
        if dist is not None:
            if self.devices.ndim != 1:
                raise ValueError("a multi-process mesh is 1-D")
            if dist.world * dist.local != self.size:
                raise ValueError(f"{self.size} positions for {dist.world} "
                                 f"processes of {dist.local} shards")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_positions(self) -> List[int]:
        """The flat positions this process runs."""
        if self.dist is None:
            return list(range(self.size))
        k = self.dist.local
        return list(range(self.dist.rank * k, (self.dist.rank + 1) * k))

    def device_of(self, pos: int) -> torch.device:
        return self.devices.reshape(-1)[pos]

    def coords(self, pos: int) -> Dict[str, int]:
        c = np.unravel_index(pos, self.devices.shape)
        return {n: int(i) for n, i in zip(self.axis_names, c)}

    def position(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords[n] for n in self.axis_names), self.devices.shape))

    def single_device(self) -> Optional[torch.device]:
        """The one device every position of the mesh is on, else None."""
        devs = {str(d) for d in self.devices.reshape(-1)}
        return self.device_of(0) if len(devs) == 1 else None


def vmesh(n: Optional[int] = None, axis: str = "v",
          kind: str = "cuda") -> Mesh:
    """1-D mesh over the first ``n`` of :func:`devices`; raises when there
    are fewer."""
    devs = devices(kind)
    if n is None:
        n = len(devs)
    if len(devs) < n:
        raise ValueError(f"{n} shards need {n} devices, {len(devs)} "
                         f"available (set {VIRTUAL_ENV})")
    return Mesh(devs[:n], (axis,))


def place_rows(x: torch.Tensor, mesh: Mesh, axis: str = "v"):
    """Put the rows of a ``[S, ...]`` tensor on their shards' devices: the
    whole tensor on a one-device mesh, a :class:`RowShards` otherwise."""
    dev = mesh.single_device()
    if dev is not None:
        return x.to(dev)
    pieces = [None] * mesh.shape[axis]
    for pos in mesh.local_positions:
        t = mesh.coords(pos)[axis]
        pieces[t] = x[t:t + 1].to(mesh.device_of(pos))
    return RowShards(pieces, x.shape, x.dtype)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class _Run:
    """The shared state of one :func:`shard_map` call in this process."""

    def __init__(self, mesh: Mesh, timeout: float):
        self.mesh = mesh
        self.timeout = timeout
        self.positions = mesh.local_positions
        self.n = len(self.positions)
        self.barrier = threading.Barrier(self.n, timeout=timeout)
        self.slots: List[Any] = [None] * self.n
        self.shared: Any = None
        self.errors: List[BaseException] = []
        self.lock = threading.Lock()

    def _check(self, metas):
        if any(m != metas[0] for m in metas):
            raise CollectiveMismatch(
                "shards called different collectives: " + "; ".join(
                    f"shard {i}: {m}" for i, m in enumerate(metas)))

    def exchange(self, i: int, meta, payload) -> List[Any]:
        """Every position's payload (in flat order) after all positions
        deposited theirs; metas must agree."""
        self.slots[i] = (meta, payload)
        self.barrier.wait()
        local = list(self.slots)
        if self.mesh.dist is None:
            metas = [m for m, _ in local]
            payloads = [p for _, p in local]
        else:
            if i == 0:
                self.shared = _dist_gather(self.mesh.dist, local)
            self.barrier.wait()
            metas, payloads = self.shared
        self.barrier.wait()
        self._check(metas)
        return payloads

    def all_to_all(self, i: int, meta, x: torch.Tensor) -> torch.Tensor:
        """The multi-process all_to_all over a 1-D mesh: shard i's
        ``recv`` with ``recv[s] = send_s[i]``."""
        self.slots[i] = (meta, x)
        self.barrier.wait()
        if i == 0:
            self.shared = _dist_all_to_all(self.mesh.dist, list(self.slots))
        self.barrier.wait()
        metas, recvs = self.shared
        self.barrier.wait()
        self._check(metas)
        return recvs[i].to(x.device)


def _dist_gather(dg: DistGroup, local):
    """All processes' (meta, payload) lists, in global position order."""
    import torch.distributed as dist
    metas = [None] * dg.world
    dist.all_gather_object(metas, [m for m, _ in local])
    metas = [m for part in metas for m in part]
    if any(m != metas[0] for m in metas):
        return metas, [None] * len(metas)
    p0 = local[0][1]
    if not isinstance(p0, torch.Tensor):
        objs = [None] * dg.world
        dist.all_gather_object(objs, [p for _, p in local])
        return metas, [p for part in objs for p in part]
    mine = torch.stack([p for _, p in local]).to(dg.device)
    parts = [torch.empty_like(mine) for _ in range(dg.world)]
    dist.all_gather(parts, mine)
    return metas, [row.to(p0.device) for part in parts for row in part]


def _dist_all_to_all(dg: DistGroup, local):
    import torch.distributed as dist
    metas = [None] * dg.world
    dist.all_gather_object(metas, [m for m, _ in local])
    metas = [m for part in metas for m in part]
    if any(m != metas[0] for m in metas):
        return metas, [None] * len(local)
    k = dg.local
    sends = torch.stack([p for _, p in local]).to(dg.device)  # [k, S, ...]
    inputs = [sends[:, q * k:(q + 1) * k].contiguous()
              for q in range(dg.world)]
    outputs = [torch.empty_like(inputs[0]) for _ in range(dg.world)]
    dist.all_to_all(outputs, inputs)
    # outputs[q][i, j]: what q's shard i sends to this process's shard j
    recv = torch.cat(outputs, 0)                     # [S, k, ...]
    return metas, [recv[:, j] for j in range(k)]


class Axis:
    """One mesh axis as one shard sees it (``jax.lax`` collectives over a
    named axis)."""

    def __init__(self, run: _Run, i: int, pos: int, name: str):
        mesh = run.mesh
        self._run, self._i, self._pos = run, i, pos
        self.name = name
        self.size = mesh.shape[name]
        coords = mesh.coords(pos)
        self._coord = coords[name]
        self.group = [mesh.position({**coords, name: c})
                      for c in range(self.size)]
        self.device = mesh.device_of(pos)

    def index(self) -> int:
        """This shard's coordinate along the axis (``axis_index``)."""
        return self._coord

    def _meta(self, kind, x):
        if isinstance(x, torch.Tensor):
            return (kind, self.name, tuple(x.shape), str(x.dtype))
        return (kind, self.name, type(x).__name__)

    def _group_values(self, kind, x):
        if self._i == 0:
            COUNTS[kind] += 1
        vals = self._run.exchange(self._i, self._meta(kind, x), x)
        return [vals[p] for p in self.group]

    def _reduce(self, kind, x, op):
        x = torch.as_tensor(x, device=self.device)
        parts = self._group_values(kind, x)
        acc = parts[0].to(self.device)
        for p in parts[1:]:
            acc = op(acc, p.to(self.device))
        return acc

    def psum(self, x) -> torch.Tensor:
        """The group's sum, added in rank order (the same bits on every
        shard)."""
        return self._reduce("psum", x, torch.add)

    def pmin(self, x) -> torch.Tensor:
        return self._reduce("pmin", x, torch.minimum)

    def pmax(self, x) -> torch.Tensor:
        return self._reduce("pmax", x, torch.maximum)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: [size, ...]; returns ``recv`` with ``recv[s] = x_s[t]``
        for this shard's coordinate t (``jax.lax.all_to_all(x, axis, 0,
        0)``)."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all over {self.name} ({self.size} "
                             f"shards) of a [{x.shape[0]}, ...] tensor")
        meta = self._meta("all_to_all", x)
        if self._run.mesh.dist is not None:
            if self._i == 0:
                COUNTS["all_to_all"] += 1
            return self._run.all_to_all(self._i, meta, x)
        parts = self._group_values("all_to_all", x)
        return torch.stack([p[self._coord].to(self.device) for p in parts])

    def agree(self, value):
        """A host value every shard of the group must hold alike (a loop
        predicate read on the host); raises CollectiveMismatch otherwise."""
        vals = self._group_values("agree", value)
        if any(v != vals[0] for v in vals):
            raise CollectiveMismatch(
                f"shards of axis {self.name} read different host values "
                f"{vals}: their control flow diverged")
        return value


class Axes:
    """The axes of the mesh as one shard sees them: ``axes[name]``."""

    def __init__(self, run: _Run, i: int, pos: int):
        self._axes = {n: Axis(run, i, pos, n) for n in run.mesh.axis_names}

    def __getitem__(self, name: str) -> Axis:
        return self._axes[name]


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def _map_spec(spec, x, fn):
    """Apply ``fn(spec, leaf)`` to every leaf of ``x`` (dicts, lists and
    tuples are walked)."""
    if isinstance(x, dict):
        return {k: _map_spec(spec, v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_spec(spec, v, fn) for v in x)
    return fn(spec, x)


def _cut(mesh: Mesh, pos: int):
    coords = mesh.coords(pos)
    dev = mesh.device_of(pos)

    def cut(spec, x):
        if isinstance(x, RowShards):
            if len(spec) < 1 or spec[0] is None:
                raise ValueError("a RowShards input needs a sharded dim 0")
            return x.pieces[coords[spec[0]]]
        if not isinstance(x, torch.Tensor):
            return x
        for d, name in enumerate(spec):
            if name is None:
                continue
            n = mesh.shape[name]
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split into {n} shards")
            w = x.shape[d] // n
            x = x.narrow(d, coords[name] * w, w)
        return x.to(dev)
    return cut


def _assemble(mesh: Mesh, outs: Dict[int, Any], spec, leaf_of):
    """One output leaf from every local shard's: concatenated along the
    spec's named axes in rank order, the other axes' coordinate 0."""
    named = [(d, n) for d, n in enumerate(spec) if n is not None]
    first = mesh.local_positions[0]
    if mesh.dist is not None:
        # each process returns what its own shards hold
        vals = [leaf_of(outs[p]) for p in mesh.local_positions]
        if not named:
            return vals[0]
        return torch.cat([v.to(vals[0].device) for v in vals], named[0][0])

    def rec(i, coords):
        if i == len(named):
            return leaf_of(outs[mesh.position(coords)])
        d, n = named[i]
        parts = [rec(i + 1, {**coords, n: c}) for c in range(mesh.shape[n])]
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts], d)
    return rec(0, {n: 0 for n in mesh.axis_names}) if named else \
        leaf_of(outs[first])


def _gather_out(mesh, outs, spec, path=()):
    """Assemble the output tree: ``spec`` is a P for a whole subtree or a
    tuple of them matching the outputs."""
    sample = outs[mesh.local_positions[0]]
    for k in path:
        sample = sample[k]

    def leaf_of(o, path=path):
        for k in path:
            o = o[k]
        return o

    if isinstance(spec, P):
        if isinstance(sample, dict):
            return {k: _gather_out(mesh, outs, spec, path + (k,))
                    for k in sample}
        if isinstance(sample, (list, tuple)):
            return type(sample)(_gather_out(mesh, outs, spec, path + (j,))
                                for j in range(len(sample)))
        if not isinstance(sample, torch.Tensor):
            return sample
        return _assemble(mesh, outs, spec, leaf_of)
    return type(sample)(_gather_out(mesh, outs, s, path + (j,))
                        for j, s in enumerate(spec))


def shard_map(fn, mesh: Mesh, in_specs, out_specs,
              timeout: float = TIMEOUT):
    """``fn(axes, *args)`` once per shard of this process, each in its own
    thread, with ``args`` cut by ``in_specs`` (a spec per positional
    argument); returns the outputs assembled by ``out_specs``."""

    def call(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments for {len(in_specs)} "
                            "in_specs")
        run = _Run(mesh, timeout)
        outs: Dict[int, Any] = {}

        def worker(i, pos):
            try:
                dev = mesh.device_of(pos)
                if dev.type == "cuda" and dev.index is not None:
                    torch.cuda.set_device(dev)
                cut = _cut(mesh, pos)
                local = [_map_spec(s, a, cut) for s, a in zip(in_specs,
                                                               args)]
                outs[pos] = fn(Axes(run, i, pos), *local)
            except BaseException as e:      # noqa: BLE001 - re-raised
                with run.lock:
                    run.errors.append(e)
                run.barrier.abort()

        threads = [threading.Thread(target=worker, args=(i, pos),
                                    name=f"shard-{pos}", daemon=True)
                   for i, pos in enumerate(run.positions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if run.errors:
            real = [e for e in run.errors
                    if not isinstance(e, threading.BrokenBarrierError)]
            if real:
                raise real[0]
            raise CollectiveTimeout(
                f"a shard did not reach a collective within "
                f"{run.timeout} s")
        return _gather_out(mesh, outs, out_specs)
    return call
