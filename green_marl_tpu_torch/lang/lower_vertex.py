"""DSL-level vertex-sharded lowering: compiled programs get O(N/S) state.

Counterpart of ``green_marl_tpu/lang/lower_vertex.py`` (the reference's
GPS backend, ``src/backend_gps/``, runs any feasible compiled procedure
vertex-partitioned with typed per-superstep messages).  A ``Lowerer``
subclass executes the lowered AST once per shard
(``parallel.comm.shard_map``) against the shard's :class:`LocalView`:

* **node space** is ``[Lh] = [L + G]``: an owned slab of ``L = ceil(N/S)``
  vertices plus a ghost *halo* of ``G = S*cap`` boundary values, so every
  node property of a shard is O(N/S) + O(cut);
* **edge space** is the shard's contiguous CSC slice (destination-owner
  placement): per-vertex pull reductions are local, in the single device's
  slot order, and run on ``ops.segment.sorted_segment_reduce`` over the
  shard's offsets (the segment-reduce and prefix-sum kernels on the card);
* **ghost reads** (``n.dist`` at an edge's source) index the halo, which one
  ``Axis.all_to_all`` refreshes per stale property (the GPS message step);
  every property a neighbour loop reads at its ghost endpoint rides one
  fused exchange (int32 words on the wire: floats by bit cast);
* **freshness by object identity**: a property's halo is valid while its
  tensor is the one the last exchange produced; every write makes a new
  tensor, so staleness follows all control flow;
* **master scalars** finish with ``psum``/``pmin``/``pmax``; a ``While``
  predicate is read on the host by every shard, and the shards must agree.

Random scatter writes, reductions into a loop's ghost endpoint through a
local, nested neighbour iteration, collections, RNG and DFS are rejected
with the JAX package's ``LowerError`` s and remedies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import gm_ast as A
from ..graph.csr import Graph, round_up
from ..ops import segment as ops
from ..parallel.comm import Mesh, P, RowShards, place_rows, shard_map, vmesh
from ..parallel.vertex_sharded import unique_ids
from .lower import (
    _F, _I32, _RET, _BOOL, CompiledProc, EdgeCtx, Lowerer, LowerError,
    NodeCtx, _asarray, _coerce, _combine, _float_dtype, _identity, _seg,
    _SEG_OP, _sum, _walk_ast, dtype_of_kind, written_keys,
)

INT32_MAX = np.iinfo(np.int32).max

_SCHED_FIELDS = ("dst_lpos", "src_lpos", "src_gid", "emask", "csr_slot",
                 "gslot", "send_idx", "send_mask", "ghost_gid", "deg_out",
                 "deg_in", "csc_off")


# ---------------------------------------------------------------------------
# Host-side schedule build
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VertexSchedule:
    """Destination-owner edge slabs + ghost-exchange schedule, in global
    ``[S, ...]`` form (dim 0 shards over the mesh axis)."""

    dst_lpos: torch.Tensor    # [S, E_s] owner-local destination (pad = L)
    src_lpos: torch.Tensor    # [S, E_s] position of the source (halo: L+g)
    src_gid: torch.Tensor     # [S, E_s] global source id (pad = N)
    emask: torch.Tensor       # [S, E_s] real-edge mask
    csr_slot: torch.Tensor    # [S, E_s] global CSR slot (edge-prop binding)
    gslot: torch.Tensor       # [S, E_s] global CSC slot (determinism order)
    send_idx: torch.Tensor    # [S, S, cap] owner-local indices to send
    send_mask: torch.Tensor   # [S, S, cap] True where send_idx is a real id
    ghost_gid: torch.Tensor   # [S, G] global id of each halo position (pad N)
    deg_out: torch.Tensor     # [S, Lh] out-degree (owned + halo)
    deg_in: torch.Tensor      # [S, Lh] in-degree (owned + halo)
    csc_off: torch.Tensor     # [S, L+1] local CSC offsets per owned vertex

    num_nodes: int
    num_edges: int
    num_shards: int
    L: int
    E_s: int
    cap: int
    ghost_total: int

    @property
    def G(self) -> int:
        return self.num_shards * self.cap

    @property
    def Lh(self) -> int:
        return self.L + self.G


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def build_schedule(g: Graph, num_shards: int) -> VertexSchedule:
    """One host pass over the CSC arrays (numpy); the arrays equal the JAX
    package's bit for bit.  Shard ``t`` owns global vertices ``[t*L,
    (t+1)*L)``; its edges are the CSC slice whose destination it owns."""
    S = num_shards
    N, E = g.num_nodes, g.num_edges
    L = max(8, round_up(-(-N // S), 8))
    csc_dst = _np(g.r_node_idx_dst)[:E]
    csc_src = _np(g.r_node_idx)[:E]
    e_rev = _np(g.e_rev2idx)[:E]

    bounds = np.searchsorted(csc_dst, np.arange(S + 1) * L).astype(np.int64)
    counts = np.diff(bounds)
    E_s = max(8, round_up(int(counts.max()) if S else 8, 8))

    dst_lpos = np.full((S, E_s), L, np.int32)
    src_gid = np.full((S, E_s), N, np.int32)
    emask = np.zeros((S, E_s), bool)
    csr_slot = np.zeros((S, E_s), np.int32)
    gslot = np.full((S, E_s), INT32_MAX, np.int32)
    for t in range(S):
        c = int(counts[t])
        sl = slice(int(bounds[t]), int(bounds[t + 1]))
        dst_lpos[t, :c] = csc_dst[sl] - t * L
        src_gid[t, :c] = csc_src[sl]
        emask[t, :c] = True
        csr_slot[t, :c] = e_rev[sl]
        gslot[t, :c] = np.arange(bounds[t], bounds[t + 1])

    # boundary sets: per consumer t, the unique REMOTE sources grouped by
    # owner; sources t owns resolve into its owned slab (no halo slot, no
    # traffic), so the halo is sized by the true cut
    send_lists = [[np.empty(0, np.int64)] * S for _ in range(S)]
    cap = 8
    ghost_total = 0
    for t in range(S):
        uniq = unique_ids(src_gid[t][emask[t]], S * L)
        uniq = uniq[(uniq < t * L) | (uniq >= (t + 1) * L)]
        cut = np.searchsorted(uniq // L, np.arange(S + 1))
        for s in range(S):
            lst = uniq[cut[s]:cut[s + 1]]
            send_lists[s][t] = lst
            cap = max(cap, len(lst))
            ghost_total += len(lst)
    cap = max(8, round_up(cap, 8))
    Gh = S * cap

    send_idx = np.zeros((S, S, cap), np.int32)
    send_mask = np.zeros((S, S, cap), bool)
    ghost_gid = np.full((S, Gh), N, np.int32)
    for s in range(S):
        for t in range(S):
            lst = send_lists[s][t]
            send_idx[s, t, : len(lst)] = lst - s * L
            send_mask[s, t, : len(lst)] = True
            ghost_gid[t, s * cap: s * cap + len(lst)] = lst

    # per-edge position: own sources -> owned slab [0, L); a remote source
    # u owned by s at rank p in send_lists[s][t] -> halo L + s*cap + p
    src_lpos = np.full((S, E_s), L, np.int32)
    slot = np.zeros(S * L, np.int32)
    for t in range(S):
        slot[t * L:(t + 1) * L] = np.arange(L, dtype=np.int32)
        for s in range(S):
            lst = send_lists[s][t]
            slot[lst] = L + s * cap + np.arange(len(lst), dtype=np.int32)
        m = emask[t]
        src_lpos[t][m] = slot[src_gid[t][m]]

    # degree tables (static) for owned + halo positions
    degN = np.zeros(N + 1, np.int32)
    degN[:N] = np.diff(_np(g.begin))[:N]
    indegN = np.zeros(N + 1, np.int32)
    indegN[:N] = np.diff(_np(g.r_begin))[:N]
    Lh = L + Gh
    deg_out = np.zeros((S, Lh), np.int32)
    deg_in = np.zeros((S, Lh), np.int32)
    for t in range(S):
        lo, hi = t * L, min((t + 1) * L, N)
        if hi > lo:
            deg_out[t, : hi - lo] = degN[lo:hi]
            deg_in[t, : hi - lo] = indegN[lo:hi]
        gg = np.minimum(ghost_gid[t], N)
        deg_out[t, L:] = degN[gg]
        deg_in[t, L:] = indegN[gg]

    csc_off = np.zeros((S, L + 1), np.int32)
    for t in range(S):
        csc_off[t] = np.searchsorted(dst_lpos[t], np.arange(L + 1))

    T = torch.from_numpy
    return VertexSchedule(
        dst_lpos=T(dst_lpos), src_lpos=T(src_lpos), src_gid=T(src_gid),
        emask=T(emask), csr_slot=T(csr_slot), gslot=T(gslot),
        send_idx=T(send_idx), send_mask=T(send_mask),
        ghost_gid=T(ghost_gid), deg_out=T(deg_out), deg_in=T(deg_in),
        csc_off=T(csc_off), num_nodes=N, num_edges=E, num_shards=S,
        L=L, E_s=E_s, cap=cap, ghost_total=int(ghost_total))


def place_schedule(sched: VertexSchedule, mesh: Mesh,
                   axis: str = "v") -> VertexSchedule:
    """Pin each ``[S, ...]`` slab to its shard's device."""
    return dataclasses.replace(sched, **{
        f: place_rows(getattr(sched, f), mesh, axis) for f in _SCHED_FIELDS})


def _whole(x) -> torch.Tensor:
    """A schedule array as one tensor (a RowShards' rows on the CPU)."""
    if isinstance(x, RowShards):
        return torch.cat([p.cpu() for p in x.pieces])
    return x


# ---------------------------------------------------------------------------
# Per-shard graph view (the Graph surface the Lowerer touches)
# ---------------------------------------------------------------------------

class LocalView:
    """What one shard sees: its slab arrays and the halo-extended node
    space.  ``num_nodes``/``num_edges`` stay global (``G.NumNodes()``)."""

    def __init__(self, sched: VertexSchedule, gid_base: int, rows: Dict):
        self.num_nodes = sched.num_nodes
        self.num_edges = sched.num_edges
        self.num_shards = sched.num_shards
        self.L = sched.L
        self.G = sched.G
        self.cap = sched.cap
        self.gid_base = gid_base               # t * L
        self.dst_lpos = rows["dst_lpos"]       # [E_s]
        self.src_lpos = rows["src_lpos"]       # [E_s]
        self.src_gid = rows["src_gid"]         # [E_s]
        self.emask = rows["emask"]             # [E_s]
        self.csr_slot = rows["csr_slot"]       # [E_s]
        self.gslot = rows["gslot"]             # [E_s]
        self.send_idx = rows["send_idx"]       # [S, cap]
        self.send_mask = rows["send_mask"]     # [S, cap]
        self.ghost_gid = rows["ghost_gid"]     # [G]
        self.deg_out_full = rows["deg_out"]    # [Lh]
        self.deg_in_full = rows["deg_in"]      # [Lh]
        self.csc_off = rows["csc_off"]         # [L+1]
        self.device = self.dst_lpos.device
        # edge properties are bound pre-permuted into slab order
        self.e_rev2idx = torch.arange(self.e_pad, dtype=_I32,
                                      device=self.device)
        self.e_base = None

    @property
    def n_pad(self) -> int:
        return self.L + self.G

    @property
    def e_pad(self) -> int:
        return int(self.dst_lpos.shape[0])

    @property
    def sentinel(self):
        return self.num_nodes

    def node_prop(self, fill, dtype):
        return torch.full((self.n_pad,), fill, dtype=dtype,
                          device=self.device)

    def edge_prop(self, fill, dtype):
        return torch.full((self.e_pad,), fill, dtype=dtype,
                          device=self.device)

    def edge_mask(self):
        return self.emask

    def node_mask(self):
        # owned positions only; the halo is never iterated
        lp = torch.arange(self.n_pad, dtype=_I32, device=self.device)
        return (lp < self.L) & (self.gid_base + lp < self.num_nodes)

    def out_degree(self):
        return self.deg_out_full

    def in_degree(self):
        return self.deg_in_full

    # the sorted per-vertex reduction surface (CSC direction only: the
    # edge placement IS the CSC order)
    @property
    def r_node_idx_dst(self):
        return self.dst_lpos

    def csc_offsets(self):
        return self.csc_off


@dataclasses.dataclass
class VEdgeCtx(EdgeCtx):
    """Edge context over the local slab: ids are GLOBAL (comparison
    semantics), lpos index the [Lh] halo-extended node space."""
    outer_lpos: Optional[torch.Tensor] = None
    inner_lpos: Optional[torch.Tensor] = None
    outer_is_halo: bool = False
    inner_is_halo: bool = False


# ---------------------------------------------------------------------------
# The vertex-sharded lowerer
# ---------------------------------------------------------------------------

class VertexLowerer(Lowerer):
    """Executes a lowered procedure against one shard's LocalView.  The
    overridden methods are where node-space indexing, per-vertex
    reductions and master-scalar combines differ from the single-device
    lowering."""

    def __init__(self, proc: A.Procedure, gl: LocalView, axis):
        super().__init__(proc, gl, axis=axis)
        # halo cache: prop key -> the tensor whose halo region is
        # consistent with its owned slab (identity; a write makes a new
        # tensor, so it is stale)
        self._halo_ok: Dict[str, object] = {}
        # ghost exchanges this shard has made (one all_to_all each)
        self.exchange_count: int = 0

    def _owned_seg(self, sub, work, keys):
        """Per-owned-vertex segment reduce keyed by slab positions: the
        sorted reduction over the CSC offsets when the keys are the slab's
        destinations, an unsorted one otherwise.  Returns [L]."""
        gl = self.g
        if keys is gl.dst_lpos:
            return ops.sorted_segment_reduce(work.contiguous(), keys,
                                             gl.csc_off, gl.L + 1,
                                             sub)[:gl.L]
        return _seg(sub, work, keys, gl.L + 1)[:gl.L]

    # ---- ghost exchange ---------------------------------------------------
    def _exchange(self, owned):
        """[L] owned values -> [G] halo table via one all_to_all."""
        gl = self.g
        v = owned
        as_bool = v.dtype == _BOOL
        if as_bool:
            v = v.to(torch.int8)
        send = v[gl.send_idx.long()]                          # [S, cap]
        self.exchange_count += 1
        out = self.axis.all_to_all(send).reshape(-1)
        return out.to(_BOOL) if as_bool else out

    # 4-byte wire format for the fused exchange: everything bit-casts or
    # widens to int32 (the GPS backend likewise unions congruent message
    # classes into one wire layout, gps_comminfo.h:8-100)
    _WIRE_OK = (torch.int32, torch.float32, _BOOL, torch.int8)

    @staticmethod
    def _to_wire(v):
        if v.dtype in (_BOOL, torch.int8):
            return v.to(_I32)
        if v.dtype == torch.float32:
            return v.view(_I32)
        return v

    @staticmethod
    def _from_wire(w, dt):
        if dt in (_BOOL, torch.int8):
            return w.to(dt)
        if dt == torch.float32:
            return w.contiguous().view(torch.float32)
        return w

    def _ensure_halos(self, keys, env):
        """Refresh the halos of every stale property in ``keys`` with ONE
        fused all_to_all (the reference GPS backend's congruent-message
        merge, ``gm_gps_find_congruent_message.cc``).  Properties without a
        4-byte wire form take the one-property path."""
        gl = self.g
        stale, fallback = [], []
        for k in keys:
            arr = env.get(k)
            if not isinstance(arr, torch.Tensor) or arr.dim() != 1 or \
                    arr.shape[0] != gl.L + gl.G:
                continue
            if self._halo_ok.get(k) is arr:
                continue
            (stale if arr.dtype in self._WIRE_OK else fallback).append(k)
        for k in fallback:
            self._ensure_halo(k, env)
        if not stale:
            return
        if len(stale) == 1:
            self._ensure_halo(stale[0], env)
            return
        sends, dts = [], []
        idx = gl.send_idx.long()
        for k in stale:
            v = env[k][:gl.L]
            dts.append(v.dtype)
            sends.append(self._to_wire(v)[idx])              # [S, cap]
        bundle = torch.stack(sends, dim=-1)                  # [S, cap, K]
        self.exchange_count += 1
        recv = self.axis.all_to_all(bundle)                  # [S, cap, K]
        halos = recv.reshape(gl.G, len(stale))
        for i, k in enumerate(stale):
            h = self._from_wire(halos[:, i], dts[i])
            new = torch.cat([env[k][:gl.L], h])
            env[k] = new
            self._halo_ok[k] = new

    def _with_halo(self, v):
        """Extend an [L] owned vector to [Lh] with a fresh halo."""
        return torch.cat([v, self._exchange(v)])

    def _reverse_reduce(self, work, mask, edge_lpos, sub, ident):
        """Per-vertex reduce into the *ghost* (source) endpoint: combine the
        edge values per halo position locally, ship each partial back to
        its owner over the reverse all_to_all, and fold per owned vertex
        (the GPS message combiner).  Returns ([L] combine, [L] touched)."""
        gl = self.g
        L, G = gl.L, gl.G
        # sources this shard owns contribute directly into the owned slab
        is_local = edge_lpos < L
        lmask = mask & is_local
        lkeys = torch.where(lmask, edge_lpos, L)
        res_l = _seg(sub, torch.where(lmask, work, ident), lkeys,
                     L + 1)[:L]
        touched_l = _seg("max", lmask.to(torch.int8), lkeys, L + 1)[:L] > 0
        # remote sources: combine per halo position, ship the partial back
        hmask = mask & ~is_local
        gidx = (edge_lpos - L).clamp(0, G - 1)
        part = _seg(sub, torch.where(hmask, work, ident), gidx, G)   # [G]
        hit = _seg("max", hmask.to(torch.int8), gidx, G)

        # consumer row-major [S, cap] -> the owner sees one row per
        # consumer, aligned with send_idx/send_mask
        def back(x):
            return self.axis.all_to_all(
                x.reshape(gl.send_idx.shape)).reshape(-1)
        part_b = back(part)
        hit_b = back(hit.to(torch.int8))
        smask = gl.send_mask.reshape(-1)
        keys = torch.where(smask, gl.send_idx.reshape(-1), L)
        valid = smask & (hit_b > 0)
        res_h = _seg(sub, torch.where(valid, part_b, ident), keys,
                     L + 1)[:L]
        touched_h = _seg("max", valid.to(torch.int8), keys, L + 1)[:L] > 0
        comb = {"add": torch.add, "min": torch.minimum,
                "max": torch.maximum}[sub]
        return comb(res_l, res_h), touched_l | touched_h

    def _ensure_halo(self, key: str, env):
        arr = env[key]
        if self._halo_ok.get(key) is arr:
            return arr
        gl = self.g
        new = torch.cat([arr[:gl.L], self._exchange(arr[:gl.L])])
        env[key] = new
        self._halo_ok[key] = new
        return new

    # ---- local-position resolution ----------------------------------------
    def _lpos(self, name: str, env, ctx):
        """A node-variable driver as positions in the [Lh] node space:
        (lpos, needs_halo), or ("scalar", gid)."""
        if ctx is not None:
            if ctx.kind == "node":
                if name == ctx.var or name in ctx.aliases:
                    return torch.arange(self.g.L, dtype=_I32,
                                        device=self.dev), False
            elif ctx.kind == "edge":
                if name == ctx.inner_var:
                    return ctx.inner_lpos, ctx.inner_is_halo
                if name == ctx.outer_var:
                    return ctx.outer_lpos, ctx.outer_is_halo
                if ctx.parent is not None and (
                        name == ctx.parent.var
                        or name in ctx.parent.aliases):
                    return ctx.outer_lpos, ctx.outer_is_halo
        if name not in env:
            raise LowerError(f"unbound symbol {name}")
        v = env[name]
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            return "scalar", v
        raise LowerError(
            f"cannot resolve node positions for {name} under "
            "vertex-sharded lowering")

    def _owner_read(self, arr, gid):
        """arr[gid] for a global scalar id: the owner contributes, psum."""
        gl = self.g
        lp = self._a(gid, _I32) - gl.gid_base
        owned = (lp >= 0) & (lp < gl.L)
        v = arr[lp.clamp(0, gl.L - 1).long()]
        if v.dtype == _BOOL:
            return self.axis.psum(torch.where(owned, v.to(_I32), 0)) > 0
        return self.axis.psum(torch.where(owned, v, torch.zeros(
            (), dtype=v.dtype, device=v.device)))

    def _owner_write(self, arr, gid, new_val):
        """arr.at[gid].set(val) for a global scalar id: only the owner
        commits."""
        gl = self.g
        lp = self._a(gid, _I32) - gl.gid_base
        owned = (lp >= 0) & (lp < gl.L)
        lpc = lp.clamp(0, gl.L - 1).long()
        nv = torch.where(owned, self._a(new_val).to(arr.dtype), arr[lpc])
        out = arr.clone()
        out[lpc] = nv
        return out

    # ---- identifier / field access ----------------------------------------
    def _ident(self, name, env, ctx):
        # node-loop-local [L] vectors read from an edge ctx: gather at the
        # outer endpoint (with a halo when the outer side is remote)
        if ctx is not None and ctx.kind == "edge" and \
                name not in (ctx.inner_var, ctx.outer_var) and \
                not (ctx.parent is not None and (
                    name == ctx.parent.var or name in ctx.parent.aliases)) \
                and name in env:
            v = env[name]
            if isinstance(v, torch.Tensor) and v.dim() == 1 and \
                    v.shape[0] == self.g.L:
                vh = self._with_halo(v) if ctx.outer_is_halo else v
                return vh[ctx.outer_lpos.clamp(0, vh.shape[0] - 1).long()]
        return super()._ident(name, env, ctx)

    def _field_read(self, f: A.Field, env, ctx):
        key = _F + f.prop
        if key not in env:
            raise LowerError(f"unbound property {f.prop}")
        loc, _dt = self.props[f.prop]
        if loc == "E":
            if ctx is not None and ctx.kind == "edge":
                # any reachable edge identity IS the current slot
                self._edge_slot_driver(f.driver, ctx)
                return env[key]
            if ctx is None:
                # scalar global edge id: the owning shard finds it in its
                # slab by global CSR slot, psum-selects the value
                gid = self._ident(f.driver, env, ctx)
                gl = self.g
                hit = (gl.csr_slot == self._a(gid, _I32)) & gl.emask
                arr = env[key]
                if arr.dtype == _BOOL:
                    w = torch.where(hit, arr.to(_I32), 0)
                    return self.axis.psum(w.max()) > 0
                w = torch.where(hit, arr, torch.zeros(
                    (), dtype=arr.dtype, device=arr.device))
                return self.axis.psum(_sum(w))
            raise LowerError(
                f"edge property {f.prop} access in a {ctx.kind} context "
                "not supported in vertex-sharded lowering")
        r = self._lpos(f.driver, env, ctx)
        if isinstance(r, tuple) and len(r) == 2 and isinstance(r[0], str):
            return self._owner_read(env[key], r[1])
        lpos, needs_halo = r
        arr = self._ensure_halo(key, env) if needs_halo else env[key]
        return arr.index_select(0, lpos)

    def _mark_stale(self, key: str):
        self._halo_ok.pop(key, None)

    def _write_owned(self, env, key, mask_l, val):
        """Masked write of [L]-space values into the [Lh] slab."""
        arr = env[key]
        gl = self.g
        v = self._a(val).to(arr.dtype).expand((gl.L,))
        new = torch.where(mask_l, v, arr[:gl.L])
        self._wr(env, key, torch.cat([new, arr[gl.L:]]))
        self._mark_stale(key)

    # ---- builtins ----------------------------------------------------------
    def _builtin(self, e: A.Builtin, env, ctx):
        name = e.name.lower()
        gl = self.g
        if e.driver is not None and e.driver in self.graphs:
            if ctx is not None and ctx.kind == "node" and \
                    e.driver in ctx.aliases:
                if name in ("degree", "outdegree", "numnbrs"):
                    return gl.deg_out_full[:gl.L]
                if name in ("indegree", "numinnbrs"):
                    return gl.deg_in_full[:gl.L]
            return super()._builtin(e, env, ctx)
        if e.driver is not None and e.driver not in self.collections:
            if name in ("degree", "outdegree", "numnbrs",
                        "indegree", "numinnbrs"):
                deg = (gl.deg_out_full
                       if name in ("degree", "outdegree", "numnbrs")
                       else gl.deg_in_full)
                r = self._lpos(e.driver, env, ctx)
                if isinstance(r, tuple) and len(r) == 2 and \
                        isinstance(r[0], str):
                    return self._owner_read(deg[:gl.L], r[1])
                lpos, _halo = r          # degrees are static: halo valid
                return deg.index_select(0, lpos)
            if name in ("fromnode", "from"):
                self._edge_slot_driver(e.driver, ctx)
                return gl.src_gid
            if name in ("tonode", "to"):
                self._edge_slot_driver(e.driver, ctx)
                return gl.gid_base + gl.dst_lpos
            if name == "toedge":
                if ctx is None or ctx.kind != "edge" or (
                        e.driver != ctx.inner_var
                        and e.driver != ctx.outer_var):
                    raise LowerError("ToEdge() outside a neighbor loop")
                # edge VALUES are global CSR slots (as on one device);
                # property access in the loop resolves to the slab slot
                return gl.csr_slot
        return super()._builtin(e, env, ctx)

    def _edge_slot_driver(self, name: str, ctx):
        """An edge-variable driver must denote the current slot of the
        active edge context (the only edge reachable under vertex
        sharding)."""
        if ctx is not None and ctx.kind == "edge" and (
                (ctx.inner_is_edge and name == ctx.inner_var)
                or name in ctx.locals):
            return
        raise LowerError(
            f"edge variable {name} does not denote the current edge slot "
            "(random edge access is infeasible under vertex sharding)")

    # ---- contexts ----------------------------------------------------------
    def _gid(self):
        gl = self.g
        return gl.gid_base + torch.arange(gl.L, dtype=_I32, device=self.dev)

    def _node_ctx(self, it: A.Iterator, env, ctx, aliases=()):
        if ctx is not None:
            raise LowerError("whole-graph loop nested inside a parallel "
                             "context is not lowerable")
        gid = self._gid()
        return NodeCtx(g=self.g, var=it.var, ids=gid,
                       mask=gid < self.g.num_nodes, aliases=tuple(aliases))

    def _edge_ctx(self, it: A.Iterator, env, ctx):
        gl = self.g
        L = gl.L
        dst_gid = gl.gid_base + gl.dst_lpos
        level_filter = None
        if it.iter_type in ("NBRS", "OUT_NBRS"):
            layout = "csr"
            o_gid, o_lp, o_halo = gl.src_gid, gl.src_lpos, True
            i_gid, i_lp, i_halo = dst_gid, gl.dst_lpos, False
        elif it.iter_type == "IN_NBRS":
            layout = "csc"
            o_gid, o_lp, o_halo = dst_gid, gl.dst_lpos, False
            i_gid, i_lp, i_halo = gl.src_gid, gl.src_lpos, True
        elif it.iter_type in ("UP_NBRS", "DOWN_NBRS"):
            # BFS-tree-relative neighbours inside an InBFS replay: Up =
            # in-neighbours one level shallower, Down = out-neighbours one
            # level deeper; the level array is an [L] owned slab, with a
            # halo for the remote endpoint
            if self._bfs_ctx is None or self._bfs_ctx[0] != it.source:
                raise LowerError(f"{it.iter_type} outside its InBFS "
                                 "body")
            _, level, d = self._bfs_ctx
            if it.iter_type == "UP_NBRS":
                layout = "csc"
                o_gid, o_lp, o_halo = dst_gid, gl.dst_lpos, False
                i_gid, i_lp, i_halo = gl.src_gid, gl.src_lpos, True
                lvl_h = self._with_halo(level)
                level_filter = lvl_h[gl.src_lpos.long()] == (d - 1)
            else:
                layout = "csr"
                o_gid, o_lp, o_halo = gl.src_gid, gl.src_lpos, True
                i_gid, i_lp, i_halo = dst_gid, gl.dst_lpos, False
                level_filter = (
                    (level[gl.dst_lpos.clamp(0, L - 1).long()] == (d + 1))
                    & (gl.dst_lpos < L))
        elif it.iter_type == "EDGES":
            # the loop variable's VALUE is the global CSR slot (matches the
            # single-device edge ids); slab-local access uses lpos
            return VEdgeCtx(
                g=gl, layout="csr", outer_var="", inner_var=it.var,
                outer_ids=gl.src_gid, inner_ids=gl.csr_slot,
                mask=gl.emask, parent=None, inner_is_edge=True,
                outer_lpos=gl.src_lpos, inner_lpos=gl.dst_lpos,
                outer_is_halo=True, inner_is_halo=False)
        else:
            raise LowerError(
                f"iterator {it.iter_type} not supported in vertex-sharded "
                "lowering (rewrite as Nbrs/InNbrs supersteps)")
        mask = gl.emask
        if level_filter is not None:
            mask = mask & level_filter
        src_name = it.source
        if ctx is not None and ctx.kind == "node" and (
                src_name == ctx.var or src_name in ctx.aliases):
            pm = ctx.mask                                   # [L]
            if o_halo:
                pmh = self._with_halo(pm)
                mask = mask & pmh[o_lp.long()]
            else:
                mask = mask & pm[o_lp.clamp(0, L - 1).long()] & (o_lp < L)
            parent = ctx
        elif ctx is None or ctx.kind == "node":
            v = self._ident(src_name, env, ctx)
            mask = mask & (o_gid == v)
            parent = ctx if (ctx is not None and ctx.kind == "node") \
                else None
        else:
            raise LowerError(
                "nested neighbor iteration not supported in "
                "vertex-sharded lowering (the reference GPS backend "
                "rejects two-hop bodies too)")
        return VEdgeCtx(
            g=gl, layout=layout, outer_var=src_name, inner_var=it.var,
            outer_ids=o_gid, inner_ids=i_gid, mask=mask, parent=parent,
            outer_lpos=o_lp, inner_lpos=i_lp,
            outer_is_halo=o_halo, inner_is_halo=i_halo)

    def _wedge_ctx(self, it, layout, env, ctx):
        raise LowerError(
            "nested neighbor iteration not supported in vertex-sharded "
            "lowering")

    # ---- fused halo prefetch ----------------------------------------------
    def _prefetch_halos(self, it: A.Iterator, parts, env, ctx):
        """Before a neighbour loop or reduce, refresh every stale property
        its body reads through the loop's *ghost* endpoint with one fused
        exchange, so that a k-property superstep makes 1 exchange, not k.
        Properties the scan misses still refresh on their own."""
        if it.iter_type not in ("NBRS", "OUT_NBRS", "IN_NBRS"):
            return
        halo_vars = set()
        if it.iter_type in ("NBRS", "OUT_NBRS"):
            # CSR-direction loop: the iterated-from side is the edge source,
            # the remote (halo) endpoint under destination-owner placement;
            # the parent node loop's aliases resolve there too
            halo_vars.add(it.source)
            if ctx is not None and getattr(ctx, "kind", "") == "node" \
                    and (it.source == ctx.var
                         or it.source in ctx.aliases):
                halo_vars.add(ctx.var)
                halo_vars.update(ctx.aliases)
        else:                          # IN_NBRS: the inner (source) side
            halo_vars.add(it.var)
        keys: list = []

        def scan(n):
            if isinstance(n, A.Field) and n.driver in halo_vars:
                loc_dt = self.props.get(n.prop)
                if loc_dt is not None and loc_dt[0] == "N":
                    k = _F + n.prop
                    if k not in keys:
                        keys.append(k)

        for p in parts:
            _walk_ast(p, scan)
        if len(keys) > 1:
            self._ensure_halos(keys, env)

    def _exec_foreach(self, s: A.Foreach, env, ctx):
        self._prefetch_halos(s.iterator, (s.body, s.filter), env, ctx)
        return super()._exec_foreach(s, env, ctx)

    def _reduce_expr(self, e: A.ReduceExpr, env, ctx):
        self._prefetch_halos(e.iterator, (e.body, e.filter), env, ctx)
        return super()._reduce_expr(e, env, ctx)

    # ---- reductions ---------------------------------------------------------
    def _red_work(self, op, vals, mask):
        """(masked work, sub-op, identity) of a master-scalar or per-vertex
        reduce; AND/OR reduce int8 by min/max."""
        if op in ("AND", "OR"):
            sub = "min" if op == "AND" else "max"
            ident = _identity("MIN" if op == "AND" else "MAX", torch.int8,
                              self.dev)
            return torch.where(mask, vals.to(torch.int8), ident), sub, ident
        sub = _SEG_OP.get(op)
        ident = _identity(op, vals.dtype, self.dev) if sub else None
        work = torch.where(mask, vals, ident) if sub else None
        return work, sub, ident

    def _scalar_red(self, work, sub):
        red = {"add": _sum, "min": torch.min, "max": torch.max}[sub]
        return self._pcomb(red(work), sub)

    def _reduce_over_nodes(self, e: A.ReduceExpr, env, nctx: NodeCtx):
        """Node-space reduce: local masked reduce + master-scalar combine
        (the GPS aggregator)."""
        mask = nctx.mask
        if e.filter is not None:
            mask = mask & self.eval(e.filter, env, nctx)
        nctx = nctx.with_mask(mask)
        if e.op == "COUNT" and e.body is None:
            vals = mask.to(_I32)
        else:
            body = self.eval(e.body, env, nctx)
            if e.op == "COUNT":
                vals = (mask & body).to(_I32)
            elif e.op in ("EXIST", "ALL", "AND", "OR"):
                vals = self._a(body)
            else:
                vals = self._a(body).expand(mask.shape)
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND",
              "AVG": "SUM"}.get(e.op, e.op)
        if e.op == "AVG":
            vals = vals.to(_float_dtype())
        if op in ("AND", "OR"):
            work, sub, _ = self._red_work(op, vals.expand(mask.shape), mask)
            return self._scalar_red(work, sub) > 0
        work, sub, _ = self._red_work(op, vals, mask)
        if sub is None:
            raise LowerError(f"{op} over nodes not supported in "
                             "vertex-sharded lowering")
        out = self._scalar_red(work, sub)
        if e.op == "AVG":
            cnt = self._pcomb(mask.to(_float_dtype()).sum(), "add")
            out = out / cnt.clamp(min=1)
        return out

    def _reduce_over_edges(self, e: A.ReduceExpr, env, ectx, outer_ctx):
        """Edge-space reduce over the local slab.  Scalar results psum;
        per-vertex results are owner-local [L] vectors (destination side)
        or come back through the reverse message combine (source side)."""
        mask = ectx.mask
        if e.filter is not None:
            mask = mask & self.eval(e.filter, env, ectx.with_mask(mask))
        ectx = ectx.with_mask(mask)
        if e.op == "COUNT" and e.body is None:
            vals = mask.to(_I32)
        else:
            body = self.eval(e.body, env, ectx)
            if e.op == "COUNT":
                vals = (mask & body).to(_I32)
            else:
                vals = self._a(body).expand(mask.shape)
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND"}.get(e.op, e.op)
        work, seg, ident = self._red_work(op, vals, mask)
        if seg is None:
            raise LowerError(
                f"{op} over neighbors not supported in vertex-sharded "
                "lowering")
        if ectx.inner_is_edge or ectx.parent is None:
            # whole-edge-set / scalar-source neighbourhood -> master scalar
            out = self._scalar_red(work, seg)
            if op in ("AND", "OR"):
                out = out > 0
            if e.op == "AVG":
                cnt = self._pcomb(mask.to(_float_dtype()).sum(), "add")
                out = out.to(_float_dtype()) / cnt.clamp(min=1)
            return None, out
        # per-outer-vertex reduction: local sorted reduce when the outer
        # endpoint is the owned (destination) side; reverse message
        # combine when it is the ghost (source) side
        gl = self.g
        if ectx.outer_is_halo:
            per, _t = self._reverse_reduce(work, mask, ectx.outer_lpos,
                                           seg, ident)
        else:
            per = self._owned_seg(seg, work, gl.dst_lpos)
        if op in ("AND", "OR"):
            per = per > 0
        if e.op == "AVG":
            fm = mask.to(_float_dtype())
            if ectx.outer_is_halo:
                cnt, _t = self._reverse_reduce(
                    fm, mask, ectx.outer_lpos, "add",
                    torch.zeros((), dtype=fm.dtype, device=self.dev))
            else:
                cnt = self._owned_seg("add", fm, gl.dst_lpos)
            per = per.to(_float_dtype()) / cnt.clamp(min=1)
        if outer_ctx is not None and outer_ctx.kind == "node" and (
                ectx.outer_var == outer_ctx.var
                or ectx.outer_var in outer_ctx.aliases):
            return per, None
        raise LowerError(
            "per-vertex neighbor reduction outside its node loop is not "
            "supported in vertex-sharded lowering")

    # ---- scalar winner agreement -------------------------------------------
    def _ctx_order(self, ctx):
        """A globally unique, shard-consistent order key per context slot
        (the single device's tie-break: first achiever in the iterated
        layout's slot order)."""
        if ctx.kind == "node":
            return ctx.ids                   # global vertex id
        return self.g.csr_slot if ctx.layout == "csr" else self.g.gslot

    def _agreed_pick(self, vals, have):
        """The value one shard holds (``have``), sum-selected across the
        axis in a type that keeps it."""
        v = self._a(vals)
        wide = v.to(_float_dtype() if v.dtype.is_floating_point else _I32)
        wide = self.axis.psum(torch.where(have, wide, 0))
        return (wide > 0) if v.dtype == _BOOL else wide.to(v.dtype)

    def _exec_assign(self, s: A.Assign, env, ctx):
        lhs = s.lhs
        if isinstance(lhs, A.MapAccess):
            raise LowerError("maps not supported in vertex-sharded "
                             "lowering")
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if dt is not None:
                val = _coerce(val, dt)
            if ctx is not None and lhs.name not in ctx.locals and \
                    lhs.name in env and not (
                        isinstance(env[lhs.name], torch.Tensor)
                        and env[lhs.name].dim() >= 1):
                # scalar WW race: the lowest-GLOBAL-order winner, agreed
                # across shards
                vv = self._a(val)
                cur = _coerce(env[lhs.name], vv.dtype)
                any_l = ctx.mask.to(torch.int8).max()
                anyg = self._pcomb(any_l, "max") > 0
                if vv.dim() == 0:
                    self._wr(env, lhs.name, torch.where(anyg, vv, cur))
                    return
                order = self._ctx_order(ctx)
                cand = torch.where(ctx.mask, order.to(_I32), INT32_MAX)
                loc_best = cand.min()
                glob_best = self._pcomb(loc_best, "min")
                have = (loc_best == glob_best) & (loc_best < INT32_MAX)
                win = self._agreed_pick(vv[torch.argmin(cand)], have)
                self._wr(env, lhs.name, torch.where(anyg, win, cur))
                return
            self._wr(env, lhs.name, val)
            return
        if isinstance(lhs, A.Field):
            self._exec_field_assign(lhs, s.rhs, env, ctx)
            return
        raise LowerError(
            f"assignment to {type(lhs).__name__} not lowerable")

    def _exec_field_assign(self, lhs: A.Field, rhs, env, ctx):
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        gl = self.g
        if lhs.driver in self.graphs:
            # group assignment G.prop = expr
            if loc == "N":
                gid = self._gid()
                nctx = NodeCtx(g=gl, var="", ids=gid,
                               mask=gid < gl.num_nodes,
                               aliases=(lhs.driver,))
                val = _coerce(self.eval(rhs, env, nctx), dt)
                self._write_owned(env, key, nctx.mask, val)
            else:
                ectx = self._edge_ctx(
                    A.Iterator(var="", source=lhs.driver,
                               iter_type="EDGES"), env, None)
                val = _coerce(self.eval(rhs, env, ectx), dt)
                self._wr(env, key, torch.where(gl.emask,
                                               val.expand(arr.shape), arr))
            return
        if ctx is not None and ctx.kind == "node" and \
                lhs.driver == ctx.var:
            val = _coerce(self.eval(rhs, env, ctx), dt)
            self._write_owned(env, key, ctx.mask, val)
            return
        if ctx is not None and ctx.kind == "edge":
            if loc == "E" and ((ctx.inner_is_edge and
                                lhs.driver == ctx.inner_var)
                               or lhs.driver in ctx.locals):
                val = _coerce(self.eval(rhs, env, ctx), dt)
                self._wr(env, key, torch.where(
                    ctx.mask, val.expand(arr.shape), arr))
                return
            raise LowerError(
                f"write to {lhs.driver}.{lhs.prop} in a neighbor loop is "
                "a random scatter; not supported in vertex-sharded "
                "lowering (the reference GPS backend rejects these too)")
        # self-update pattern x.p = x.p + e -> the equivalent reduction
        if ctx is not None and isinstance(rhs, A.BinOp) and \
                rhs.op in ("+", "*") and isinstance(rhs.lhs, A.Field) and \
                rhs.lhs.prop == lhs.prop and rhs.lhs.driver == lhs.driver:
            red = A.ReduceAssign(lhs=lhs, op="SUM" if rhs.op == "+"
                                 else "MULT", rhs=rhs.rhs, bind=None)
            self._exec_reduce_assign(red, env, ctx)
            return
        if ctx is None:
            # scalar global-id driver (root.dist = 0): the owner commits
            gid = self._ident(lhs.driver, env, ctx)
            val = _coerce(self.eval(rhs, env, ctx), dt)
            if loc == "E":
                hit = (gl.csr_slot == self._a(gid, _I32)) & gl.emask
                self._wr(env, key, torch.where(hit, val.to(arr.dtype), arr))
                return
            self._wr(env, key, self._owner_write(arr, gid, val))
            self._mark_stale(key)
            return
        raise LowerError(
            f"assignment to {lhs.driver}.{lhs.prop} in a {ctx.kind} "
            "context not supported in vertex-sharded lowering")

    def _exec_reduce_assign(self, s: A.ReduceAssign, env, ctx):
        op = s.op
        lhs = s.lhs
        if isinstance(lhs, A.MapAccess):
            raise LowerError("maps not supported in vertex-sharded "
                             "lowering")
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if ctx is None:
                cur = env[lhs.name]
                self._wr(env, lhs.name,
                         _coerce(_combine(op, cur, val), dt))
                return
            # a local of an ENCLOSING parallel context is a per-lane
            # accumulator whose edge slots live on destination-owner
            # shards: rejected with a remedy instead of a silently global
            # sum (the Sum()-expression and property forms distribute)
            c = getattr(ctx, "parent", None)
            while c is not None:
                if lhs.name in c.locals:
                    raise LowerError(
                        f"reduction into '{lhs.name}', a local of an "
                        "enclosing parallel loop, is not vertex-"
                        "shardable — rewrite as a Sum/Min/Max(...) "
                        "expression or reduce into a node property")
                c = getattr(c, "parent", None)
            # scalar reduce over a parallel context: local masked reduce,
            # then the master-scalar combine across shards
            vals = self._a(val).expand(ctx.mask.shape)
            work, sub, _ = self._red_work(op, vals, ctx.mask)
            if sub is None:
                raise LowerError(f"{op}= not supported in "
                                 "vertex-sharded lowering")
            r = self._scalar_red(work, sub)
            if op in ("AND", "OR"):
                r = r > 0
            cur = env[lhs.name]
            self._wr(env, lhs.name, _coerce(_combine(op, cur, r), dt))
            return
        if not isinstance(lhs, A.Field):
            raise LowerError("reduce target must be scalar or field")
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        gl = self.g
        if ctx is None:
            # scalar global-id driver: the owner reads, modifies, writes
            if loc != "N":
                raise LowerError("scalar edge-property reduce not "
                                 "supported in vertex-sharded lowering")
            gid = self._ident(lhs.driver, env, ctx)
            val = self.eval(s.rhs, env, ctx)
            cur = self._owner_read(arr, gid)
            self._wr(env, key, self._owner_write(
                arr, gid, _coerce(_combine(op, cur, val), dt)))
            self._mark_stale(key)
            return
        if ctx.kind == "node" and lhs.driver == ctx.var:
            val = self.eval(s.rhs, env, ctx)
            vv = self._a(val).expand((gl.L,))
            new = _coerce(_combine(op, arr[:gl.L], vv), dt)
            self._write_owned(env, key, ctx.mask, new)
            return
        if ctx.kind == "node" and loc == "N":
            raise LowerError(
                f"reduce into {lhs.driver}.{lhs.prop} keyed by a computed "
                "node id is a random scatter; not supported in "
                "vertex-sharded lowering (the reference GPS backend "
                "rejects random writes too)")
        if ctx.kind == "edge":
            if loc != "N":
                raise LowerError("edge-property reduce in a neighbor "
                                 "loop not supported in vertex-sharded "
                                 "lowering")
            val = self.eval(s.rhs, env, ctx)
            vals = self._a(val).expand(ctx.mask.shape)
            work, sub, ident = self._red_work(op, vals, ctx.mask)
            if sub is None:
                raise LowerError(f"{op}= over neighbors not supported")
            if lhs.driver == ctx.inner_var:
                keys, is_halo = ctx.inner_lpos, ctx.inner_is_halo
            elif lhs.driver == ctx.outer_var or (
                    ctx.parent is not None and (
                        lhs.driver == ctx.parent.var
                        or lhs.driver in ctx.parent.aliases)):
                keys, is_halo = ctx.outer_lpos, ctx.outer_is_halo
            else:
                raise LowerError(
                    f"reduce into {lhs.driver}.{lhs.prop} from edge ctx")
            if is_halo:
                # write "against" the edge placement: combine per ghost
                # position and ship the partials back to the owner
                seg, touched = self._reverse_reduce(
                    work, ctx.mask, keys, sub, ident)
            else:
                seg = self._owned_seg(sub, work, keys)
                touched = _seg("max", ctx.mask.to(torch.int8), keys,
                               gl.L + 1)[:gl.L] > 0
            if op in ("AND", "OR"):
                new = _combine(op, arr[:gl.L], seg > 0)
            else:
                new = _coerce(_combine(op, arr[:gl.L],
                                       seg.to(arr.dtype)), dt)
            self._write_owned(env, key, touched, new)
            return
        raise LowerError("unsupported reduce-assign placement in "
                         "vertex-sharded lowering")

    def _exec_defer(self, s: A.DeferAssign, env, ctx):
        if ctx is None:
            self._exec_assign(A.Assign(lhs=s.lhs, rhs=s.rhs), env, ctx)
            return
        if not isinstance(s.lhs, A.Field):
            raise LowerError("deferred write target must be a field")
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        gl = self.g
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        if ctx.kind == "node" and s.lhs.driver == ctx.var:
            # pad the [L]-space mask and value to the [Lh] slab the generic
            # defer-apply writes (the halo stays untouched -> stale)
            vfull = torch.zeros(gl.n_pad, dtype=dt, device=self.dev)
            vfull[:gl.L] = val.to(dt).expand((gl.L,))
            mfull = torch.zeros(gl.n_pad, dtype=_BOOL, device=self.dev)
            mfull[:gl.L] = ctx.mask
            pend = (key, mfull, vfull)
            self._mark_stale(key)
        else:
            raise LowerError("deferred write outside its bound node loop "
                             "not lowerable yet")
        if not self._defer_stack:
            raise LowerError("deferred write outside any loop")
        bind = s.bind
        for name, lst in reversed(self._defer_stack):
            if bind is None or name == bind:
                lst.append(pend)
                return
        self._defer_stack[-1][1].append(pend)

    # ---- argmin/argmax ------------------------------------------------------
    def _exec_argminmax(self, s, env, ctx):
        is_min = s.op == "MIN"
        if ctx is None or ctx.kind == "node" or isinstance(s.lhs, A.Ident):
            self._argminmax_scalar_or_node(s, env, ctx, is_min)
            return
        if not isinstance(s.lhs, A.Field) or s.lhs.driver != ctx.inner_var:
            raise LowerError("argmin/argmax target must be keyed by the "
                             "neighbor variable in a neighbor loop")
        if ctx.inner_is_halo:
            raise LowerError(
                "argmin/argmax into the ghost (source) endpoint of an "
                "InNbrs loop — iterate Nbrs instead")
        gl = self.g
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        old = env[key]
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        ident = _identity("MIN" if is_min else "MAX", dt, self.dev)
        work = torch.where(ctx.mask, val.expand(ctx.mask.shape), ident)
        m = self._owned_seg("min" if is_min else "max", work,
                            ctx.inner_lpos)
        old_l = old[:gl.L]
        improved = (m < old_l) if is_min else (m > old_l)
        self._write_owned(env, key, improved, m)
        if not s.lhs_extra:
            return
        # payload select: each destination is owned by exactly one shard,
        # so the winner (lowest local slot among the achievers) needs no
        # cross-shard agreement
        extra_vals = [self.eval(r, env, ctx) for r in s.rhs_extra]
        need_slot = any(self._a(v).dim() >= 1 for v in extra_vals)
        win_slot = None
        if need_slot:
            slot_ids = torch.arange(gl.e_pad, dtype=_I32, device=self.dev)
            win = ctx.mask & (work == m[ctx.inner_lpos.clamp(
                0, gl.L - 1).long()])
            cand = torch.where(win, slot_ids, gl.e_pad)
            win_slot = self._owned_seg("min", cand, ctx.inner_lpos)
            win_slot = win_slot.clamp(max=gl.e_pad - 1).long()
        for lhs_e, rhs_v in zip(s.lhs_extra, extra_vals):
            if not isinstance(lhs_e, A.Field) or \
                    lhs_e.driver != ctx.inner_var:
                raise LowerError("argminmax payload target must be keyed "
                                 "by the same neighbor variable")
            eloc, edt = self.props[lhs_e.prop]
            if eloc != "N":
                raise LowerError("edge-property argminmax payload not "
                                 "supported in vertex-sharded lowering")
            rv = self._a(rhs_v)
            if rv.dim() >= 1:
                payload = _coerce(rv, edt)[win_slot]
            else:
                payload = _coerce(rv, edt).expand((gl.L,))
            self._write_owned(env, _F + lhs_e.prop, improved, payload)

    def _argminmax_scalar_or_node(self, s, env, ctx, is_min):
        if ctx is None:
            raise LowerError("scalar argminmax outside a loop")
        if not isinstance(s.lhs, A.Ident):
            raise LowerError("scalar argminmax target must be an ident")
        dt = self._target_dtype(s.lhs, env)
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        ident = _identity("MIN" if is_min else "MAX", dt, self.dev)
        work = torch.where(ctx.mask, val.expand(ctx.mask.shape), ident)
        loc_best = work.min() if is_min else work.max()
        best = self._pcomb(loc_best, "min" if is_min else "max")
        cur = self._a(env[s.lhs.name])
        improved = (best < cur) if is_min else (best > cur)
        self._wr(env, s.lhs.name, torch.where(improved, best, cur))
        if not s.lhs_extra:
            return
        # winner agreement: among the achieving slots the lowest global
        # order key wins; its payload is psum-selected (one shard has it)
        order = self._ctx_order(ctx).to(_I32)
        cand = torch.where(ctx.mask & (work == best), order, INT32_MAX)
        loc_ord = cand.min()
        glob_ord = self._pcomb(loc_ord, "min")
        have = (loc_ord == glob_ord) & (loc_ord < INT32_MAX)
        idx = torch.argmin(cand)
        for lhs_e, rhs_e in zip(s.lhs_extra, s.rhs_extra):
            if not isinstance(lhs_e, A.Ident):
                raise LowerError("scalar argminmax payload must be ident")
            pv = self._a(self.eval(rhs_e, env, ctx))
            pick = pv[idx] if pv.dim() >= 1 else pv
            edt = self._target_dtype(lhs_e, env)
            if edt is not None:
                pick = _coerce(pick, edt)
            agreed = self._agreed_pick(pick, have)
            self._wr(env, lhs_e.name, torch.where(
                improved, agreed, self._a(env[lhs_e.name])))

    # ---- feasibility rejections --------------------------------------------
    def _exec_vardecl(self, s, env, ctx):
        t = s.type
        if t.kind in ("NSET", "NSEQ", "NORDER", "MAP") or (
                t.is_property() and getattr(t.elem, "kind", None)
                == "NSET"):
            raise LowerError(
                "collections/maps not supported in vertex-sharded "
                "lowering (node-set state is not vertex-partitionable "
                "yet)")
        return super()._exec_vardecl(s, env, ctx)

    def _exec_bfs(self, s, env, ctx):
        """InBFS under vertex sharding: level-sync frontier expansion over
        the owned slab with one ghost exchange per level (the GPS
        ``transform_bfs`` level-sync rewrite), then the per-level replay of
        the forward and reverse bodies.  InDFS is rejected (inherently
        sequential, as in the reference GPS backend)."""
        if not s.is_bfs:
            raise LowerError("InDFS not supported in vertex-sharded "
                             "lowering (inherently sequential)")
        if ctx is not None:
            raise LowerError("InBFS nested inside a parallel loop")
        gl = self.g
        root = self._ident(s.root, env, None)
        gid = self._gid()
        owned = gid < gl.num_nodes
        allowed = None
        if s.navigator is not None:
            nctx = NodeCtx(g=gl, var=s.var, ids=gid, mask=owned)
            allowed = self._a(self.eval(s.navigator, env, nctx)).expand(
                (gl.L,)).to(_BOOL)
        level, depth = self._bfs_levels(root, s.transpose, allowed)
        env["__bfs_level$" + s.var] = level
        self._replay_bfs(s, env, level, depth, gid, owned)

    def _bfs_levels(self, root, transpose: bool, allowed):
        gl = self.g
        L = gl.L
        gid = self._gid()
        mask = gid < gl.num_nodes
        if allowed is not None:
            mask = mask & allowed
        rootv = self._a(root, _I32)
        is_root = gid == rootv
        level = torch.where(is_root & (gid < gl.num_nodes), 0,
                            INT32_MAX).to(_I32)
        level = torch.where(mask | is_root, level, INT32_MAX).to(_I32)
        d, go = 0, True
        while go:
            fr = (level == d) & mask                         # [L] owned
            if transpose:
                # BFS over G^: v joins when some OUT-neighbour w is in the
                # frontier; edge v->w sits on w's owner (the destination
                # side), so the per-v reduction is a reverse message
                # combine back to v's owner
                dst_ok = fr[gl.dst_lpos.clamp(0, L - 1).long()] & \
                    (gl.dst_lpos < L)
                em = gl.emask & dst_ok
                work = em.to(torch.int8)
                reach_l, _t = self._reverse_reduce(
                    work, em, gl.src_lpos, "max",
                    torch.zeros((), dtype=torch.int8, device=self.dev))
                reach = reach_l > 0
            else:
                frh = self._with_halo(fr)
                vals = (gl.emask & frh[gl.src_lpos.long()]).to(_I32)
                reach = self._owned_seg("max", vals, gl.dst_lpos) > 0
            newly = reach & (level == INT32_MAX) & mask
            level = torch.where(newly, d + 1, level).to(_I32)
            go = self.axis.agree(bool(self.axis.psum(
                newly.sum(dtype=_I32)) > 0))
            d += 1
        return level, d

    def _replay_bfs(self, s, env, level, depth, gid, owned):
        """The per-level replay (``lower_bfs._replay_traced``) over [L]
        owned contexts."""
        from .lower import _DONE, declared_keys, uses_rng

        def run_phase(body, filt, reverse):
            if body is None:
                return
            if uses_rng(body):
                raise LowerError("RNG inside a sharded InBFS body")
            carry_keys = sorted((written_keys(body) - declared_keys(body))
                                - {_RET, _DONE})
            for k in carry_keys:
                if k not in env:
                    raise LowerError(f"BFS body writes undeclared {k}")
            dtypes = [env[k].dtype if isinstance(env[k], torch.Tensor)
                      else None for k in carry_keys]
            for i in range(depth + 1):
                d = depth - i if reverse else i
                e2 = dict(env)
                m = owned & (level == d)
                nctx = NodeCtx(g=self.g, var=s.var, ids=gid, mask=m)
                if s.navigator is not None and not reverse:
                    nctx = nctx.with_mask(nctx.mask & self._a(self.eval(
                        s.navigator, e2, nctx)).expand(m.shape))
                if filt is not None:
                    nctx = nctx.with_mask(nctx.mask & self._a(self.eval(
                        filt, e2, nctx)).expand(m.shape))
                self._bfs_ctx = (s.var, level, d)
                try:
                    self._defer_stack.append((s.var, []))
                    try:
                        self.exec_stmt(body, e2, nctx)
                    finally:
                        _, pend = self._defer_stack.pop()
                    self._apply_pending(e2, pend)
                finally:
                    self._bfs_ctx = None
                for k, dt in zip(carry_keys, dtypes):
                    env[k] = (self._a(e2[k]).to(dt) if dt is not None
                              else e2[k])

        run_phase(s.body_fw, s.filter_fw, False)
        run_phase(s.body_bw, s.filter_bw, True)

    def _exec_for_items(self, s, env, ctx):
        raise LowerError("collection iteration not supported in "
                         "vertex-sharded lowering")

    def _exec_for_nbrs_eager(self, s, env):
        raise LowerError("sequential neighbor loop not supported in "
                         "vertex-sharded lowering")

    def _exec_for_nodes_eager(self, s, env):
        raise LowerError("sequential node loop not supported in "
                         "vertex-sharded lowering")

    def _exec_while_eager(self, s, env, max_iters=1_000_000):
        raise LowerError("host-eager While not supported in "
                         "vertex-sharded lowering")

    def _exec_while(self, s, env, ctx):
        from .lower import contains_bfs
        if ctx is None and contains_bfs(s.body) and \
                not (self._uses_map(s.body) or self._uses_map(s.cond)):
            # the sharded BFS replay runs in any loop, so a While holding
            # one takes the ordinary path (one device must replay it on
            # the host instead)
            return self._exec_while_traced(s, env)
        return super()._exec_while(s, env, ctx)


# ---------------------------------------------------------------------------
# Public driver
# ---------------------------------------------------------------------------

def run_vertex_sharded(cp: CompiledProc, g: Graph, *args,
                       mesh: Optional[Mesh] = None, axis: str = "v",
                       sched: Optional[VertexSchedule] = None,
                       stats: Optional[Dict] = None,
                       placements: Optional[Dict[str, str]] = None,
                       **kwargs) -> Dict:
    """Execute a compiled procedure vertex-sharded over ``mesh[axis]``.

    The call convention and result dict of ``cp(g, *args, **kwargs)``;
    node-property results come back in the global [N_pad] layout.  Pass a
    prebuilt (placed) ``sched`` to reuse the host partition build.
    ``stats["exchanges"]`` receives the ghost exchanges one shard made.

    ``placements`` is the per-array user override (Shoal's
    ``local_array_settings.lua``, ``scripts/run.sh:218-246``):
    ``{array_name: "replicate"|"distribute"}``.  ``distribute`` is the
    automatic decision (owned O(N/S) slab + ghost halo).  ``replicate``
    pins a READ-ONLY input node property: its halo is filled at bind time
    and stays fresh, so it never rides the superstep exchange.  Written
    properties and edge properties are rejected with ``LowerError``."""
    if mesh is None:
        mesh = vmesh(None, axis, g.device.type)
    S = mesh.shape[axis]
    if sched is None:
        sched = place_schedule(build_schedule(g, S), mesh, axis)
    dev = g.device

    # ---- host-side argument walk (mirrors CompiledProc._bind) ----------
    lw0 = Lowerer(cp.proc, g)
    pos = list(args)
    graph_names = []
    nprops: Dict[str, Tuple[object, object]] = {}
    eprops: Dict[str, Tuple[object, object]] = {}
    scalars: Dict[str, torch.Tensor] = {}
    alloc = []                      # (name, loc, dt) allocated per shard
    out_names = []
    prop_loc: Dict[str, str] = {}

    def bind_prop(name, val):
        loc, dt = lw0.props[name]
        if dt == "NSET":
            raise LowerError("N_P<Node_Set> not supported in "
                             "vertex-sharded lowering")
        prop_loc[name] = loc
        (nprops if loc == "N" else eprops)[name] = (val, dt)

    for decl in cp.proc.args:
        for name in decl.names:
            if decl.type.kind == "GRAPH":
                graph_names.append(name)
                continue
            if decl.type.kind in ("NSET", "NSEQ", "NORDER", "MAP") or \
                    decl.type.is_collection():
                raise LowerError(
                    f"collection argument {name} not supported in "
                    "vertex-sharded lowering")
            if name in kwargs:
                val = kwargs[name]
            elif pos:
                val = pos.pop(0)
            elif decl.type.is_property():
                loc, dt = lw0.props[name]
                if dt == "NSET":
                    raise LowerError("N_P<Node_Set> not supported in "
                                     "vertex-sharded lowering")
                prop_loc[name] = loc
                out_names.append(name)
                alloc.append((name, loc, dt))
                continue
            else:
                raise TypeError(f"missing argument {name}")
            if decl.type.is_property():
                bind_prop(name, val)
            else:
                scalars[name] = _coerce(_asarray(val),
                                        dtype_of_kind(decl.type.kind))
    for decl in cp.proc.out_args:
        for name in decl.names:
            out_names.append(name)
            if decl.type.is_property():
                if name in kwargs:
                    bind_prop(name, kwargs[name])
                else:
                    loc, dt = lw0.props[name]
                    prop_loc[name] = loc
                    alloc.append((name, loc, dt))
            else:
                scalars[name] = _coerce(_asarray(kwargs.get(name, 0)),
                                        dtype_of_kind(decl.type.kind))

    # ---- per-array user overrides (validated against the bound set) ----
    repl_names = set()
    wkeys = written_keys(cp.proc.body) if placements else ()
    for name, pol in (placements or {}).items():
        pol = str(pol).lower()
        if pol not in ("replicate", "distribute"):
            raise LowerError(
                f"unknown placement policy '{pol}' for array "
                f"'{name}' (replicate|distribute)")
        if name not in nprops and name not in eprops:
            known = sorted(list(nprops) + list(eprops)) or ["<none>"]
            raise LowerError(
                f"placement override names unknown array '{name}' "
                f"(bound input properties: {', '.join(known)})")
        if pol == "distribute":
            continue            # the automatic decision; accepted as-is
        if name in eprops:
            raise LowerError(
                f"edge property '{name}' cannot be replicated: the "
                "edge arrays define the vertex partition itself")
        if (_F + name) in wkeys:
            raise LowerError(
                f"array '{name}' is written by {cp.proc.name} — a "
                "replicated copy would diverge across shards; only "
                "read-only inputs can be replicated")
        repl_names.add(name)

    # ---- slab conversion ------------------------------------------------
    L, Gh = sched.L, sched.G
    N = g.num_nodes
    tot = S * L
    nslabs = {}
    for name, (val, dt) in nprops.items():
        a = _coerce(_asarray(val, dev), dt)
        if a.shape[0] < tot:
            a = torch.nn.functional.pad(a, (0, tot - a.shape[0]))
        owned = a[:tot].reshape(S, L)
        if name in repl_names and Gh > 0:
            # replicate: the halo filled from the global array, so that the
            # property never needs a superstep exchange (pad slots clip to
            # a valid index; no real edge reads them)
            gg = _whole(sched.ghost_gid).to(dev).clamp(0, tot - 1).long()
            nslabs[name] = torch.cat([owned, a[gg]], dim=1)
        else:
            nslabs[name] = owned
    eslabs = {}
    for name, (val, dt) in eprops.items():
        a = _coerce(_asarray(val, dev), dt)
        if a.shape[0] < g.e_pad:
            a = torch.nn.functional.pad(a, (0, g.e_pad - a.shape[0]))
        slot = _whole(sched.csr_slot).to(dev).clamp(0, a.shape[0] - 1)
        eslabs[name] = torch.where(_whole(sched.emask).to(dev),
                                   a[slot.long()], 0).to(a.dtype)
    has_ret = _RET in written_keys(cp.proc.body)
    sched_rows = {f: getattr(sched, f) for f in _SCHED_FIELDS}

    def body(axes, rows, nsl, esl, scal):
        ax = axes[axis]
        rows = {k: v.reshape(v.shape[1:]) for k, v in rows.items()}
        gl = LocalView(sched, ax.index() * L, rows)
        lw = VertexLowerer(cp.proc, gl, axis=ax)
        env: Dict = {}
        for gn in graph_names:
            env[gn] = gl
        for name, slab in nsl.items():
            slab = slab.reshape(slab.shape[1:])
            if name in repl_names and Gh > 0:
                # user-pinned: the halo is filled and marked fresh for
                # good, so no exchange ever carries this property
                env[_F + name] = slab
                lw._halo_ok[_F + name] = slab
            else:
                env[_F + name] = torch.cat(
                    [slab, torch.zeros(Gh, dtype=slab.dtype,
                                       device=slab.device)])
        for name, slab in esl.items():
            env[_F + name] = slab.reshape(slab.shape[1:])
        for name, v in scal.items():
            env[name] = v
        for name, loc, dt in alloc:
            env[_F + name] = (gl.node_prop(0, dt) if loc == "N"
                              else gl.edge_prop(0, dt))
        lw.run(env)
        if stats is not None and ax.index() == 0:
            stats["exchanges"] = lw.exchange_count
        sharded, rep = {}, {}
        for name in out_names:
            if prop_loc.get(name) == "N":
                sharded[name] = env[_F + name][:L]
            elif prop_loc.get(name) == "E":
                sharded[name] = env[_F + name]
            else:
                rep[name] = env.get(name)
        if has_ret:
            rep["_return"] = env[_RET]
        return sharded, rep

    sharded, rep = shard_map(
        body, mesh, (P(axis), P(axis), P(axis), P()),
        (P(axis), P()))(sched_rows, nslabs, eslabs, scalars)

    # node-prop outputs arrive as [S*L] slabs -> the [N_pad] layout;
    # edge-prop outputs as [S*E_s] slabs -> scattered back to CSR order
    res = {}
    for name, v in sharded.items():
        if prop_loc.get(name) == "N":
            res[name] = torch.cat([v[:N], torch.zeros(
                g.n_pad - N, dtype=v.dtype, device=v.device)])
        else:
            tgt = torch.where(_whole(sched.emask).to(v.device),
                              _whole(sched.csr_slot).to(v.device),
                              g.e_pad).reshape(-1).long()
            out = torch.zeros(g.e_pad + 1, dtype=v.dtype, device=v.device)
            out[tgt] = v.reshape(-1)
            res[name] = out[:g.e_pad]
    for name in out_names:
        if name in rep:
            res[name] = rep[name]
    if "_return" in rep:
        res["_return"] = rep["_return"]
    return {k: res[k] for k in out_names + (["_return"] if has_ret else [])}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def placement_report(sched: VertexSchedule, n_props: int = 1,
                     placements: Optional[Dict[str, str]] = None) -> str:
    """Per-array placement table of the compiled distributed path (the
    Shoal decision table, ``gm_cpp_gen.cc:229-305``); ``placements`` adds
    one row per user-pinned array."""
    rows = []
    S = sched.num_shards
    for f in ("dst_lpos", "src_lpos", "src_gid", "emask", "csr_slot",
              "send_idx", "deg_out", "csc_off"):
        a = getattr(sched, f)
        size = a.numel()
        per_dev = (size // S) * _itemsize(a.dtype)
        shp = "x".join(str(d) for d in a.shape)
        rows.append(f"Array[{f}]: elements={size} global={shp} "
                    f"bytes/device={per_dev} -- "
                    f"replication=[ ] distribution=[X]")
    rows.append(f"Array[node_prop]: elements={S * sched.Lh} "
                f"global={S}x{sched.Lh} "
                f"bytes/device={sched.Lh * 4} -- "
                f"replication=[ ] distribution=[X] "
                f"(owned={sched.L} + halo={sched.G})")
    for name, pol in sorted((placements or {}).items()):
        rep = str(pol).lower() == "replicate"
        per_dev = (sched.Lh if rep else sched.L) * 4
        rows.append(f"Array[{name}]: elements={S * sched.L} "
                    f"global={S}x{sched.L} bytes/device={per_dev} -- "
                    f"replication=[{'X' if rep else ' '}] "
                    f"distribution=[{' ' if rep else 'X'}] "
                    "(pinned by user"
                    + (", halo pre-filled, no exchange)" if rep else ")"))
    rows.append(f"# ghost exchange: total={sched.ghost_total} ids, "
                f"cap={sched.cap}/pair, "
                f"bytes/superstep/device={S * sched.cap * 4}")
    return "\n".join(rows)
