"""Lowering: typechecked Green-Marl AST -> a vectorized PyTorch program.

Counterpart of ``green_marl_tpu/lang/lower.py``, with the same results.
Instead of emitting C++ with ``#pragma omp parallel for`` over CSR ranges
and atomic reductions (the reference's ``gm_cpp_gen.cc``), the AST is
vectorized directly into tensor operations:

==========================  =================================================
reference construct          lowering
==========================  =================================================
``Foreach(n: G.Nodes)``      masked dense ops over the padded node axis
``Foreach(s: n.Nbrs)`` +     gather over CSR/CSC slots + fixed-order segment
reduction                    reduction (``ops.segment.sorted_segment_reduce``:
                             the segment-reduce and prefix-sum kernels)
``x min= v @ n`` / argminmax scatter-min + win-mask payload select
``t.p <= v @ t`` (defer)     pending write applied at loop exit
``Do/While``                 a host loop over the body, one host read of the
                             condition per pass; the carry is the statically
                             computed write-set of the body
``If`` (scalar)              one branch on a concrete condition, both
                             branches and a ``where`` merge on a traced one
``If`` (inside Foreach)      mask refinement
==========================  =================================================

Everything runs eagerly.  The JAX package runs a ``While`` body as one
traced ``lax.while_loop`` region, and some of its results depend on that:
a traced value cannot steer the host (an ``If`` on it runs both branches,
a sequential loop over it is refused with ``LowerError``), and a draw site
keeps one number for every pass of a traced body.  The lowerer keeps both
rules: inside such a region every tensor the region computes counts as
traced (``Lowerer._traced``), and each pass of the body reuses the draw
sites of the first.

``CompiledProc.batch`` runs many instances in lockstep, as the JAX
package's ``vmap`` does: what depends on a batched argument is a lane value
(``runtime.lanes.Lanes``, lane axis leading) and counts as traced, the rest
is computed once.  A ``While`` whose predicate depends on the lanes runs
while any lane's holds, one pass for all of them, and a lane whose
predicate is false keeps its carry; a pull over ``[B, E_pad]`` values is one
launch of the lane-batched kernels.

dtypes: INT/LONG/NODE/EDGE -> int32, FLOAT/DOUBLE -> ``torch.
get_default_dtype()`` (float32, or float64 where the caller set it, as JAX's
x64 flag does), BOOL -> bool.  ``INF`` saturates to the integer extrema
when coerced.  Indexing follows JAX's rules: gathers wrap negative indices
once and clamp, scatters wrap once and drop the rest
(``runtime.collections.take``/``put``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from . import gm_ast as A
from .typecheck import typecheck
from ..graph.csr import ARRAY_FIELDS, Graph, round_up
from ..ops import segment as ops
from ..runtime import lanes as LN
from ..runtime import rng as R
from ..runtime.collections import (DenseNodeMap, NodeOrder, NodeSeq,
                                   NodeSet, put, put2, take,
                                   tree_leaves, tree_map)
from ..utils.timing import span

_I32 = torch.int32
_BOOL = torch.bool
_INT32_MAX = torch.iinfo(torch.int32).max
_INT32_MIN = torch.iinfo(torch.int32).min


class RaceWarning(UserWarning):
    """A parallel write-write/read-write conflict detected by RW analysis.

    Mirrors the reference's ``gm_rw_analysis_check2.cc`` conflict report,
    where WW/RW conflicts are warnings and compilation proceeds with
    last-store-wins semantics; the lowering substitutes a deterministic
    lowest-slot winner."""


class LowerError(Exception):
    """Construct outside the lowerable subset (cf. check_feasible)."""


# --------------------------------------------------------------------------
# dtype machinery
# --------------------------------------------------------------------------

def _float_dtype():
    return torch.get_default_dtype()


def dtype_of_kind(kind: str):
    if kind in ("INT", "LONG", "NODE", "EDGE"):
        return _I32
    if kind in ("FLOAT", "DOUBLE"):
        return _float_dtype()
    if kind == "BOOL":
        return _BOOL
    raise LowerError(f"no dtype for type kind {kind}")


def _is_int(dt) -> bool:
    return not dt.is_floating_point and dt != _BOOL


def _asarray(x, device=None, dtype=None) -> torch.Tensor:
    """``jnp.asarray``: a Python bool/int/float becomes bool/int32/the float
    dtype; numpy's 64-bit types narrow as JAX narrows them without x64."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
        return t if dtype is None else t.to(dtype)
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        if a.dtype == np.int64 or a.dtype == np.uint64:
            a = a.astype(np.int32)
        elif a.dtype == np.float64 and _float_dtype() == torch.float32:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device or "cpu")
        return t if dtype is None else t.to(dtype)
    if isinstance(x, (list, tuple)):
        return _asarray(np.asarray(x), device, dtype)
    if isinstance(x, bool):
        dt = _BOOL
    elif isinstance(x, int):
        dt = _I32
    else:
        dt = _float_dtype()
    return torch.tensor(x, dtype=dtype or dt, device=device)


def _coerce(val, dtype, device=None):
    """Cast honoring the reference's INF saturation: +/-inf -> int
    extrema (and, as XLA converts, any float out of range saturates and NaN
    becomes 0)."""
    val = _asarray(val, device)
    if _is_int(dtype) and val.dtype.is_floating_point:
        info = torch.iinfo(dtype)
        hi = val >= float(info.max)
        lo = val <= float(info.min)
        bad = hi | lo | torch.isnan(val)
        out = torch.where(bad, torch.zeros((), dtype=val.dtype,
                                           device=val.device), val).to(dtype)
        out = torch.where(hi, torch.full((), info.max, dtype=dtype,
                                         device=val.device), out)
        return torch.where(lo, torch.full((), info.min, dtype=dtype,
                                          device=val.device), out)
    return val.to(dtype)


def _full(v, dtype, device) -> torch.Tensor:
    return torch.full((), v, dtype=dtype, device=device)


def _identity(op: str, dtype, device):
    """Reduction identity (reference GM_REDUCE_* defaults)."""
    if op in ("SUM", "COUNT", "AVG"):
        return _full(0, dtype, device)
    if op == "MULT":
        return _full(1, dtype, device)
    if op in ("MIN", "MAX"):
        if dtype.is_floating_point:
            v = float("inf") if op == "MIN" else float("-inf")
        else:
            info = torch.iinfo(dtype)
            v = info.max if op == "MIN" else info.min
        return _full(v, dtype, device)
    if op in ("AND", "ALL"):
        return _full(True, _BOOL, device)
    if op in ("OR", "EXIST"):
        return _full(False, _BOOL, device)
    raise LowerError(f"no identity for reduce op {op}")


def _combine(op: str, a, b):
    if op == "SUM":
        return a + b
    if op == "MULT":
        return a * b
    if op == "MIN":
        return torch.minimum(*_same(a, b))
    if op == "MAX":
        return torch.maximum(*_same(a, b))
    if op in ("AND", "ALL"):
        return a & b
    if op in ("OR", "EXIST"):
        return a | b
    raise LowerError(f"no combiner for reduce op {op}")


def _same(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _where(c, a, b):
    """``jnp.where`` on tensors: the branches promote as JAX promotes
    them (no 0-d special case)."""
    a, b = _same(a, b)
    return torch.where(c, a, b)


def _sum(x):
    """``jnp.sum``: bool and small integers accumulate in int32, int32
    stays int32; per lane for a lane value."""
    return LN.reduce("sum", x)


def _red(op: str):
    name = {"SUM": "sum", "MULT": "prod", "MIN": "min", "MAX": "max",
            "AND": "all", "OR": "any"}[op]
    return lambda x: LN.reduce(name, x)


_RED = {op: _red(op) for op in ("SUM", "MULT", "MIN", "MAX", "AND", "OR")}

_SEG_OP = {"SUM": "add", "COUNT": "add", "AVG": "add",
           "MIN": "min", "MAX": "max"}


def _seg(op: str, vals, ids, n: int, safe: bool = False):
    """Unsorted segment reduction (``jax.ops.segment_*``): empty segments
    get the identity, ids outside ``[0, n)`` are dropped."""
    f = {"add": ops.segment_sum, "min": ops.segment_min,
         "max": ops.segment_max}[op]
    if LN.is_lanes(vals) or LN.is_lanes(ids):
        ids = ids.long()
        ids = torch.where((ids >= 0) & (ids < n), ids, n)
        return LN.seg(vals, ids, n, f)[:, :n]
    if safe:
        return f(vals, ids, n)
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    return f(vals, ids, n + 1)[:n]


def _sorted_reduce(vals, ids, offsets, n: int, op: str):
    """``ops.sorted_segment_reduce``; lane values ([B, E]) go to the
    kernels in one launch and come back [B, n] lane values."""
    out = ops.sorted_segment_reduce(vals.contiguous(), ids, offsets, n, op)
    return LN.mark(out) if LN.is_lanes(vals) else out


def _scatter_or(n: int, idx, mask):
    """``zeros(n, bool).at[idx].max(mask)``."""
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    if LN.is_lanes(i) or LN.is_lanes(mask):
        return _seg("max", mask.to(torch.uint8), i, n) > 0
    i = torch.where((i >= 0) & (i < n), i, n).reshape(-1)
    out = torch.zeros(n + 1, dtype=torch.uint8, device=mask.device)
    out.scatter_reduce_(0, i, mask.to(torch.uint8).reshape(-1), "amax")
    return out[:n] > 0


def _has_edge_to(g: Graph, src, dst):
    """Vectorized ``HasEdgeTo`` (binary search over the semi-sorted CSR
    rows), with the JAX package's clamped reads of ``begin``."""
    src, dst = torch.broadcast_tensors(_asarray(src, g.device),
                                       _asarray(dst, g.device))
    lo = take(g.begin, src).long()
    end = take(g.begin, src.long() + 1).long()
    hi = end
    last = g.e_pad - 1
    for _ in range(max(1, int(g.num_nodes).bit_length()) + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = active & (g.node_idx[mid.clamp(0, last)] < dst)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo < end) & (g.node_idx[lo.clamp(0, last)] == dst)


class _CtxMapHist:
    """``Map<Node, Int>`` declared inside a parallel node loop
    (communities.gm): one logical histogram per outer node.  Increments
    recorded in edge space are reduced on demand into per-outer-node
    (max count, arg-max key, count-of-key) vectors by a composite-key sort
    and run-length encoding.  Ties pick the smallest key; an empty
    histogram reports HasMaxValue=True.  With lane values among the
    increments each lane's histogram is reduced on its own (the sort's
    length does not depend on the lanes) and the vectors come back
    ``[B, ...]`` lane values."""

    def __init__(self, n_pad: int):
        self.n_pad = n_pad
        self.entries = []    # (keys, weights, mask, outer_ids)
        self.cache = None

    def _runs(self):
        if self.cache is not None:
            return self.cache
        if not self.entries:
            raise LowerError("per-node map read before any increment")
        b = max(LN.lanes_of(x) for e in self.entries for x in e)
        if not b:
            self.cache = self._runs_of(self.entries)
            return self.cache
        lanes = [self._runs_of([tuple(LN.plain(x)[i] if LN.is_lanes(x)
                                      else x for x in e)
                                for e in self.entries])
                 for i in range(b)]
        self.cache = tuple(LN.mark(torch.stack(f)) for f in zip(*lanes))
        return self.cache

    def _runs_of(self, entries):
        n_pad = self.n_pad
        xs, labs, ws = [], [], []
        for k, v, mask, outer in entries:
            xs.append(torch.where(mask, outer.to(_I32), n_pad).to(_I32))
            labs.append(torch.where(mask, k.to(_I32), n_pad).to(_I32))
            ws.append(torch.where(mask, v.to(_I32), 0).to(_I32))
        x = torch.cat(xs)
        lab = torch.cat(labs)
        w = torch.cat(ws)
        key = x.long() * (1 << 32) + (lab.long() - _INT32_MIN)
        order = torch.argsort(key, stable=True)
        x_s, lab_s, w_s = x[order], lab[order], w[order]
        S = x_s.shape[0]
        dev = x.device
        m1 = torch.full((1,), -1, dtype=_I32, device=dev)
        prev_x = torch.cat([m1, x_s[:-1]])
        prev_l = torch.cat([m1, lab_s[:-1]])
        change = (x_s != prev_x) | (lab_s != prev_l)
        run_id = torch.cumsum(change.to(_I32), 0, dtype=_I32) - 1
        counts = _seg("add", w_s, run_id, S)
        run_x = _seg("max", x_s, run_id, S)
        run_lab = _seg("max", lab_s, run_id, S)
        valid = (run_x < n_pad) & (run_lab < n_pad) & (counts > 0)
        counts = torch.where(valid, counts, 0)
        seg = torch.where(valid, run_x, n_pad)
        maxc = _seg("max", counts, seg, n_pad + 1)[:n_pad]
        maxc = maxc.clamp(min=0)
        is_best = valid & (counts == take(maxc, run_x.clamp(max=n_pad - 1)))
        maxkey = _seg("min", torch.where(is_best, run_lab, _INT32_MAX),
                      seg, n_pad + 1)[:n_pad]
        return seg, run_lab, counts, valid, maxc, maxkey

    def max_count(self):
        return self._runs()[4]

    def max_key(self):
        """[n_pad] arg-max key per outer node (smallest on ties);
        INT32_MAX where the histogram is empty."""
        return self._runs()[5]

    def count_of(self, kvec):
        seg, run_lab, counts, valid, _, _ = self._runs()
        n_pad = self.n_pad
        kv = _asarray(kvec, seg.device)
        hit = valid & (run_lab == take(kv, seg.clamp(max=n_pad - 1)))
        return _seg("max", torch.where(hit, counts, 0), seg,
                    n_pad + 1)[..., :n_pad]

    def has_max_value(self, kvec):
        maxc = self.max_count()
        return (maxc == 0) | (self.count_of(kvec) == maxc)


def _alloc_prop(g: Graph, loc: str, dt):
    """Allocate an unsupplied property argument.  ``dt == "NSET"`` is an
    ``N_P<Node_Set>`` (potential_friends.gm): an [N_pad, N_pad] bit matrix
    with an explicit scale guard."""
    if dt == "NSET":
        if g.n_pad > 8192:
            raise LowerError(
                "N_P<Node_Set> bit-matrix limited to 8192 nodes")
        return torch.zeros((g.n_pad, g.n_pad), dtype=_BOOL, device=g.device)
    return g.node_prop(0, dt) if loc == "N" else g.edge_prop(0, dt)


# --------------------------------------------------------------------------
# Vector contexts
# --------------------------------------------------------------------------

@dataclasses.dataclass
class NodeCtx:
    """Body of a node-parallel Foreach: values are [N_pad] vectors."""
    g: Graph
    var: str                      # iteration variable ("" for group assign)
    ids: torch.Tensor             # [N_pad] iota
    mask: torch.Tensor            # [N_pad] bool (node_mask & filters)
    aliases: Tuple[str, ...] = ()  # names that also mean `ids` (the graph
    #                               name in group-assign expansion)
    locals: Set[str] = dataclasses.field(default_factory=set)

    kind = "node"

    def with_mask(self, m):
        return dataclasses.replace(self, mask=m)


@dataclasses.dataclass
class EdgeCtx:
    """Nested neighbor loop: values are [E_pad] per-slot vectors."""
    g: Graph
    layout: str                   # "csr" (Nbrs/Edges) | "csc" (InNbrs)
    outer_var: str                # the node whose neighborhood is iterated
    inner_var: str                # the loop variable (neighbor or edge)
    outer_ids: torch.Tensor       # [E_pad]
    inner_ids: torch.Tensor       # [E_pad]
    mask: torch.Tensor            # [E_pad]
    parent: Optional[NodeCtx]
    inner_is_edge: bool = False   # Foreach(e: G.Edges)
    locals: Set[str] = dataclasses.field(default_factory=set)

    kind = "edge"

    def with_mask(self, m):
        return dataclasses.replace(self, mask=m)

    def slots(self):
        """CSR slot id per context slot (edge property index)."""
        if self.layout == "csr":
            return torch.arange(self.g.e_pad, dtype=_I32,
                                device=self.g.device)
        return self.g.e_rev2idx


@dataclasses.dataclass
class WedgeCtx:
    """Second-hop neighbor iteration flattened to the wedge space.

    Lowers ``Foreach(w: u.Nbrs)`` / ``Sum(w: u.Nbrs){..}`` where ``u`` is
    itself a per-slot value of an enclosing parallel context.  Wedge ``w``
    belongs to outer context position ``sel[w]`` and visits the neighbor at
    ``slot[w]`` of its driver's row.  Built eagerly (sizes depend on the
    concrete graph), so it is unavailable inside traced loops."""
    g: Graph
    var: str
    outer_var: str
    layout: str
    sel: torch.Tensor             # [W] outer ctx position per wedge
    slot: torch.Tensor            # [W] second-hop slot (layout arrays)
    inner_ids: torch.Tensor       # [W] neighbor node id
    outer_ids: torch.Tensor       # [W] driver node id
    mask: torch.Tensor            # [W]
    parent: object                # enclosing ctx (Node/Edge/Wedge)
    parent_len: int
    parent_offsets: np.ndarray    # [L+1] wedge run offsets per outer pos
    locals: Set[str] = dataclasses.field(default_factory=set)

    kind = "wedge"

    def with_mask(self, m):
        return dataclasses.replace(self, mask=m)

    def slots(self):
        """CSR edge-property slot per wedge (ToEdge / edge props)."""
        if self.layout == "csr":
            return self.slot
        return self.g.e_rev2idx[self.slot.long()]


_F = "F$"          # env-key prefix for properties
_RET = "__ret__"
_DONE = "__done__"
_RNG = "__rng$"    # counter-based RNG draw counter (gm_rand.h analog)

PASS_SPAN = "gm:lower:pass"   # one pass of a traced While (utils.timing.span)
_PASS_KEYS = ("loops", "passes", "lanes_computed", "lanes_live")
_PASS_COUNTS = dict.fromkeys(_PASS_KEYS, 0)
_PASS_LOCK = threading.Lock()      # a sharded run lowers on a thread a shard


def _count_passes(**more: int) -> None:
    with _PASS_LOCK:
        for k, v in more.items():
            _PASS_COUNTS[k] += v


def lane_pass_counts() -> Dict[str, int]:
    """The traced ``While`` loops run since the last reset: ``loops``,
    ``passes`` (bodies run, a ``Do``'s first one included), and for the
    passes of a loop whose predicate is a lane value ``lanes_computed`` (B
    a pass) and ``lanes_live`` (the lanes whose predicate held for it).  In
    a batched run ``passes`` is the longest lane's single-run count and
    ``lanes_live`` the sum of the lanes' counts."""
    with _PASS_LOCK:
        return dict(_PASS_COUNTS)


def reset_lane_pass_counts() -> None:
    with _PASS_LOCK:
        _PASS_COUNTS.update(dict.fromkeys(_PASS_KEYS, 0))


# --------------------------------------------------------------------------
# Static write-set / decl-set analysis (while-loop carry discovery)
# --------------------------------------------------------------------------

def _lhs_key(lhs) -> str:
    if isinstance(lhs, A.Ident):
        return lhs.name
    if isinstance(lhs, A.Field):
        return _F + lhs.prop
    if isinstance(lhs, A.MapAccess):
        return lhs.map_name
    raise LowerError(f"unsupported assignment target {type(lhs).__name__}")


def written_keys(stmt) -> Set[str]:
    out: Set[str] = set()

    def walk(s):
        if s is None:
            return
        if isinstance(s, A.Block):
            for x in s.stmts:
                walk(x)
        elif isinstance(s, (A.Assign, A.ReduceAssign, A.DeferAssign)):
            out.add(_lhs_key(s.lhs))
        elif isinstance(s, A.ArgMinMaxAssign):
            out.add(_lhs_key(s.lhs))
            for e in s.lhs_extra:
                out.add(_lhs_key(e))
        elif isinstance(s, A.VarDecl):
            pass
        elif isinstance(s, A.Foreach):
            walk(s.body)
        elif isinstance(s, A.If):
            walk(s.then)
            walk(s.els)
        elif isinstance(s, A.While):
            walk(s.body)
        elif isinstance(s, A.BFS):
            walk(s.body_fw)
            walk(s.body_bw)
        elif isinstance(s, A.Return):
            out.add(_RET)
            out.add(_DONE)
        elif isinstance(s, A.CallStmt):
            # mutating collection verbs write their driver (S.Add(v) etc.)
            c = s.call
            if c.driver is not None and \
                    c.name.lower() in _MUTATE_METHODS:
                out.add(c.driver)
            elif c.driver_field is not None and \
                    c.name.lower() in _MUTATE_METHODS:
                out.add(_F + c.driver_field.prop)
        elif isinstance(s, A.ForeignStmt):
            for m in s.mutated:
                nm = getattr(m, "name", None)
                if nm is not None:
                    out.add(nm)
                elif isinstance(m, A.Field):
                    out.add(_F + m.prop)
        else:
            raise LowerError(f"unknown statement {type(s).__name__}")

    walk(stmt)

    # mutating collection verbs in EXPRESSION position also write their
    # driver (``Node w = Stack.PopBack()`` — tarjan_scc.gm)
    def scan(n):
        if isinstance(n, A.Builtin) and n.driver is not None and \
                n.name.lower() in _MUTATE_METHODS:
            out.add(n.driver)
    _walk_ast(stmt, scan)
    return out


# Collection verbs that mutate their driver (gm_builtin.cc mutate_grow/
# mutate_shrink aux info): a CallStmt on these writes the collection.
_MUTATE_METHODS = {"add", "remove", "clear", "pushback", "pushfront",
                   "popback", "popfront", "push", "pop"}

_RNG_BUILTINS = {"uniform", "rand", "pickrandom", "pickrandomnbr"}


def _walk_ast(node, fn):
    """Generic pre-order walk over AST dataclasses/lists."""
    if node is None:
        return
    fn(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _walk_ast(getattr(node, f.name), fn)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _walk_ast(x, fn)


def _any_node(node, pred) -> bool:
    found = []

    def fn(n):
        if pred(n):
            found.append(n)
    _walk_ast(node, fn)
    return bool(found)


def uses_rng(node) -> bool:
    return _any_node(node, lambda n: isinstance(n, A.Builtin)
                     and n.name.lower() in _RNG_BUILTINS)


def contains_bfs(node) -> bool:
    return _any_node(node, lambda n: isinstance(n, A.BFS))


def declared_keys(stmt) -> Set[str]:
    out: Set[str] = set()

    def walk(s):
        if s is None:
            return
        if isinstance(s, A.Block):
            for x in s.stmts:
                walk(x)
        elif isinstance(s, A.VarDecl):
            for n in s.names:
                out.add(_F + n if s.type.is_property() else n)
        elif isinstance(s, A.Foreach):
            walk(s.body)
        elif isinstance(s, A.If):
            walk(s.then)
            walk(s.els)
        elif isinstance(s, A.While):
            walk(s.body)
        elif isinstance(s, A.BFS):
            walk(s.body_fw)
            walk(s.body_bw)

    walk(stmt)
    return out


# --------------------------------------------------------------------------
# The lowerer
# --------------------------------------------------------------------------

class _LoopTally:
    """One traced ``While``'s share of :func:`lane_pass_counts`."""

    def __init__(self):
        _count_passes(loops=1)
        self.unread = 0      # passes run before the predicate was a lane value
        self.live = None     # (B, lanes whose predicate held) at the last read

    def ran(self) -> None:
        """A pass's body ran."""
        if self.live is None:
            self.unread += 1
            _count_passes(passes=1)
        else:
            _count_passes(passes=1, lanes_computed=self.live[0],
                          lanes_live=self.live[1])

    def runs(self, go) -> bool:
        """Does a pass run: the host predicate, or any lane's, the lanes
        read to the host once (the passes before the predicate was a lane
        value ran every lane)."""
        if not LN.is_lanes(go):
            self.live = None
            return go
        held = LN.plain(go).cpu()
        b = held.shape[0]
        _count_passes(lanes_computed=b * self.unread,
                      lanes_live=b * self.unread)
        self.unread = 0
        self.live = (b, int(held.sum()))
        return bool(held.any())


class Lowerer:
    """Executes one procedure on one graph (one device)."""

    # Eager host loops issue one device round-trip per element; they are
    # the faithful lowering of the reference's sequential constructs
    # (select_par), fine at test scale, unusable beyond it.
    _EAGER_SCALE_LIMIT = 100_000

    def __init__(self, proc: A.Procedure, g: Graph, axis=None):
        self.proc = proc
        self.g = g
        self.dev = g.device
        # Distributed lowering (lang.distribute, lang.lower_vertex): ``axis``
        # is the shard's ``parallel.comm.Axis``; edge arrays are local slabs
        # and every edge-space reduction finishes with a psum/pmin/pmax over
        # it (the GPS backend's per-superstep message combine).
        self.axis = axis
        self.graphs: Set[str] = set()
        # collection registry: name -> "NSET"|"NSEQ"|"NORDER"|"MAP"|...
        self.collections: Dict[str, str] = {}
        # unique per-call-site RNG stream id (see _rng_uniform)
        self._rng_site = 0
        # property registry: name -> ("N"|"E", dtype)
        self.props: Dict[str, Tuple[str, object]] = {}
        self.scalar_dtypes: Dict[str, object] = {}
        for decl in list(proc.args) + list(proc.out_args):
            for name in decl.names:
                t = decl.type
                if t.kind == "GRAPH":
                    self.graphs.add(name)
                elif t.is_property():
                    self.props[name] = (
                        "N" if t.kind == "NODEPROP" else "E",
                        "NSET" if t.elem.kind == "NSET"
                        else dtype_of_kind(t.elem.kind))
                elif t.kind == "NSET":
                    # bitmap over the padded node space (gm_set.h:8)
                    self.collections[name] = "NSET"
                elif t.kind in ("NSEQ", "NORDER"):
                    # host-eager sequence (gm_seq.h / gm_order.h)
                    self.collections[name] = t.kind
                elif t.is_collection() or t.kind == "MAP":
                    raise LowerError(
                        f"collection/map argument {name} not lowerable yet")
                else:
                    self.scalar_dtypes[name] = dtype_of_kind(t.kind)
        # deferred writes: stack of lists keyed by binding iterator
        self._defer_stack: List[Tuple[str, list]] = []
        # active BFS replay: (var, level_array, current_depth)
        self._bfs_ctx = None
        # ids of the values a traced region found concrete (None: no
        # traced region is running), and the values themselves, kept alive
        # so that their ids stay theirs
        self._concrete: Optional[Set[int]] = None
        self._concrete_refs: list = []
        if axis is not None:
            # JAX traces the whole procedure under shard_map: every value
            # of a sharded run counts as traced
            self._concrete = set()
        self._iota_n = torch.arange(g.n_pad, dtype=_I32, device=self.dev)
        self._iota_e = torch.arange(g.e_pad, dtype=_I32, device=self.dev)
        # index tensors known to lie in [0, N_pad) and in [0, E_pad); a
        # slab's e_rev2idx holds global slots
        self._safe_n = {id(getattr(g, f)) for f in (
            "node_idx", "node_idx_src", "r_node_idx", "r_node_idx_dst")
            if hasattr(g, f)}
        self._safe_n.add(id(self._iota_n))
        self._safe_e = {id(self._iota_e)}
        if getattr(g, "e_base", None) is None and hasattr(g, "e_rev2idx"):
            self._safe_e.add(id(g.e_rev2idx))

    # ---- entry ------------------------------------------------------------
    def run(self, env: Dict) -> Dict:
        self.exec_stmt(self.proc.body, env, None)
        return env

    # ---- cross-shard combine (distributed lowering) ------------------------
    def _pcomb(self, x, sub: str):
        """Combine per-shard partial edge reductions over the mesh axis."""
        if self.axis is None:
            return x
        f = {"add": self.axis.psum, "min": self.axis.pmin,
             "max": self.axis.pmax}.get(sub)
        if f is None:
            raise LowerError(
                f"{sub} reduction not supported in distributed lowering")
        return f(x)

    def _no_random_read(self, what: str):
        """Random-access reads are infeasible under edge sharding, as the
        reference's distributed backend rejects them
        (``gm_gps_new_check_random_read.cc``)."""
        if self.axis is not None:
            raise LowerError(
                f"{what} is a random edge-space read; not supported in "
                "distributed lowering (the reference GPS backend rejects "
                "these too)")

    # ---- small helpers ------------------------------------------------------
    def _c(self, v, dtype):
        return torch.full((), v, dtype=dtype, device=self.dev)

    def _a(self, x, dtype=None):
        return _asarray(x, self.dev, dtype)

    def _take(self, arr, ids):
        """``arr[ids]`` with JAX's clamping (skipped for graph arrays); a
        lane value ``arr`` ([B, n]) is read along its second axis."""
        if LN.is_lanes(arr):
            if self._in_range(ids, arr.shape[-1]):
                return arr.index_select(1, ids)
        elif self._in_range(ids, arr.shape[0]):
            return arr.index_select(0, ids)
        return take(arr, self._a(ids))

    def _in_range(self, ids, n: int) -> bool:
        """Is ``ids`` a graph array whose values lie in ``[0, n)``?"""
        if not isinstance(ids, torch.Tensor) or ids.dim() != 1 or \
                LN.is_lanes(ids):
            return False
        return ((id(ids) in self._safe_n and n >= self.g.n_pad)
                or (id(ids) in self._safe_e and n >= self.g.e_pad))

    # ---- traced regions -----------------------------------------------------
    def _traced(self, x) -> bool:
        """Would JAX hold ``x`` as a tracer here?  Inside a traced region
        every tensor the region computed is one; what it found in the
        environment and did not carry is not.  In a batched run every lane
        value is one."""
        if LN.is_lanes(x):
            # a value of a batched run that depends on its lanes: JAX holds
            # it as a BatchTracer
            return True
        return (self._concrete is not None and isinstance(x, torch.Tensor)
                and id(x) not in self._concrete)

    @contextlib.contextmanager
    def _trace(self, env, carried=(), ctx=None):
        """Run a region as JAX runs a ``lax.while_loop`` body: the values
        of ``env`` outside ``carried`` (and the graph and ``ctx`` arrays)
        stay concrete, everything else counts as traced."""
        if self._concrete is not None:
            yield
            return
        refs = [getattr(self.g, f) for f in ARRAY_FIELDS
                if hasattr(self.g, f)]
        refs += [self._iota_n, self._iota_e]
        for k, v in env.items():
            if k not in carried:
                refs.extend(x for x in tree_leaves(v)
                            if isinstance(x, torch.Tensor))
        if ctx is not None:
            refs.extend(getattr(ctx, f.name) for f in dataclasses.fields(ctx)
                        if f.name != "mask" and isinstance(
                            getattr(ctx, f.name), torch.Tensor))
        self._concrete = {id(x) for x in refs}
        self._concrete_refs = refs
        try:
            yield
        finally:
            self._concrete = None
            self._concrete_refs = []

    def _host_bool(self, c, what: str) -> bool:
        if self._traced(c):
            raise LowerError(what)
        return bool(c)

    # ---- RNG (gm_rand.h / per-thread erand48 analog) -----------------------
    def _rng_uniform(self, env, ctx, shape=()):
        """Deterministic counter-based uniform draw (threefry): JAX's
        ``uniform(fold_in(fold_in(PRNGKey(0), cnt), site), shape)``.  Every
        call site has a stream id numbered as JAX's trace numbers it, and
        every dynamic draw bumps a counter carried through loops."""
        if self.axis is not None:
            raise LowerError("RNG draws not supported in distributed "
                             "lowering yet")
        cnt = env.get(_RNG)
        if cnt is None:
            cnt = self._c(0, torch.int64)
        self._rng_site += 1
        env[_RNG] = (cnt + 1) & R.MASK
        if ctx is not None:
            shape = LN.lshape(ctx.mask)

        def draw(c):
            key = R.fold_in(R.fold_in(R.PRNGKey(0, self.dev), c),
                            self._rng_site)
            if _float_dtype() == torch.float64:
                return R.uniform64(key, shape)
            return R.uniform(key, shape).to(_float_dtype())

        if not LN.is_lanes(cnt):
            return draw(int(cnt))
        # lanes that ran different numbers of passes count different draws
        # (JAX's key is then per lane too): one draw per distinct count
        counts = LN.plain(cnt).reshape(-1).tolist()
        drawn = {c: draw(c) for c in set(counts)}
        out = torch.stack([drawn[c] for c in counts])
        return LN.mark(out.reshape(len(counts), -1) if not shape else out)

    # ---- env write with return-guard --------------------------------------
    def _wr(self, env, key, val):
        done = env.get(_DONE)
        if done is not None and isinstance(done, torch.Tensor) and \
                key in env:
            old = env[key]
            if isinstance(val, (torch.Tensor, int, float, bool,
                                np.ndarray)):
                val = _where(done, self._a(old), self._a(val))
            else:
                # collection state: merge leafwise
                val = tree_map(lambda o, n: _where(done, o, n), old, val)
        env[key] = val

    # ---- identifier/vector resolution --------------------------------------
    def _ident(self, name: str, env, ctx):
        if ctx is not None:
            if ctx.kind == "node":
                if name == ctx.var or name in ctx.aliases:
                    return ctx.ids
            elif ctx.kind == "wedge":
                if name == ctx.var:
                    return ctx.inner_ids
                if name == ctx.outer_var:
                    return ctx.outer_ids
                v = self._ident(name, env, ctx.parent)
                if isinstance(v, torch.Tensor) and \
                        LN.lshape(v)[:1] == (ctx.parent_len,):
                    return take(v, ctx.sel)
                return v
            else:
                if name == ctx.inner_var:
                    return ctx.inner_ids
                if name == ctx.outer_var:
                    return ctx.outer_ids
                if ctx.parent is not None and (
                        name == ctx.parent.var or name in ctx.parent.aliases):
                    return ctx.outer_ids
        if name not in env:
            raise LowerError(f"unbound symbol {name}")
        v = env[name]
        # parent-node-ctx local vector read from edge ctx: gather at the
        # outer endpoint.  A local of the edge ctx itself is already per
        # slot, even where a slab's slot count equals N_pad (the JAX
        # package gathers it too, and so runs sssp.gm wrong edge-sharded
        # 8 ways on a graph of 10,000 nodes and 80,000 edges)
        if (ctx is not None and ctx.kind == "edge"
                and name not in ctx.locals
                and isinstance(v, torch.Tensor)
                and LN.lshape(v) == (self.g.n_pad,)):
            return self._take(v, ctx.outer_ids)
        return v

    def _prop(self, env, name):
        key = _F + name
        if key not in env:
            raise LowerError(f"unbound property {name}")
        return env[key]

    def _field_read(self, f: A.Field, env, ctx):
        arr = self._prop(env, f.prop)
        loc, _dt = self.props[f.prop]
        ids = self._ident(f.driver, env, ctx)
        if ids is None:
            raise LowerError(f"cannot resolve driver {f.driver}")
        if loc == "E" and ctx is not None and ctx.kind == "edge" and (
                f.driver == ctx.inner_var and not ctx.inner_is_edge):
            raise LowerError(
                f"edge property {f.prop} accessed via node var {f.driver}")
        return self._take(arr, ids)

    # ---- expression evaluation ---------------------------------------------
    def eval(self, e: A.Expr, env, ctx):
        if isinstance(e, A.Const):
            if e.ctype == "INF":
                sign = e.value if e.value in (1, -1) else 1
                return self._c(sign * float("inf"), _float_dtype())
            if e.ctype == "NIL":
                return self._c(-1, _I32)
            if e.ctype == "BOOL":
                return self._c(bool(e.value), _BOOL)
            if e.ctype == "FLOAT":
                return self._c(float(e.value), _float_dtype())
            return self._c(int(e.value), _I32)
        if isinstance(e, A.Ident):
            return self._ident(e.name, env, ctx)
        if isinstance(e, A.Field):
            return self._field_read(e, env, ctx)
        if isinstance(e, A.UnOp):
            v = self.eval(e.operand, env, ctx)
            if e.op == "NEG":
                return -v
            if e.op == "NOT":
                return ~v if v.dtype == _BOOL else torch.logical_not(v)
            if e.op == "ABS":
                return torch.abs(v)
            raise LowerError(f"unary op {e.op}")
        if isinstance(e, A.Cast):
            v = self.eval(e.operand, env, ctx)
            return _coerce(v, dtype_of_kind(e.to.kind))
        if isinstance(e, A.BinOp):
            return self._binop(e, env, ctx)
        if isinstance(e, A.Ternary):
            c = self.eval(e.cond, env, ctx)
            a = self.eval(e.then, env, ctx)
            b = self.eval(e.els, env, ctx)
            a, b = self._unify(a, b)
            return torch.where(c, a, b)
        if isinstance(e, A.MapAccess):
            m = env.get(e.map_name)
            if m is None or self.collections.get(e.map_name) != "MAP":
                raise LowerError(f"unbound map {e.map_name}")
            return m.get(self._a(self.eval(e.key, env, ctx)))
        if isinstance(e, A.Builtin):
            return self._builtin(e, env, ctx)
        if isinstance(e, A.ReduceExpr):
            return self._reduce_expr(e, env, ctx)
        if isinstance(e, A.Foreign):
            # host-native execution: the text is compiled by g++ and
            # called on concrete values (lang/foreign.py); inside a
            # parallel Foreach the compiled wrapper loops the masked lanes
            if self.axis is not None:
                raise LowerError(
                    "foreign C++ expression inside a sharded "
                    "context is not lowerable (the reference GPS "
                    "backend rejects foreign text too)")
            from . import foreign as _foreign
            try:
                return _foreign.eval_expr(self, e, env, ctx=ctx)
            except _foreign.ForeignError as fe:
                raise LowerError(str(fe)) from None
        raise LowerError(f"unknown expression {type(e).__name__}")

    def _unify(self, a, b):
        return _same(self._a(a), self._a(b))

    def _inf_vs_int(self, x, other):
        """Comparing an integer operand against the ±INF literal: the
        reference saturates INF to the integer extrema (``(int)+INF ==
        INT_MAX``), so an int32 value INT32_MAX *equals* +INF (float32
        cannot tell them apart).  Only for a concrete INF, as in JAX."""
        x = self._a(x)
        other = self._a(other)
        if not (_is_int(other.dtype) and x.dtype.is_floating_point
                and x.dim() == 0):
            return None
        if self._traced(x):
            return None
        xv = float(x)
        if not np.isinf(xv):
            return None
        info = torch.iinfo(other.dtype)
        return self._c(info.max if xv > 0 else info.min, other.dtype)

    def _cmp_args(self, a, b):
        sat = self._inf_vs_int(a, b)
        if sat is not None:
            return sat, self._a(b)
        sat = self._inf_vs_int(b, a)
        if sat is not None:
            return self._a(a), sat
        return self._unify(a, b)

    def _binop(self, e: A.BinOp, env, ctx):
        a = self.eval(e.lhs, env, ctx)
        b = self.eval(e.rhs, env, ctx)
        op = e.op
        if op == "&&":
            return a & b
        if op == "||":
            return a | b
        if op in ("==", "!="):
            a, b = self._cmp_args(a, b)
            return (a == b) if op == "==" else (a != b)
        if op in ("<", "<=", ">", ">="):
            a, b = self._cmp_args(a, b)
            return {"<": a < b, "<=": a <= b,
                    ">": a > b, ">=": a >= b}[op]
        a, b = self._unify(a, b)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if _is_int(a.dtype):
                # C truncating division (generated C++ semantics)
                return torch.div(a, torch.where(b == 0, 1, b),
                                 rounding_mode="trunc")
            return a / b
        if op == "%":
            if _is_int(a.dtype):
                return torch.fmod(a, torch.where(b == 0, 1, b))
            return torch.fmod(a, torch.where(b == 0, 1.0, b))
        raise LowerError(f"binary op {op}")

    # ---- builtins (gm_builtin.cc table -> tensor ops) -----------------------
    def _builtin(self, e: A.Builtin, env, ctx):
        g = self.g
        name = e.name.lower()
        if e.driver is not None and e.driver in self.graphs:
            # group-assign alias: inside the expansion of
            # ``G.prop = ... G.Degree() ...`` the graph name stands for
            # the per-node iteration variable (gm_expand_group_assignment)
            alias_ids = None
            if ctx is not None and ctx.kind == "node" and \
                    e.driver in ctx.aliases:
                alias_ids = ctx.ids
            if name == "numnodes":
                return self._c(g.num_nodes, _I32)
            if name == "numedges":
                return self._c(g.num_edges, _I32)
            if name == "pickrandom":
                # gm_graph::pick_random_node: uniform over node ids
                u = self._rng_uniform(env, ctx)
                v = torch.floor(u * g.num_nodes).to(_I32)
                return v.clamp(0, g.num_nodes - 1)
            if alias_ids is not None:
                ids = alias_ids
                if name in ("degree", "outdegree", "numnbrs"):
                    return self._take(g.out_degree(), ids)
                if name in ("indegree", "numinnbrs"):
                    return self._take(g.in_degree(), ids)
            raise LowerError(f"graph builtin {e.name}")
        if e.driver is None:
            # driverless math builtins (gm_builtin.cc table: Log, Exp, ...)
            args = [self.eval(a, env, ctx) for a in e.args]
            fd = _float_dtype()
            math1 = {"log": torch.log, "exp": torch.exp, "sqrt": torch.sqrt,
                     "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
                     "floor": torch.floor, "ceil": torch.ceil}
            if name in math1 and len(args) == 1:
                return math1[name](self._a(args[0], fd))
            if name == "abs" and len(args) == 1:
                return torch.abs(args[0])
            if name == "pow" and len(args) == 2:
                return torch.pow(self._a(args[0], fd), self._a(args[1], fd))
            if name in ("uniform", "rand"):
                # per-context-slot draw (gm_rand.h uniform)
                return self._rng_uniform(env, ctx)
            raise LowerError(f"global builtin {e.name}")
        if e.driver in self.collections:
            coll = env[e.driver]
            kind = self.collections[e.driver]
            if kind == "CTXHIST":
                if ctx is None or ctx.kind != "node":
                    raise LowerError("per-node map read outside its "
                                     "node loop")
                if name == "hasmaxvalue":
                    return coll.has_max_value(
                        self.eval(e.args[0], env, ctx))
                if name == "getmaxkey":
                    return coll.max_key()
                if name == "getmaxvalue":
                    return coll.max_count()
                raise LowerError(
                    f"per-node map builtin {e.name} not lowerable")
            if kind == "MAP":
                if name == "size":
                    return coll.size()
                if name == "haskey":
                    return coll.has_key(self.eval(e.args[0], env, ctx))
                if name == "getminkey":
                    return coll.min_key()
                if name == "getmaxkey":
                    return coll.max_key()
                if name == "getminvalue":
                    return coll.min_value()
                if name == "getmaxvalue":
                    return coll.max_value()
                if name == "hasminvalue":
                    return coll.has_min_value(
                        self.eval(e.args[0], env, ctx))
                if name == "hasmaxvalue":
                    return coll.has_max_value(
                        self.eval(e.args[0], env, ctx))
                raise LowerError(f"map builtin {e.name} not lowerable")
            if kind == "NSET":
                if name == "has":
                    v = self.eval(e.args[0], env, ctx)
                    return take(coll, v)
                if name == "size":
                    return _sum(coll.to(_I32))
            else:
                if name == "size":
                    return self._a(coll.count, _I32)
                if name == "front":
                    return take(coll.items(), self._c(0, _I32))
                if name == "back":
                    return take(coll.items(), coll.count - 1)
                if name == "has" and kind == "NORDER":
                    return coll.has(self.eval(e.args[0], env, ctx))
                if name in ("popback", "popfront") and kind == "NSEQ":
                    # expression-position mutator: a single pop would be
                    # shared by every slot of a parallel context
                    if ctx is not None:
                        raise LowerError(
                            f"{e.name} inside a parallel loop")
                    val, new = (coll.pop_back() if name == "popback"
                                else coll.pop_front())
                    self._wr(env, e.driver, new)
                    return val
            raise LowerError(f"collection builtin {e.name} on "
                             f"{kind} not lowerable yet")
        ids = self._ident(e.driver, env, ctx)
        if name in ("degree", "outdegree", "numnbrs"):
            return self._take(g.out_degree(), ids)
        if name in ("indegree", "numinnbrs"):
            return self._take(g.in_degree(), ids)
        if name == "pickrandomnbr":
            # uniform over the driver's out-neighbor row; callers guard
            # Degree()==0 themselves (random_walk_sampling...gm)
            self._no_random_read("PickRandomNbr")
            deg = self._take(g.out_degree(), ids)
            u = self._rng_uniform(env, ctx, shape=LN.lshape(self._a(ids)))
            off = torch.floor(u * deg).to(_I32)
            off = torch.minimum(off.clamp(min=0), (deg - 1).clamp(min=0))
            slot = self._take(g.begin, ids) + off
            slot = slot.clamp(0, g.node_idx.shape[0] - 1)
            return g.node_idx[slot.long()]
        if name == "toedge":
            if ctx is None or ctx.kind not in ("edge", "wedge") or \
                    e.driver != getattr(ctx, "inner_var", None) and \
                    e.driver != getattr(ctx, "var", None):
                raise LowerError("ToEdge() outside a neighbor loop")
            return ctx.slots()
        if name in ("fromnode", "from"):
            return self._take(g.node_idx_src, ids)
        if name in ("tonode", "to"):
            return self._take(g.node_idx, ids)
        if name == "hasedgeto":
            self._no_random_read("HasEdgeTo")
            dst = self.eval(e.args[0], env, ctx)
            return _has_edge_to(g, ids, dst)
        if name in ("hasedgefrom", "isnbrfrom"):
            self._no_random_read("HasEdgeFrom" if name == "hasedgefrom"
                                 else "IsNbrFrom")
            src = self.eval(e.args[0], env, ctx)
            idv, src = torch.broadcast_tensors(self._a(ids), self._a(src))
            return _has_edge_to(g, src, idv)
        raise LowerError(f"builtin {e.name} not lowerable yet")

    # ---- neighbor-context construction --------------------------------------
    def _edge_ctx(self, it: A.Iterator, env, ctx) -> EdgeCtx:
        g = self.g
        level_filter = None
        if it.iter_type in ("NBRS", "OUT_NBRS"):
            layout, outer, inner = "csr", g.node_idx_src, g.node_idx
        elif it.iter_type == "IN_NBRS":
            layout, outer, inner = "csc", g.r_node_idx_dst, g.r_node_idx
        elif it.iter_type in ("UP_NBRS", "DOWN_NBRS"):
            # BFS-tree-relative neighbors: Up = in-neighbors one level
            # closer to the root, Down = out-neighbors one level deeper
            if self._bfs_ctx is None or self._bfs_ctx[0] != it.source:
                raise LowerError(f"{it.iter_type} outside its InBFS body")
            _, level, d = self._bfs_ctx
            if it.iter_type == "UP_NBRS":
                layout, outer, inner = ("csc", g.r_node_idx_dst,
                                        g.r_node_idx)
                level_filter = self._take(level, inner) == (d - 1)
            else:
                layout, outer, inner = "csr", g.node_idx_src, g.node_idx
                level_filter = self._take(level, inner) == (d + 1)
        elif it.iter_type == "EDGES":
            return EdgeCtx(g=g, layout="csr", outer_var="",
                           inner_var=it.var, outer_ids=g.node_idx_src,
                           inner_ids=self._iota_e, mask=g.edge_mask(),
                           parent=None, inner_is_edge=True)
        else:
            raise LowerError(f"iterator {it.iter_type} not lowerable yet")
        mask = g.edge_mask()
        if level_filter is not None:
            mask = mask & level_filter
        src_name = it.source
        if ctx is not None and ctx.kind == "node" and (
                src_name == ctx.var or src_name in ctx.aliases):
            mask = mask & self._take(ctx.mask, outer)
            parent = ctx
        elif ctx is None or ctx.kind == "node":
            # neighborhood of a scalar node variable (e.g. root.Nbrs)
            v = self._ident(src_name, env, ctx)
            mask = mask & (outer == v)
            parent = ctx if (ctx is not None and ctx.kind == "node") else None
        else:
            return self._wedge_ctx(it, layout, env, ctx)
        return EdgeCtx(g=g, layout=layout, outer_var=src_name,
                       inner_var=it.var, outer_ids=outer, inner_ids=inner,
                       mask=mask, parent=parent)

    def _wedge_ctx(self, it: A.Iterator, layout: str, env, ctx) -> WedgeCtx:
        """Flatten a nested neighbor iteration to its wedge space."""
        g = self.g
        u = self._ident(it.source, env, ctx)
        if self._traced(u) or self._traced(ctx.mask):
            raise LowerError(
                "nested neighbor iteration inside a traced loop is not "
                "lowerable (wedge space size depends on data)")
        u_np = self._a(u).cpu().numpy().astype(np.int64)
        m_np = ctx.mask.cpu().numpy()
        L = int(u_np.shape[0])
        if layout == "csr":
            begin = g.begin.cpu().numpy().astype(np.int64)
            neigh = g.node_idx
        else:
            begin = g.r_begin.cpu().numpy().astype(np.int64)
            neigh = g.r_node_idx
        uc = np.clip(u_np, 0, g.num_nodes - 1)
        deg = np.where(m_np & (u_np < g.num_nodes),
                       begin[uc + 1] - begin[uc], 0)
        cum = np.cumsum(deg)
        W = int(cum[-1]) if L else 0
        w_pad = round_up(max(W, 1))
        w_ix = np.arange(w_pad, dtype=np.int64)
        sel = np.searchsorted(cum, np.minimum(w_ix, max(W - 1, 0)),
                              side="right")
        sel = np.minimum(sel, L - 1)
        excl = cum[sel] - deg[sel]
        slot = begin[uc[sel]] + (np.minimum(w_ix, max(W - 1, 0)) - excl)
        slot = np.clip(slot, 0, int(neigh.shape[0]) - 1)
        mask_w = w_ix < W
        offsets = np.concatenate([np.zeros(1, np.int64), cum])
        sel_t = torch.from_numpy(sel.astype(np.int32)).to(self.dev)
        slot_t = torch.from_numpy(slot.astype(np.int32)).to(self.dev)
        return WedgeCtx(
            g=g, var=it.var, outer_var=it.source, layout=layout,
            sel=sel_t, slot=slot_t,
            inner_ids=neigh[slot_t.long()],
            outer_ids=torch.from_numpy(uc.astype(np.int32)).to(
                self.dev)[sel_t.long()],
            mask=torch.from_numpy(mask_w).to(self.dev), parent=ctx,
            parent_len=L, parent_offsets=offsets)

    def _node_ctx(self, it: A.Iterator, env, ctx, aliases=()) -> NodeCtx:
        if ctx is not None:
            raise LowerError("whole-graph loop nested inside a parallel "
                             "context is not lowerable")
        return NodeCtx(g=self.g, var=it.var, ids=self._iota_n,
                       mask=self.g.node_mask(), aliases=tuple(aliases))

    # ---- reduce expressions --------------------------------------------------
    def _reduce_expr(self, e: A.ReduceExpr, env, ctx):
        it = e.iterator
        if it.source in self.graphs and it.iter_type == "NODES":
            nctx = self._node_ctx(it, env, None)
            return self._reduce_over_nodes(e, env, nctx)
        if it.iter_type in ("NBRS", "OUT_NBRS", "IN_NBRS", "EDGES",
                            "UP_NBRS", "DOWN_NBRS"):
            ectx = self._edge_ctx(it, env, ctx)
            per_node, scalar = self._reduce_over_edges(e, env, ectx, ctx)
            return per_node if scalar is None else scalar
        if it.iter_type == "COMMON_NBRS":
            ectx = self._common_nbr_ctx(it, env, ctx)
            per_node, scalar = self._reduce_over_edges(e, env, ectx, ctx)
            return per_node if scalar is None else scalar
        raise LowerError(f"reduce over {it.iter_type} not lowerable yet")

    def _common_nbr_ctx(self, it: A.Iterator, env, ctx):
        """``x.CommonNbrs(y)``: iterate x's out-neighbors masked by
        membership in y's row — the sorted-intersection iterator
        (``gm_cpp_opt_common_nbr.cc``) as a neighbor context plus a
        binary-search membership test over the semi-sorted CSR rows."""
        self._no_random_read("CommonNbrs")
        it2 = dataclasses.replace(it, iter_type="NBRS")
        ectx = self._edge_ctx(it2, env, ctx)
        other = self._ident(it.common_with, env,
                            getattr(ectx, "parent", ctx) or ctx)
        ov = self._a(other)
        if hasattr(ectx, "sel") and \
                LN.lshape(ov)[:1] == (ectx.parent_len,):
            ov = take(ov, ectx.sel)                # wedge space alignment
        ov = LN.expand_like(ov, ectx.mask)
        member = _has_edge_to(self.g, ov, ectx.inner_ids)
        return ectx.with_mask(ectx.mask & member)

    def _reduce_over_nodes(self, e: A.ReduceExpr, env, nctx: NodeCtx):
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
                vals = LN.expand_like(self._a(body), mask)
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND",
              "AVG": "SUM"}.get(e.op, e.op)
        dt = vals.dtype
        if e.op == "AVG":
            vals = vals.to(_float_dtype())
            dt = vals.dtype
        ident = _identity(op, dt, self.dev)
        vals = torch.where(mask, vals, ident)
        out = _RED[op](vals)
        if e.op == "AVG":
            cnt = _sum(mask.to(_float_dtype()))
            out = out.to(_float_dtype()) / cnt.clamp(min=1)
        return out

    def _reduce_over_edges(self, e: A.ReduceExpr, env, ectx: EdgeCtx,
                           outer_ctx):
        """Returns (per_node [N_pad] or None, scalar or None)."""
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
                vals = LN.expand_like(self._a(body), mask)
        if ectx.kind == "wedge":
            return self._finish_wedge_reduce(e, vals, mask, ectx), None
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND"}.get(e.op, e.op)
        if op in ("AND", "OR"):
            work = vals.to(torch.int8)
            sub = "MIN" if op == "AND" else "MAX"
            ident = _identity(sub, torch.int8, self.dev)
            work = torch.where(mask, work, ident)
            seg = sub
        else:
            ident = _identity(op, vals.dtype, self.dev)
            work = torch.where(mask, vals, ident)
            seg = op
            if op == "MULT":
                raise LowerError("Product over neighbors not lowerable yet")
        if ectx.inner_is_edge or ectx.parent is None:
            # whole-edge-set or scalar-source neighborhood -> scalar
            _sub = {"SUM": "add", "MIN": "min", "MAX": "max"}
            if seg not in _sub:
                if op == "OR":
                    out = self._pcomb(LN.reduce("max", work), "max") > 0
                else:
                    out = self._pcomb(LN.reduce("min", work), "min") > 0
            else:
                out = self._pcomb(_RED[seg](work), _sub[seg])
            if e.op == "AVG":
                cnt = self._pcomb(_sum(mask.to(_float_dtype())), "add")
                out = out.to(_float_dtype()) / cnt.clamp(min=1)
            return None, out
        # per-outer-node segment reduction (sorted by construction)
        g = ectx.g
        sortkey = g.node_idx_src if ectx.layout == "csr" else g.r_node_idx_dst
        offs = g.csr_offsets() if ectx.layout == "csr" else g.csc_offsets()
        segop = {"SUM": "add", "MIN": "min", "MAX": "max"}[seg]
        per_node = self._pcomb(_sorted_reduce(
            work, sortkey, offs, g.n_pad, segop), segop)
        if op in ("AND", "OR"):
            per_node = per_node > 0
        if e.op == "AVG":
            cnt = self._pcomb(_sorted_reduce(
                mask.to(_float_dtype()), sortkey, offs, g.n_pad, "add"),
                "add")
            per_node = per_node.to(_float_dtype()) / cnt.clamp(min=1)
        # align to the outer context's vector of the source variable
        if outer_ctx is not None and outer_ctx.kind == "node":
            if ectx.outer_var == outer_ctx.var or \
                    ectx.outer_var in outer_ctx.aliases:
                return per_node, None
        ids = self._ident(ectx.outer_var, env, outer_ctx)
        return None, self._take(per_node, ids)

    def _finish_wedge_reduce(self, e: A.ReduceExpr, vals, mask,
                             wctx: WedgeCtx):
        """Reduce wedge-space values back to the enclosing ctx's space
        (fixed-order segment reduction over the static wedge runs)."""
        op = {"COUNT": "SUM", "EXIST": "OR", "ALL": "AND"}.get(e.op, e.op)
        if op in ("AND", "OR"):
            work = vals.to(torch.int8)
            sub = "min" if op == "AND" else "max"
            ident = _identity("MIN" if op == "AND" else "MAX", torch.int8,
                              self.dev)
        else:
            sub = {"SUM": "add", "MIN": "min", "MAX": "max",
                   "AVG": "add"}.get(op)
            if sub is None:
                raise LowerError(f"{op} over nested neighbors")
            work = vals
            if e.op == "AVG":
                work = work.to(_float_dtype())
            ident = _identity("SUM" if e.op == "AVG" else op, work.dtype,
                              self.dev)
        work = torch.where(mask, work, ident)
        offs = torch.from_numpy(
            wctx.parent_offsets.astype(np.int32)).to(self.dev)
        ids = wctx.sel
        out = _sorted_reduce(work, ids, offs, wctx.parent_len, sub)
        if op in ("AND", "OR"):
            out = out > 0
        if e.op == "AVG":
            cnt = _sorted_reduce(
                mask.to(_float_dtype()), ids, offs, wctx.parent_len, "add")
            out = out / cnt.clamp(min=1)
        return out

    # ---- statements ----------------------------------------------------------
    def exec_stmt(self, s: A.Stmt, env, ctx):
        if isinstance(s, A.Block):
            for st in s.stmts:
                self.exec_stmt(st, env, ctx)
        elif isinstance(s, A.VarDecl):
            self._exec_vardecl(s, env, ctx)
        elif isinstance(s, A.Assign):
            self._exec_assign(s, env, ctx)
        elif isinstance(s, A.ReduceAssign):
            self._exec_reduce_assign(s, env, ctx)
        elif isinstance(s, A.DeferAssign):
            self._exec_defer(s, env, ctx)
        elif isinstance(s, A.ArgMinMaxAssign):
            self._exec_argminmax(s, env, ctx)
        elif isinstance(s, A.Foreach):
            self._exec_foreach(s, env, ctx)
        elif isinstance(s, A.If):
            self._exec_if(s, env, ctx)
        elif isinstance(s, A.While):
            self._exec_while(s, env, ctx)
        elif isinstance(s, A.Return):
            self._exec_return(s, env, ctx)
        elif isinstance(s, A.CallStmt):
            self._exec_call(s.call, env, ctx)
        elif isinstance(s, A.ForeignStmt):
            if self.axis is not None:
                raise LowerError(
                    "foreign C++ statement inside a sharded "
                    "context is not lowerable (the reference GPS "
                    "backend rejects foreign text too)")
            from . import foreign as _foreign
            try:
                _foreign.exec_stmt(self, s, env, ctx=ctx)
            except _foreign.ForeignError as fe:
                raise LowerError(str(fe)) from None
        elif isinstance(s, A.BFS):
            self._exec_bfs(s, env, ctx)
        else:
            raise LowerError(f"statement {type(s).__name__} not lowerable")

    def _exec_call(self, b: A.Builtin, env, ctx):
        """Statement-position builtin call — collection mutators
        (``gm_set.h``/``gm_seq.h`` verbs; Add is vectorized under the ctx
        mask)."""
        name = b.name.lower()
        if b.driver is None and b.driver_field is not None:
            f = b.driver_field
            if f.prop in self.props and self.props[f.prop][1] == "NSET":
                # set-valued node property (N_P<Node_Set>): bit-matrix
                # update v.potFriend.Add(w)
                arr = env[_F + f.prop]
                n_pad = arr.shape[-1]
                rows = self._a(self._ident(f.driver, env, ctx))
                if name in ("add", "remove"):
                    cols = self._a(self.eval(b.args[0], env, ctx))
                    if ctx is not None:
                        mask = ctx.mask
                        rows = LN.expand_like(rows, mask)
                        cols = torch.where(mask, cols,
                                           n_pad)  # out of range: dropped
                    new = put2(arr, rows, cols, name == "add")
                    self._wr(env, _F + f.prop, new)
                    return
                raise LowerError(
                    f"set-property method {b.name} not lowerable yet")
        if b.driver in self.collections:
            kind = self.collections[b.driver]
            cur = env[b.driver]
            if kind == "MAP":
                if name == "remove":
                    if ctx is not None:
                        raise LowerError("map Remove inside a parallel "
                                         "loop not lowerable")
                    k = self.eval(b.args[0], env, ctx)
                    self._wr(env, b.driver, cur.remove(k))
                    return
                if name == "clear":
                    self._wr(env, b.driver, DenseNodeMap.empty(
                        cur.val.shape[-1], cur.val.dtype, self.dev))
                    return
                raise LowerError(
                    f"map method {b.name} not lowerable yet")
            if kind == "NSET":
                if name == "add":
                    v = self.eval(b.args[0], env, ctx)
                    if ctx is None:
                        self._wr(env, b.driver, put(cur, v, True))
                    else:
                        upd = _scatter_or(cur.shape[-1], v, ctx.mask)
                        self._wr(env, b.driver, cur | upd)
                    return
                if name == "remove":
                    v = self.eval(b.args[0], env, ctx)
                    if ctx is None:
                        self._wr(env, b.driver, put(cur, v, False))
                    else:
                        upd = _scatter_or(cur.shape[-1], v, ctx.mask)
                        self._wr(env, b.driver, cur & ~upd)
                    return
                if name == "clear":
                    self._wr(env, b.driver, torch.zeros_like(cur))
                    return
            else:  # NSEQ / NORDER
                if ctx is not None:
                    raise LowerError(
                        f"{b.name} on a sequence inside a parallel loop "
                        "(order-dependent; the reference serializes "
                        "collection mutation too)")
                v = self.eval(b.args[0], env, ctx) if b.args else None
                if name in ("pushback", "push"):
                    self._wr(env, b.driver, cur.push_back(v))
                    return
                if name == "pushfront":
                    self._wr(env, b.driver, cur.push_front(v))
                    return
            raise LowerError(
                f"collection method {b.name} on {kind} not lowerable yet")
        raise LowerError(f"procedure call {b.name} not lowerable")

    def _exec_vardecl(self, s: A.VarDecl, env, ctx):
        t = s.type
        for name in s.names:
            if t.is_property():
                dt = dtype_of_kind(t.elem.kind)
                loc = "N" if t.kind == "NODEPROP" else "E"
                self.props[name] = (loc, dt)
                env[_F + name] = (self.g.node_prop(0, dt) if loc == "N"
                                  else self.g.edge_prop(0, dt))
            elif t.kind == "NSET":
                self.collections[name] = "NSET"
                env[name] = torch.zeros(self.g.n_pad, dtype=_BOOL,
                                        device=self.dev)
                if ctx is not None:
                    raise LowerError("set local declared inside a "
                                     "parallel loop not lowerable yet")
            elif t.kind in ("NSEQ", "NORDER"):
                self.collections[name] = t.kind
                if ctx is not None:
                    raise LowerError("sequence local declared inside a "
                                     "parallel loop not lowerable yet")
                env[name] = (NodeSeq.empty(self.g.n_pad, self.dev)
                             if t.kind == "NSEQ"
                             else NodeOrder.empty(self.g.n_pad,
                                                  self.g.n_pad, self.dev))
            elif t.kind == "MAP":
                # Map<Node, V> -> dense value+presence tensors
                if t.key is None or t.key.kind != "NODE":
                    raise LowerError(
                        f"map local {name}: only Map<Node, V> lowerable")
                if ctx is not None:
                    if ctx.kind != "node":
                        raise LowerError("map local outside a node "
                                         "loop not lowerable")
                    # per-node histogram (communities.gm)
                    self.collections[name] = "CTXHIST"
                    env[name] = _CtxMapHist(self.g.n_pad)
                    ctx.locals.add(name)
                    continue
                self.collections[name] = "MAP"
                vdt = (dtype_of_kind(t.value.kind)
                       if t.value is not None else _I32)
                env[name] = DenseNodeMap.empty(self.g.n_pad, vdt, self.dev)
            elif t.is_collection():
                raise LowerError(f"collection local {name} not "
                                 "lowerable yet")
            else:
                dt = dtype_of_kind(t.kind)
                self.scalar_dtypes[name] = dt
                if s.init is not None:
                    val = _coerce(self.eval(s.init, env, ctx), dt)
                else:
                    val = self._c(0, dt)
                env[name] = val
                if ctx is not None:
                    ctx.locals.add(name)

    def _target_dtype(self, lhs, env):
        if isinstance(lhs, A.Ident):
            if lhs.name in self.scalar_dtypes:
                return self.scalar_dtypes[lhs.name]
            return (self._a(env[lhs.name]).dtype if lhs.name in env
                    else None)
        if isinstance(lhs, A.Field):
            return self.props[lhs.prop][1]
        return None

    def _exec_ctx_hist_add(self, hist, s, env, ctx, op):
        """Record ``T[k] += w`` increments of a per-node map declared in
        a parallel node loop (communities.gm's label histogram)."""
        if op != "SUM":
            raise LowerError("per-node map supports += only")
        if ctx is None or ctx.kind not in ("edge", "wedge"):
            raise LowerError("per-node map += outside a neighbor loop")
        k = self._a(self.eval(s.lhs.key, env, ctx))
        v = self._a(self.eval(s.rhs, env, ctx), _I32)
        mask = ctx.mask
        if ctx.kind == "wedge":
            # owner is the ENCLOSING NODE LOOP's variable, not the
            # wedge's second-hop driver
            par = ctx.parent
            pk = getattr(par, "kind", None)
            if pk == "node":
                owner = par.ids[ctx.sel.long()]
            elif pk == "edge":
                owner = par.outer_ids[ctx.sel.long()]
            else:
                raise LowerError("per-node map += nested too deeply")
        else:
            owner = ctx.outer_ids
        hist.entries.append(torch.broadcast_tensors(k, v, mask,
                                                    self._a(owner)))
        hist.cache = None

    def _exec_map_assign(self, s, env, ctx, op=None):
        """``M[k] = v`` / ``M[k] += v`` on a dense node-keyed map."""
        lhs = s.lhs
        m = env.get(lhs.map_name)
        if isinstance(m, _CtxMapHist):
            return self._exec_ctx_hist_add(m, s, env, ctx, op)
        if m is None or self.collections.get(lhs.map_name) != "MAP":
            raise LowerError(f"unbound map {lhs.map_name}")
        k = self._a(self.eval(lhs.key, env, ctx))
        v = _coerce(self.eval(s.rhs, env, ctx), m.val.dtype)
        if ctx is None and LN.lshape(k) == ():
            if op is None:
                self._wr(env, lhs.map_name, m.set(k, v))
            elif op == "SUM":
                self._wr(env, lhs.map_name, m.add(k, v))
            else:
                raise LowerError(f"map {op}= not lowerable yet")
            return
        # vector keys under a parallel context
        mask = (ctx.mask if ctx is not None
                else torch.ones(LN.lshape(k), dtype=_BOOL, device=self.dev))
        kv = LN.expand_like(k, mask)
        vv = LN.expand_like(v, kv)
        n_pad = m.val.shape[-1]
        drop_ids = torch.where(mask, kv, n_pad)   # out of range: dropped
        if op is None:
            # duplicate keys: deterministic lowest-slot winner (same
            # policy as racy property writes; reference is last-wins)
            val = self._det_scatter_set(m.val, kv, vv, mask)
        elif op == "SUM":
            sums = _seg("add", torch.where(mask, vv, 0),
                        drop_ids.clamp(max=n_pad), n_pad + 1)[..., :n_pad]
            base = torch.where(m.present, m.val, 0)
            val = base + sums
        else:
            raise LowerError(f"map {op}= not lowerable yet")
        pres = put(m.present, drop_ids, True)
        self._wr(env, lhs.map_name, DenseNodeMap(val, pres))

    def _exec_assign(self, s: A.Assign, env, ctx):
        lhs = s.lhs
        if isinstance(lhs, A.MapAccess):
            return self._exec_map_assign(s, env, ctx)
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if dt is not None:
                val = _coerce(val, dt)
            if ctx is not None and lhs.name not in ctx.locals and \
                    lhs.name in env and not (
                        isinstance(env[lhs.name], torch.Tensor)
                        and LN.lshape(env[lhs.name]) != ()):
                # Scalar WW race: the reference's check2 reports a
                # warning and proceeds with last-store-wins.
                # Deterministic valid instance here: lowest-active-slot
                # winner.
                vv = self._a(val)
                cur = _coerce(env[lhs.name], vv.dtype)
                if LN.lshape(vv) == ():
                    win = vv
                else:
                    win = take(vv, LN.arg("max", ctx.mask.to(torch.uint8)))
                self._wr(env, lhs.name, _where(LN.reduce("any", ctx.mask),
                                               win, cur))
                return
            self._wr(env, lhs.name, val)
            return
        if isinstance(lhs, A.Field):
            self._exec_field_assign(lhs, s.rhs, env, ctx)
            return
        raise LowerError(f"assignment to {type(lhs).__name__} not lowerable")

    def _exec_field_assign(self, lhs: A.Field, rhs, env, ctx):
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        g = self.g
        if lhs.driver in self.graphs:
            # group assignment G.prop = expr (gm_expand_group_assignment)
            if loc == "N":
                nctx = NodeCtx(g=g, var="", ids=self._iota_n,
                               mask=g.node_mask(), aliases=(lhs.driver,))
                val = _coerce(self.eval(rhs, env, nctx), dt)
                self._wr(env, key, torch.where(nctx.mask, val, arr))
            else:
                mask = g.edge_mask()
                ectx = EdgeCtx(g=g, layout="csr", outer_var="",
                               inner_var="", outer_ids=g.node_idx_src,
                               inner_ids=self._iota_e, mask=mask,
                               parent=None, inner_is_edge=True)
                val = _coerce(self.eval(rhs, env, ectx), dt)
                self._wr(env, key, torch.where(mask, val, arr))
            return
        if ctx is not None and ctx.kind == "node" and lhs.driver == ctx.var:
            val = _coerce(self.eval(rhs, env, ctx), dt)
            self._wr(env, key, torch.where(ctx.mask, val, arr))
            return
        if ctx is not None and ctx.kind == "edge":
            # per-slot edge-property write (each slot unique -> race-free);
            # node-prop write keyed by the inner var is a data race.
            if loc == "E" and ctx.inner_is_edge and lhs.driver == \
                    ctx.inner_var:
                val = _coerce(self.eval(rhs, env, ctx), dt)
                self._wr(env, key, torch.where(ctx.mask, val, arr))
                return
            if lhs.driver == ctx.inner_var:
                # intended write-write conflict ("only one will take
                # effect" — random_bipartite_matching.gm): a
                # deterministic winner (lowest slot id), a valid instance
                # of the same nondeterministic spec
                if loc != "N":
                    raise LowerError("racy edge-prop write keyed by a "
                                     "node variable")
                val = _coerce(self.eval(rhs, env, ctx), dt)
                self._wr(env, key, self._det_scatter_set(
                    arr, ctx.inner_ids, val, ctx.mask))
                return
        # self-update pattern ``x.p = x.p + e`` in a parallel context:
        # the reference emits a racy non-atomic update here; the
        # deterministic semantics is the equivalent reduction.
        if ctx is not None and isinstance(rhs, A.BinOp) and \
                rhs.op in ("+", "*") and isinstance(rhs.lhs, A.Field) and \
                rhs.lhs.prop == lhs.prop and rhs.lhs.driver == lhs.driver:
            red = A.ReduceAssign(lhs=lhs, op="SUM" if rhs.op == "+"
                                 else "MULT", rhs=rhs.rhs, bind=None)
            self._exec_reduce_assign(red, env, ctx)
            return
        # scalar node/edge driver (e.g. root.dist = 0)
        ids = self._ident(lhs.driver, env, ctx)
        val = _coerce(self.eval(rhs, env, ctx), dt)
        if ctx is None:
            self._wr(env, key, put(arr, ids, val))
            return
        idv = self._a(ids)
        if len(LN.lshape(idv)) == 1 and \
                LN.lshape(idv) == LN.lshape(ctx.mask):
            # write keyed by a per-slot local node vector (e.g.
            # ``Node t = n.Suitor; t.Match = n``): deterministic
            # lowest-position-winner scatter
            self._wr(env, key, self._det_scatter_set(
                arr, idv, val, ctx.mask))
            return
        raise LowerError(
            f"assignment to {lhs.driver}.{lhs.prop} in a "
            f"{ctx.kind} context not lowerable")

    def _det_scatter_set(self, arr, ids_vec, val, mask):
        """Masked scatter-set with duplicate keys resolved to the lowest
        context position (reproducible stand-in for the reference's
        last-CAS-wins nondeterminism).  Rejected under edge sharding, as
        the reference's distributed backend rejects random writes
        (gm_gps_new_check_random_write.cc)."""
        if self.axis is not None:
            raise LowerError("random scatter write not supported in "
                             "distributed lowering (the reference GPS "
                             "backend rejects these too)")
        n = LN.lshape(ids_vec)[0]
        n_rows = LN.lshape(arr)[0]
        ids_c = ids_vec.clamp(0, n_rows - 1)
        pos = torch.arange(n, dtype=_I32, device=self.dev)
        cand = torch.where(mask & (ids_vec >= 0), pos, n)
        win = _seg("min", cand, ids_c, n_rows, safe=True)
        touched = win < n
        winc = win.clamp(max=n - 1)
        v = self._a(val)
        vals_b = LN.expand_like(v, pos) if LN.lshape(v) == () else v
        picked = take(vals_b, winc).to(arr.dtype)
        return torch.where(touched, picked, arr)

    def _owner_lane_key(self, ctx, owner):
        """Per-current-lane index into ``owner``'s lane space, for
        reductions into an enclosing context's scalar local.  Owner
        lanes: NodeCtx = node ids ([N_pad] iota), EdgeCtx = slots."""
        if getattr(ctx, "parent", None) is owner:
            if ctx.kind == "wedge":
                return ctx.sel, ctx.parent_len
            if ctx.kind == "edge":
                return ctx.outer_ids, owner.mask.shape[0]
        if (ctx.kind == "wedge"
                and getattr(ctx.parent, "kind", None) == "edge"
                and getattr(ctx.parent, "parent", None) is owner):
            # wedge -> edge slot -> node lane
            return (ctx.parent.outer_ids[ctx.sel.long()],
                    owner.mask.shape[0])
        raise LowerError(
            "reduction into a local declared more than two loop "
            "levels up not lowerable")

    def _seg_work(self, op, vals, mask, what):
        """(work, sub-op) of a masked reduction: AND/OR reduce int8 by
        min/max, the others by their own op."""
        if op in ("AND", "OR"):
            sub = "min" if op == "AND" else "max"
            ident = _identity("MIN" if op == "AND" else "MAX", torch.int8,
                              self.dev)
            return torch.where(mask, vals.to(torch.int8), ident), sub
        sub = _SEG_OP.get(op)
        if sub is None:
            raise LowerError(what)
        return torch.where(mask, vals, _identity(op, vals.dtype,
                                                 self.dev)), sub

    def _exec_reduce_assign(self, s: A.ReduceAssign, env, ctx):
        op = s.op
        lhs = s.lhs
        g = self.g
        if isinstance(lhs, A.MapAccess):
            return self._exec_map_assign(s, env, ctx, op=op)
        if isinstance(lhs, A.Ident):
            dt = self._target_dtype(lhs, env)
            val = self.eval(s.rhs, env, ctx)
            if ctx is None:
                cur = env[lhs.name]
                self._wr(env, lhs.name, _coerce(_combine(op, cur, val), dt))
                return
            mask = ctx.mask
            vals = LN.expand_like(self._a(val), mask)
            # A scalar LOCAL of an enclosing vectorized context reduced
            # from a deeper loop is a PER-LANE accumulator (the reference
            # privatizes it per outer iteration): segment-reduce keyed by
            # the owner lane instead of a sum over everything.
            owner = None
            c = getattr(ctx, "parent", None)
            while c is not None:
                if lhs.name in c.locals:
                    owner = c
                    break
                c = getattr(c, "parent", None)
            if owner is not None:
                key, nseg = self._owner_lane_key(ctx, owner)
                work, sub = self._seg_work(
                    op, vals, mask,
                    f"{op}= into an enclosing-loop local not lowerable")
                seg = _seg(sub, work, self._a(key), nseg)
                if self.axis is not None and ctx.kind == "edge":
                    # partial per-lane results per edge shard
                    seg = self._pcomb(seg.to(torch.int8)
                                      if op in ("AND", "OR") else seg, sub)
                if op in ("AND", "OR"):
                    seg = seg > 0
                cur = LN.expand_like(self._a(env[lhs.name]), seg)
                self._wr(env, lhs.name, _coerce(_combine(op, cur, seg), dt))
                return
            ident = _identity(op, vals.dtype, self.dev)
            r = _RED[op](torch.where(mask, vals, ident))
            if self.axis is not None and ctx.kind == "edge":
                if op in ("AND", "OR"):
                    r = self._pcomb(r.to(torch.int8),
                                    "min" if op == "AND" else "max") > 0
                else:
                    r = self._pcomb(r, _SEG_OP.get(op, op))
            cur = env[lhs.name]
            self._wr(env, lhs.name, _coerce(_combine(op, cur, r), dt))
            return
        if not isinstance(lhs, A.Field):
            raise LowerError("reduce target must be scalar or field")
        loc, dt = self.props[lhs.prop]
        key = _F + lhs.prop
        arr = env[key]
        if ctx is None:
            ids = self._ident(lhs.driver, env, ctx)
            val = self.eval(s.rhs, env, ctx)
            cur = self._take(arr, ids)
            self._wr(env, key, put(arr, ids, _coerce(_combine(op, cur, val),
                                                     dt)))
            return
        if ctx.kind == "node" and lhs.driver == ctx.var:
            val = self._a(self.eval(s.rhs, env, ctx))
            new = _coerce(_combine(op, arr, val), dt)
            self._wr(env, key, torch.where(ctx.mask, new, arr))
            return
        if ctx.kind == "node" and loc == "N":
            # reduction keyed by a per-slot local node vector
            # (``m.TokenNxt ++`` with random m in the sampling walks):
            # segment reduction over arbitrary ids — the reference emits
            # an atomic add here (gm_cpp_gen.cc:1526-1561)
            idv = self._a(self._ident(lhs.driver, env, ctx))
            if len(LN.lshape(idv)) == 1 and \
                    LN.lshape(idv) == LN.lshape(ctx.mask):
                val = self.eval(s.rhs, env, ctx)
                vals = LN.expand_like(self._a(val), ctx.mask)
                work, sub = self._seg_work(
                    op, vals, ctx.mask,
                    f"{op}= with random target not lowerable")
                seg = _seg(sub, work, idv, g.n_pad)
                if op in ("AND", "OR"):
                    seg = seg > 0
                self._wr(env, key, _coerce(_combine(op, arr, seg), dt))
                return
        if ctx.kind == "wedge":
            val = self.eval(s.rhs, env, ctx)
            vals = LN.expand_like(self._a(val), ctx.mask)
            work, sub = self._seg_work(op, vals, ctx.mask,
                                       f"{op}= in a wedge context")
            if loc != "N":
                raise LowerError("edge-property reduce in wedge context")
            if lhs.driver == ctx.var:
                key_ids = ctx.inner_ids
            elif lhs.driver == ctx.outer_var:
                key_ids = ctx.outer_ids
            else:
                raise LowerError(
                    f"reduce into {lhs.driver}.{lhs.prop} from wedge ctx")
            seg = _seg(sub, work, key_ids, g.n_pad)
            if op in ("AND", "OR"):
                seg = seg > 0
            self._wr(env, key, _coerce(_combine(op, arr, seg), dt))
            return
        if ctx.kind == "edge":
            val = self.eval(s.rhs, env, ctx)
            vals = LN.expand_like(self._a(val), ctx.mask)
            work, sub = self._seg_work(
                op, vals, ctx.mask, f"{op}= over neighbors not lowerable")
            if lhs.driver == ctx.outer_var or (
                    ctx.parent is not None and (
                        lhs.driver == ctx.parent.var
                        or lhs.driver in ctx.parent.aliases)):
                # pull: reduce along the sorted axis
                sortkey = (g.node_idx_src if ctx.layout == "csr"
                           else g.r_node_idx_dst)
                offs = (g.csr_offsets() if ctx.layout == "csr"
                        else g.csc_offsets())
                seg = _sorted_reduce(work, sortkey, offs, g.n_pad, sub)
                touch_ids = sortkey
            elif lhs.driver == ctx.inner_var:
                # push: unsorted scatter-reduce keyed by the neighbor
                seg = _seg(sub, work, ctx.inner_ids, g.n_pad,
                           safe=self._in_range(ctx.inner_ids, g.n_pad))
                touch_ids = ctx.inner_ids
            else:
                raise LowerError(
                    f"reduce into {lhs.driver}.{lhs.prop} from edge ctx")
            seg = self._pcomb(seg, sub)
            if op in ("AND", "OR"):
                new = _combine(op, arr, seg > 0)
            else:
                new = _coerce(_combine(op, arr, seg.to(arr.dtype)), dt)
            # only touch rows that had at least one active slot
            touched = self._pcomb(_seg(
                "max", ctx.mask.to(torch.int8), touch_ids, g.n_pad,
                safe=self._in_range(touch_ids, g.n_pad)), "max") > 0
            self._wr(env, key, torch.where(touched, new, arr))
            return
        raise LowerError("unsupported reduce-assign placement")

    def _exec_defer(self, s: A.DeferAssign, env, ctx):
        """x <= v @ it — visible only after the binding loop completes
        (the defer opt's double-buffer, gm_cpp_opt_defer.cc)."""
        if ctx is None:
            self._exec_assign(A.Assign(lhs=s.lhs, rhs=s.rhs), env, ctx)
            return
        if not isinstance(s.lhs, A.Field):
            raise LowerError("deferred write target must be a field")
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        if ctx.kind == "node" and s.lhs.driver == ctx.var:
            pend = (key, ctx.mask, LN.expand_like(val, env[key]))
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

    def _apply_pending(self, env, pend):
        for key, mask, val in pend:
            self._wr(env, key, _where(mask, val, env[key]))

    def _exec_argminmax(self, s: A.ArgMinMaxAssign, env, ctx):
        """<a; b...> min= <v; w...> — atomic compare-and-swap group write
        (reference spinlock path gm_cpp_gen.cc:1563-1742), lowered to a
        segment-min + win-mask payload select."""
        is_min = s.op == "MIN"
        if ctx is None or ctx.kind == "node" or isinstance(s.lhs, A.Ident):
            # scalar-target argminmax reduces over the whole (possibly
            # edge/wedge) context — v_cover's global best-edge pick
            self._argminmax_scalar_or_node(s, env, ctx, is_min)
            return
        # edge context: push to the inner (neighbor) variable
        if not isinstance(s.lhs, A.Field) or s.lhs.driver != ctx.inner_var:
            raise LowerError("argmin/argmax target must be keyed by the "
                             "neighbor variable in a neighbor loop")
        g = ctx.g
        loc, dt = self.props[s.lhs.prop]
        key = _F + s.lhs.prop
        old = env[key]
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        ident = _identity("MIN" if is_min else "MAX", dt, self.dev)
        work = torch.where(ctx.mask, val, ident)
        m = _seg("min" if is_min else "max", work, ctx.inner_ids, g.n_pad,
                 safe=self._in_range(ctx.inner_ids, g.n_pad))
        m = self._pcomb(m, "min" if is_min else "max")
        improved = (m < old) if is_min else (m > old)
        self._wr(env, key, torch.where(improved, m, old))
        if not s.lhs_extra:
            return
        # payload select: the winning slot is the lowest slot id among
        # the achievers (the reference's winner is whichever thread's CAS
        # lands; ours is reproducible); under edge sharding the shards
        # agree on the lowest global slot (pmin), then sum-select its
        # payload
        extra_vals = [self.eval(r, env, ctx) for r in s.rhs_extra]
        need_slot = any(LN.lshape(self._a(v)) != () for v in extra_vals)
        mine = None
        if need_slot:
            win = ctx.mask & (work == self._take(m, ctx.inner_ids))
            cand = torch.where(win, self._iota_e, g.e_pad)
            win_slot = _seg("min", cand, ctx.inner_ids, g.n_pad,
                            safe=self._in_range(ctx.inner_ids, g.n_pad))
            if self.axis is not None:
                has_win = win_slot < g.e_pad
                g_slot = torch.where(has_win, win_slot + (g.e_base or 0),
                                     _INT32_MAX).to(_I32)
                mine = has_win & (g_slot == self.axis.pmin(g_slot))
            win_slot = win_slot.clamp(max=g.e_pad - 1)
        for lhs_e, rhs_v in zip(s.lhs_extra, extra_vals):
            if not isinstance(lhs_e, A.Field) or \
                    lhs_e.driver != ctx.inner_var:
                raise LowerError("argminmax payload target must be keyed "
                                 "by the same neighbor variable")
            _, edt = self.props[lhs_e.prop]
            ekey = _F + lhs_e.prop
            eold = env[ekey]
            rv = self._a(rhs_v)
            if LN.lshape(rv) != ():
                payload = take(_coerce(rv, edt), win_slot)
                if mine is not None:
                    # exactly one shard owns the winning global slot
                    wide = payload.to(_float_dtype() if edt.is_floating_point
                                      else _I32)
                    wide = self.axis.psum(torch.where(mine, wide, 0))
                    payload = (wide > 0) if edt == _BOOL else wide.to(edt)
            else:
                payload = _coerce(rv, edt)
            self._wr(env, ekey, _where(improved, payload, eold))

    def _argminmax_scalar_or_node(self, s, env, ctx, is_min):
        # reduction of <value; payload...> into scalars over a node ctx
        if ctx is None:
            raise LowerError("scalar argminmax outside a loop")
        if not isinstance(s.lhs, A.Ident):
            raise LowerError("scalar argminmax target must be an ident")
        dt = self._target_dtype(s.lhs, env)
        val = _coerce(self.eval(s.rhs, env, ctx), dt)
        ident = _identity("MIN" if is_min else "MAX", dt, self.dev)
        work = LN.expand_like(torch.where(ctx.mask, val, ident), ctx.mask)
        best = LN.reduce("min" if is_min else "max", work)
        idx = LN.arg("min" if is_min else "max", work)
        cur = env[s.lhs.name]
        improved = (best < cur) if is_min else (best > cur)
        self._wr(env, s.lhs.name, _where(improved, best, self._a(cur)))
        for lhs_e, rhs_e in zip(s.lhs_extra, s.rhs_extra):
            if not isinstance(lhs_e, A.Ident):
                raise LowerError("scalar argminmax payload must be ident")
            pv = self._a(self.eval(rhs_e, env, ctx))
            pick = take(pv, idx) if LN.lshape(pv) != () else pv
            edt = self._target_dtype(lhs_e, env)
            if edt is not None:
                pick = _coerce(pick, edt)
            self._wr(env, lhs_e.name,
                     _where(improved, pick, self._a(env[lhs_e.name])))

    def _exec_foreach(self, s: A.Foreach, env, ctx):
        it = s.iterator
        if it.source in self.graphs and it.iter_type == "NODES" and \
                ctx is None and contains_bfs(s.body):
            # sequential For over nodes whose body contains InBFS/InDFS
            # (kosaraju's restart loop) — the reference serializes these
            # too (select_par marks BFS bodies sequential)
            return self._exec_for_nodes_eager(s, env)
        if it.source in self.graphs and it.iter_type in ("NODES", "EDGES"):
            if it.iter_type == "NODES":
                lctx = self._node_ctx(it, env, ctx)
            else:
                lctx = self._edge_ctx(it, env, None)
            if s.filter is not None:
                lctx = lctx.with_mask(lctx.mask &
                                      self.eval(s.filter, env, lctx))
            self._defer_stack.append((it.var, []))
            try:
                self.exec_stmt(s.body, env, lctx)
            finally:
                _, pend = self._defer_stack.pop()
            self._apply_pending(env, pend)
            return
        if it.iter_type in ("NBRS", "OUT_NBRS", "IN_NBRS"):
            # Snapshot env before attempting the vectorized lowering: a
            # LowerError raised mid-body must not leave partially
            # committed writes behind before the eager retry (otherwise
            # e.g. a += preceding the failing statement would apply twice)
            snap = dict(env)
            try:
                ectx = self._edge_ctx(it, env, ctx)
                if s.filter is not None:
                    ectx = ectx.with_mask(ectx.mask &
                                          self.eval(s.filter, env, ectx))
                self.exec_stmt(s.body, env, ectx)
                return
            except LowerError:
                # order-dependent body over a *scalar* node's neighbors
                # (tarjan's LowLink min-fold): run it sequentially, like
                # the reference's inner loops (select_par)
                if ctx is not None:
                    raise
                u = snap.get(it.source)
                if u is None or self._traced(u):
                    raise
                env.clear()
                env.update(snap)
                return self._exec_for_nbrs_eager(s, env)
        if it.iter_type == "COMMON_NBRS":
            ectx = self._common_nbr_ctx(it, env, ctx)
            if s.filter is not None:
                ectx = ectx.with_mask(ectx.mask &
                                      self.eval(s.filter, env, ectx))
            self.exec_stmt(s.body, env, ectx)
            return
        if it.iter_type == "ITEMS":
            return self._exec_for_items(s, env, ctx)
        raise LowerError(f"foreach over {it.iter_type} not lowerable yet")

    def _exec_for_nbrs_eager(self, s: A.Foreach, env):
        it = s.iterator
        g = self.g
        if g.num_nodes > self._EAGER_SCALE_LIMIT:
            raise LowerError(
                "sequential neighbor loop on a graph with "
                f"{g.num_nodes} nodes (host round-trip per element; "
                "rewrite the body in vectorizable form)")
        u = int(env[it.source])
        if it.iter_type == "IN_NBRS":
            begin, ni = g.r_begin.cpu().numpy(), g.r_node_idx.cpu().numpy()
        else:
            begin, ni = g.begin.cpu().numpy(), g.node_idx.cpu().numpy()
        for w in ni[begin[u]:begin[u + 1]]:
            env[it.var] = self._c(int(w), _I32)
            if s.filter is not None:
                if not self._host_bool(self.eval(s.filter, env, None),
                                       "traced filter on a sequential "
                                       "neighbor loop"):
                    continue
            self.exec_stmt(s.body, env, None)
        env.pop(it.var, None)

    def _exec_for_nodes_eager(self, s: A.Foreach, env):
        it = s.iterator
        if self.g.num_nodes > self._EAGER_SCALE_LIMIT:
            raise LowerError(
                "sequential node loop on a graph with "
                f"{self.g.num_nodes} nodes (host round-trip per "
                "element; rewrite in vectorizable form)")
        for v in range(self.g.num_nodes):
            env[it.var] = self._c(v, _I32)
            if s.filter is not None:
                if not self._host_bool(self.eval(s.filter, env, None),
                                       "traced filter on a sequential "
                                       "node loop"):
                    continue
            self.exec_stmt(s.body, env, None)
        env.pop(it.var, None)

    def _exec_for_items(self, s: A.Foreach, env, ctx):
        """Sequential For over collection items — the reference always
        runs collection iteration sequentially
        (``gm_cpp_opt_select_par.cc:27-108``), so an eager host loop over
        the concrete items is the faithful lowering (bc.gm's seed loop)."""
        it = s.iterator
        if ctx is not None:
            raise LowerError("collection iteration inside a parallel loop")
        coll = env.get(it.source)
        if coll is None:
            raise LowerError(f"unbound collection {it.source}")
        kind = self.collections.get(it.source)
        if (self._traced(coll) if kind == "NSET"
                else self._concrete is not None or LN.lanes_of(coll)):
            raise LowerError("collection iteration inside a traced loop "
                             "(items are data-dependent)")
        if kind == "NSET":
            items = np.nonzero(coll.cpu().numpy())[0]
        elif kind == "NORDER":
            items = coll.seq.items().cpu().numpy()[:int(coll.seq.count)]
        else:
            items = coll.items().cpu().numpy()[:int(coll.count)]
        for v in items:
            env[it.var] = self._c(int(v), _I32)
            if s.filter is not None:
                if not self._host_bool(self.eval(s.filter, env, None),
                                       "traced filter on sequential "
                                       "collection iteration"):
                    continue
            self._defer_stack.append((it.var, []))
            try:
                self.exec_stmt(s.body, env, None)
            finally:
                _, pend = self._defer_stack.pop()
            self._apply_pending(env, pend)
        env.pop(it.var, None)

    def _exec_if(self, s: A.If, env, ctx):
        cond = self.eval(s.cond, env, ctx)
        if ctx is not None:
            c = LN.expand_like(self._a(cond), ctx.mask)
            self.exec_stmt(s.then, env, ctx.with_mask(ctx.mask & c))
            if s.els is not None:
                self.exec_stmt(s.els, env, ctx.with_mask(ctx.mask & ~c))
            return
        cond = self._a(cond)
        if not self._traced(cond) and cond.numel() == 1:
            # concrete condition (eager execution): take one branch — the
            # faithful sequential semantics, and it keeps loops whose
            # guard is false from running at all (bidir_dijkstra's path
            # walk when no path was found)
            if bool(cond):
                self.exec_stmt(s.then, env, ctx)
            elif s.els is not None:
                self.exec_stmt(s.els, env, ctx)
            return
        # traced (or non-scalar) condition: run both branches, merge
        env_t = dict(env)
        self.exec_stmt(s.then, env_t, ctx)
        env_e = dict(env)
        if s.els is not None:
            self.exec_stmt(s.els, env_e, ctx)
        keys = set()
        for k in set(env_t) | set(env_e):
            if env_t.get(k) is not env.get(k) or \
                    env_e.get(k) is not env.get(k):
                keys.add(k)
        for k in keys:
            tv = env_t.get(k, env.get(k))
            ev = env_e.get(k, env.get(k))
            if tv is None:
                env[k] = ev
            elif ev is None:
                env[k] = tv
            elif not isinstance(tv, (torch.Tensor, np.ndarray, int, float,
                                     bool, np.generic)):
                # collection values (NodeSeq etc.): merge leafwise
                env[k] = tree_map(lambda a, b: _where(cond, a, b), tv, ev)
            else:
                tv2, ev2 = self._unify(tv, ev)
                env[k] = torch.where(cond, tv2, ev2)

    def _uses_map(self, stmt) -> bool:
        maps = {n for n, k in self.collections.items() if k == "MAP"}
        return bool(maps) and _any_node(
            stmt, lambda n: (isinstance(n, A.MapAccess)
                             and n.map_name in maps)
            or (isinstance(n, A.Builtin) and n.driver in maps))

    def _exec_while(self, s: A.While, env, ctx):
        if ctx is not None:
            return self._exec_while_masked(s, env, ctx)
        if contains_bfs(s.body):
            # BFS bodies are host-replayed per level (lower_bfs), so a
            # loop containing one runs as an eager host loop — matching
            # the reference, which marks BFS-containing bodies sequential
            return self._exec_while_eager(s, env)
        if self._uses_map(s.body) or self._uses_map(s.cond):
            # Priority-map loops (Dijkstra class): the canonical
            # pop-min/relax idiom lowers to device Bellman-Ford
            # supersteps (lower_priority).
            from .lower_priority import try_bidir_while, try_priority_while
            if try_priority_while(self, s, env):
                return
            if try_bidir_while(self, s, env):
                return
            # Otherwise: inherently sequential in the reference; run
            # host-eager
            return self._exec_while_eager(s, env)
        return self._exec_while_traced(s, env)

    def _carry_keys(self, s: A.While, env, what: str):
        wkeys = written_keys(s.body)
        dkeys = declared_keys(s.body)
        if uses_rng(s.body) or uses_rng(s.cond):
            wkeys.add(_RNG)
            env.setdefault(_RNG, self._c(0, torch.int64))
        carry_keys = sorted((wkeys - dkeys) - {_RET, _DONE})
        if (_RET in wkeys) or (_DONE in wkeys):
            raise LowerError(what)
        for k in carry_keys:
            if k not in env:
                raise LowerError(f"loop writes undeclared symbol {k}")
        return carry_keys

    def _carry_init(self, env, keys):
        init = tuple(self._a(env[k]) if isinstance(
            env[k], (torch.Tensor, np.ndarray, int, float, bool))
            else env[k] for k in keys)
        shapes = [(LN.lshape(v), v.dtype)
                  if isinstance(v, torch.Tensor) else None for v in init]
        return init, shapes

    def _carry_out(self, e2, keys, shapes):
        """The body's values of the carried keys, cast back to their carry
        dtypes (a loop carry keeps its type and, lane for lane, its
        shape)."""
        out = []
        for k, sd in zip(keys, shapes):
            if sd is None:
                out.append(e2[k])
                continue
            shape, dt = sd
            v = self._a(e2[k])
            if LN.lshape(v) != shape:
                raise LowerError(
                    f"loop-carried {k} changes shape {shape}->"
                    f"{LN.lshape(v)}")
            out.append(v.to(dt))
        return tuple(out)

    @staticmethod
    def _fresh(carry):
        """New tensor objects for the carry, so that no carried value
        shares an id with a concrete one."""
        return tuple(tree_map(lambda x: x.clone() if isinstance(
            x, torch.Tensor) else x, v) for v in carry)

    @staticmethod
    def _spread(carry, b: int):
        """Every carry entry per lane: JAX's ``while_loop`` batching rule
        once the predicate is a lane value."""
        return tuple(tree_map(lambda x: LN.spread(x, b) if isinstance(
            x, torch.Tensor) and not LN.is_lanes(x) else x, v) for v in carry)

    @staticmethod
    def _keep(go, new, old):
        """The carry after a pass: the lanes whose predicate ``go`` ([B, 1])
        was false keep their old one (JAX's ``select`` in the batched
        ``while_loop``)."""
        def sel(n, o):
            if not isinstance(n, torch.Tensor):
                return n
            g = go.reshape((go.shape[0],) + (1,) * (max(n.dim(),
                                                         o.dim()) - 1))
            return torch.where(g, n, o)
        return tuple(tree_map(sel, n, o) for n, o in zip(new, old))

    def _exec_while_traced(self, s: A.While, env):
        """The ``lax.while_loop`` lowering: the body runs once per pass in
        a traced region, and its draw sites keep the numbers of the first
        pass (JAX traces the condition once, then the body once, even
        when the loop never runs).  A predicate that depends on the lanes
        of a batched run is read once a pass as ``any`` over them; every
        carry entry is then per lane and a lane whose predicate is false
        keeps its carry.

        Under a profiler each pass is a ``gm:lower:pass`` span: the body,
        then the predicate read that decides whether another pass runs
        (a ``While``'s first read comes before its first pass)."""
        carry_keys = self._carry_keys(
            s, env, "Return inside While not lowerable yet")
        tally = _LoopTally()
        with contextlib.ExitStack() as first_pass:
            if s.do_while:
                first_pass.enter_context(span(PASS_SPAN))
                self.exec_stmt(s.body, env, None)
                tally.ran()
            init, shapes = self._carry_init(env, carry_keys)

            def overlay(carry):
                e2 = dict(env)
                e2.update(zip(carry_keys, carry))
                return e2

            def cond(carry):
                c = self._a(self.eval(s.cond, overlay(carry), None), _BOOL)
                if LN.is_lanes(c):
                    return c
                b = bool(c.reshape(()))
                # a sharded run reads the predicate on every shard: they
                # must agree (it comes out of collectives)
                return self.axis.agree(b) if self.axis is not None else b

            with self._trace(env, set(carry_keys)):
                carry = self._fresh(init)
                cond_base = self._rng_site
                go = cond(carry)
                runs = tally.runs(go)
                first_pass.close()
                body_base = self._rng_site
                body_end = None
                while runs:  # each condition pass ends at body_base
                    with span(PASS_SPAN):
                        if LN.is_lanes(go):
                            carry = self._spread(carry, go.shape[0])
                        e2 = overlay(carry)
                        self.exec_stmt(s.body, e2, None)
                        tally.ran()
                        body_end = self._rng_site
                        new = self._carry_out(e2, carry_keys, shapes)
                        carry = self._keep(go, new, carry) \
                            if LN.is_lanes(go) else new
                        self._rng_site = cond_base
                        go = cond(carry)
                        runs = tally.runs(go)
                if body_end is None:
                    self._rng_site = body_base
                    e2 = overlay(carry)
                    self.exec_stmt(s.body, e2, None)
                    dry = self._carry_out(e2, carry_keys, shapes)
                    body_end = self._rng_site
                    # what the body makes a lane value stays one
                    carry = tuple(
                        self._spread((c,), LN.lanes_of(d))[0]
                        if LN.lanes_of(d) else c for c, d in zip(carry, dry))
                if LN.is_lanes(go):
                    carry = self._spread(carry, go.shape[0])
                self._rng_site = body_end
        for k, v in zip(carry_keys, carry):
            env[k] = v

    def _exec_while_masked(self, s: A.While, env, ctx):
        """Per-slot While inside a parallel node loop
        (``While (n.Token > 0)`` in parallel_random_walk_jump_sampling):
        the body runs with the mask narrowed to the still-active slots —
        each slot exits its own loop independently, like each OpenMP
        thread exiting its private while in the reference's code.  With
        lane values in the mask, a pass runs while any slot of any lane is
        active, and a lane with none keeps its carry."""
        if ctx.kind != "node":
            raise LowerError("while-loop inside a non-node parallel "
                             "context not lowerable")
        carry_keys = self._carry_keys(s, env,
                                      "Return inside a masked While")
        init, shapes = self._carry_init(env, carry_keys)

        def overlay(carry):
            e2 = dict(env)
            e2.update(zip(carry_keys, carry))
            return e2

        def cond_of(e2):
            return LN.expand_like(self._a(self.eval(s.cond, e2, ctx)),
                                  ctx.mask)

        def body(carry, act):
            e2 = overlay(carry)
            self.exec_stmt(s.body, e2, ctx.with_mask(act))
            out = self._carry_out(e2, carry_keys, shapes)
            # the active set narrows MONOTONICALLY: once a slot observes
            # a false condition it exits for good, like the reference's
            # per-thread while
            return out, act & cond_of(overlay(out))

        if s.do_while:
            e2 = overlay(init)
            self.exec_stmt(s.body, e2, ctx)
            init = tuple(self._a(e2[k]) if sd is not None else e2[k]
                         for k, sd in zip(carry_keys, shapes))
        act0 = ctx.mask & cond_of(overlay(init))
        with self._trace(env, set(carry_keys), ctx):
            carry = self._fresh(init)
            act = act0.clone()
            base = self._rng_site
            end = None
            while self._any_active(act):
                self._rng_site = base
                if LN.is_lanes(act):
                    go = LN.reduce("any", act)
                    carry = self._spread(carry, go.shape[0])
                    new, act = body(carry, act)
                    carry = self._keep(go, new, carry)
                else:
                    carry, act = body(carry, act)
                end = self._rng_site
            if end is None:
                self._rng_site = base
                body(carry, act)
                end = self._rng_site
            if LN.is_lanes(act):
                carry = self._spread(carry, act.shape[0])
            self._rng_site = end
        for k, v in zip(carry_keys, carry):
            env[k] = v

    def _any_active(self, act) -> bool:
        """Does any slot of a masked While run on?  Under a mesh axis, on
        any shard: every shard then runs the pass (its slots masked); in a
        batched run, in any lane."""
        a = LN.plain(act).any()
        if self.axis is not None:
            a = self.axis.pmax(a.to(torch.int8)) > 0
        return bool(a)

    def _exec_while_eager(self, s: A.While, env, max_iters=1_000_000):
        """Host-driven sequential loop for untraceable bodies (InBFS)."""
        def cond():
            return self._host_bool(self.eval(s.cond, env, None),
                                   "BFS-containing loop with a traced "
                                   "condition is not lowerable")
        if s.do_while:
            self.exec_stmt(s.body, env, None)
        it = 0
        while cond():
            self.exec_stmt(s.body, env, None)
            it += 1
            if it > max_iters:
                raise LowerError("runaway sequential loop")

    def _exec_return(self, s: A.Return, env, ctx):
        if ctx is not None:
            raise LowerError("Return inside a parallel loop")
        val = (self.eval(s.value, env, ctx)
               if s.value is not None else self._c(0, _I32))
        if self.proc.return_type is not None:
            val = _coerce(val, dtype_of_kind(self.proc.return_type.kind))
        done = env.get(_DONE)
        if done is None:
            env[_RET] = val
        else:
            old = env.get(_RET, val)
            old2, val2 = self._unify(old, val)
            env[_RET] = torch.where(done, old2, val2)
        env[_DONE] = self._c(True, _BOOL)

    def _exec_bfs(self, s: A.BFS, env, ctx):
        if self.axis is not None and not s.is_bfs:
            # a host DFS needs concrete neighbour walks
            raise LowerError("InDFS not supported in distributed "
                             "lowering (inherently sequential)")
        from .lower_bfs import exec_bfs
        exec_bfs(self, s, env, ctx)


# --------------------------------------------------------------------------
# Public driver
# --------------------------------------------------------------------------

def _bind_collection(kind: str, val, g: Graph):
    """Bind a Node_Set/Seq/Order argument (by-reference in the reference
    runtime, gm_default_usermain.cc): unsupplied -> empty (output-style)."""
    dev = g.device
    if kind == "NSET":
        if val is None:
            return torch.zeros(g.n_pad, dtype=_BOOL, device=dev)
        if isinstance(val, NodeSet):
            return val.bits.to(dev)
        arr = _asarray(val, dev)
        if arr.dtype == _BOOL and tuple(arr.shape) == (g.n_pad,):
            return arr
        # list of member ids
        return put(torch.zeros(g.n_pad, dtype=_BOOL, device=dev), arr, True)
    if kind == "NSEQ":
        if val is None:
            return NodeSeq.empty(g.n_pad, dev)
        if isinstance(val, NodeSeq):
            return val
        seq = NodeSeq.empty(g.n_pad, dev)
        for v in np.asarray(val).tolist():
            seq = seq.push_back(int(v))
        return seq
    if val is None:
        return NodeOrder.empty(g.n_pad, g.n_pad, dev)
    if isinstance(val, NodeOrder):
        return val
    order = NodeOrder.empty(g.n_pad, g.n_pad, dev)
    for v in np.asarray(val).tolist():
        order = order.push_back(int(v))
    return order


def _lane_leading(x, b: int) -> torch.Tensor:
    """An output of a batched run with its lane axis leading, as
    ``vmap``'s ``out_axes=0`` gives it: a lane scalar [B, 1] becomes [B], an
    unbatched value is repeated for every lane."""
    if LN.is_lanes(x):
        return LN.plain(x).reshape(b) if LN.lshape(x) == () else LN.plain(x)
    x = _asarray(x)
    return x.unsqueeze(0).expand((b,) + tuple(x.shape)).contiguous()


class CompiledProc:
    """A lowered Green-Marl procedure.

    ``__call__(g, *args, **kwargs)`` binds arguments positionally in
    declaration order (graph first, like generated mains) or by name;
    output properties (the reference's post-``;`` args) are allocated
    automatically unless provided.  Returns a dict of output-property
    tensors plus ``"_return"`` when the procedure returns a value.  The
    program runs on the graph's device.
    """

    def __init__(self, proc: A.Procedure):
        self.proc = proc

    @property
    def name(self):
        return self.proc.name

    def _bind(self, g: Graph, args, kwargs, axis=None):
        env: Dict = {}
        lw = Lowerer(self.proc, g, axis=axis)
        dev = g.device
        pos = list(args)
        out_names = []
        for decl in self.proc.args:
            for name in decl.names:
                if decl.type.kind == "GRAPH":
                    env[name] = g
                    continue
                if decl.type.kind in ("NSET", "NSEQ", "NORDER"):
                    env[name] = _bind_collection(
                        decl.type.kind, kwargs.get(name), g)
                    if name not in kwargs:
                        out_names.append(name)
                    continue
                if name in kwargs:
                    val = kwargs[name]
                elif pos:
                    val = pos.pop(0)
                elif decl.type.is_property():
                    # properties are by-reference in the reference runtime;
                    # unsupplied ones are allocated (output-style usage,
                    # e.g. hop_dist's dist) and returned
                    loc, dt = lw.props[name]
                    out_names.append(name)
                    env[_F + name] = _alloc_prop(g, loc, dt)
                    continue
                else:
                    raise TypeError(f"missing argument {name}")
                if decl.type.is_property():
                    loc, dt = lw.props[name]
                    env[_F + name] = _coerce(_asarray(val, dev), dt)
                else:
                    env[name] = _coerce(_asarray(val, dev),
                                        dtype_of_kind(decl.type.kind))
        for decl in self.proc.out_args:
            for name in decl.names:
                out_names.append(name)
                if decl.type.is_property():
                    loc, dt = lw.props[name]
                    if name in kwargs:
                        env[_F + name] = _coerce(
                            _asarray(kwargs[name], dev), dt)
                    else:
                        env[_F + name] = _alloc_prop(g, loc, dt)
                else:
                    env[name] = _coerce(_asarray(kwargs.get(name, 0), dev),
                                        dtype_of_kind(decl.type.kind))
        return lw, env, out_names

    def __call__(self, g: Graph, *args, **kwargs):
        lw, env, out_names = self._bind(g, args, kwargs)
        lw.run(env)
        out = {}
        for name in out_names:
            out[name] = env.get(_F + name, env.get(name))
        if _RET in env:
            out["_return"] = env[_RET]
        return out

    def batch(self, g: Graph, over: Dict[str, object], **fixed):
        """Batched-instance execution of the compiled procedure: one
        instance (lane) per entry of ``over``, all advanced in lockstep, as
        the JAX package's ``vmap`` advances them.

        ``over`` maps argument names to arrays with one leading entry per
        lane; all other arguments are shared.  What depends on ``over`` is
        a lane value (``runtime.lanes``); everything else is computed once.
        One pass of a ``While`` body serves every lane, and a pull
        reduction over ``[B, E_pad]`` values is one launch of the
        lane-batched kernels.  A predicate that depends on the lanes
        counts as traced: an ``If`` on it runs both branches, a ``While``
        on it runs while any lane's holds (a lane whose predicate is false
        keeps its state), a host read of it raises ``LowerError`` ("...
        cannot batch"), as JAX refuses it.  A host-eager construct (a DFS,
        a collection Items loop, a priority-map While) whose host reads do
        not depend on the lanes runs once for every lane, as under JAX's
        ``vmap``.  Returns the usual output dict, every value with a
        leading lane axis.

        Example::

            cp = compile_file("hop_dist.gm")
            out = cp.batch(g, over={"root": torch.arange(1024)})
            out["dist"]          # [1024, N_pad]
        """
        names = sorted(over)
        vals = [_asarray(over[n], g.device) for n in names]
        if not vals or any(v.dim() == 0 or v.shape[0] != vals[0].shape[0]
                           for v in vals):
            raise ValueError("over= arrays must share a leading dim")
        b = int(vals[0].shape[0])
        kw = dict(fixed)
        kw.update({n: LN.mark(v.reshape(b, 1) if v.dim() == 1 else v)
                   for n, v in zip(names, vals)})
        try:
            out = self(g, **kw)
        except LowerError as e:
            if "cannot batch" in str(e):
                raise
            raise LowerError(f"{e}: cannot batch") from e
        return {k: tree_map(lambda x: _lane_leading(x, b), v)
                for k, v in out.items()}

    def jit(self):
        """The whole-procedure call.  The JAX package compiles the program
        into one XLA executable here; this port runs it eagerly (no
        ``torch.compile``), so the returned callable is ``self``."""
        return self.__call__


def compile_source(text: str, name: Optional[str] = None,
                   filename: str = "<input>",
                   optimize: bool = True) -> CompiledProc:
    """Parse + typecheck + optimize + lower a Green-Marl source string."""
    from .parser import parse
    procs = parse(text, filename)
    return _pick(procs, name, optimize)


def compile_file(path: str, name: Optional[str] = None,
                 optimize: bool = True) -> CompiledProc:
    import os
    from .parser import parse_file
    procs = parse_file(path)
    if name is None:
        # prefer the procedure named like the file (the reference's
        # usermain binds <app>_main.cc to the same-named proc)
        base = os.path.splitext(os.path.basename(path))[0]
        if any(p.name == base for p in procs):
            name = base
    return _pick(procs, name, optimize)


def _pick(procs: List[A.Procedure], name: Optional[str],
          optimize: bool = True) -> CompiledProc:
    """Full pipeline (reference driver ``gm_main.cc:152-290``):
    typecheck -> race report -> independent optimizer -> re-typecheck
    (optimizer-introduced temporaries get fresh annotations) -> lower."""
    typecheck(procs)
    # Race detection (reference ``gm_fe_rw_analysis_check2.cc``): WW
    # conflicts are *warnings* there; the lowering gives those writes
    # deterministic lowest-slot-winner semantics and surfaces the same
    # warnings.
    from .rw_analysis import analyze as _rw_analyze
    rw = _rw_analyze(procs)
    for w in rw.warnings:
        warnings.warn(w, RaceWarning, stacklevel=3)
    if optimize:
        from . import opt
        procs = [opt.optimize(p, clone=True) for p in procs]
        typecheck(procs, semantic=False)
    if name is None:
        cands = [p for p in procs if not p.is_local]
        proc = cands[-1]
    else:
        proc = next(p for p in procs if p.name == name)
    cp = CompiledProc(proc)
    cp.race_warnings = list(rw.warnings)
    return cp
