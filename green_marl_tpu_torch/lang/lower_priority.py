"""Device lowering of the priority-map (Dijkstra) idiom.

Counterpart of ``green_marl_tpu/lang/lower_priority.py``.  The reference
runs ``Map<Node,Int>``-driven While loops sequentially on a mutable
priority map (``inc/gm_mutatable_priority_map.h``): one pop-min and
neighbor relaxation per iteration, one host round-trip per node if
replayed eagerly.  This pass recognizes the canonical shape::

    While (<flags>) {
      If (M.Size() == 0) { failed = True; }
      Else {
        Node next = M.GetMinKey();
        If (next == dest) { found = True; }
        Else {
          next.Settled = True;            // 0+ settled writes
          T dist = M[next];
          M.Remove(next);
          For (v: next.Nbrs)(!v.Settled) {
            Edge e = v.ToEdge();
            If (!M.HasKey(v))        { M[v] = RELAX; <writes> }
            Else If (M[v] > RELAX)   { M[v] = RELAX; <writes> }
          }
        }
      }
    }

and emits label-correcting Bellman-Ford supersteps instead: ``sdist`` is
the fixpoint of the *same* RELAX expression (evaluated generically over the
edge context), the settled set is ``sdist < sdist[dest]``, and the
per-node writes are applied at the argmin-winning edge.  Each superstep
reads one flag on the host.  The relaxations are unsorted scatter-mins, as
in the JAX package.  Deviations from the sequential machine (tie-breaks,
nodes at exactly ``sdist[dest]``) are the JAX package's, documented there.

Requires non-negative RELAX increments.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import gm_ast as A
from .reproduce import Reproducer


def _expr_eq(a: A.Expr, b: A.Expr) -> bool:
    r = Reproducer()
    return r.expr(a) == r.expr(b)


def _is_true_const(e) -> bool:
    return isinstance(e, A.Const) and e.ctype == "BOOL" and bool(e.value)


def _single(block):
    if isinstance(block, A.Block) and len(block.stmts) == 1:
        return block.stmts[0]
    return block


def _stmts(block) -> List[A.Stmt]:
    if isinstance(block, A.Block):
        return list(block.stmts)
    return [block]


class _Match:
    map_name: str
    flag_failed: str
    flag_found: str
    next_var: str
    dest_var: str
    dist_var: str
    e_var: Optional[str]
    v_var: str
    settled_writes: List[A.Assign]
    relax: A.Expr
    edge_writes: List[A.Assign]
    filter_ok: bool


def _match(lw, s: A.While, env) -> Optional[_Match]:
    from .lower import _F
    if s.do_while:
        return None
    body = _stmts(s.body)
    if len(body) != 1 or not isinstance(body[0], A.If):
        return None
    if1 = body[0]
    # cond: M.Size() == 0
    c = if1.cond
    if not (isinstance(c, A.BinOp) and c.op == "==" and
            isinstance(c.lhs, A.Builtin) and
            c.lhs.name.lower() == "size" and
            isinstance(c.rhs, A.Const) and int(c.rhs.value) == 0):
        return None
    m = _Match()
    m.map_name = c.lhs.driver
    if lw.collections.get(m.map_name) != "MAP":
        return None
    th = _single(if1.then)
    if not (isinstance(th, A.Assign) and isinstance(th.lhs, A.Ident)
            and _is_true_const(th.rhs)):
        return None
    m.flag_failed = th.lhs.name
    if if1.els is None:
        return None
    els = _stmts(if1.els)
    if len(els) != 2 or not isinstance(els[0], A.VarDecl) or \
            not isinstance(els[1], A.If):
        return None
    vd = els[0]
    if len(vd.names) != 1 or vd.init is None or \
            not (isinstance(vd.init, A.Builtin) and
                 vd.init.name.lower() == "getminkey" and
                 vd.init.driver == m.map_name):
        return None
    m.next_var = vd.names[0]
    if2 = els[1]
    c2 = if2.cond
    if not (isinstance(c2, A.BinOp) and c2.op == "==" and
            isinstance(c2.lhs, A.Ident) and c2.lhs.name == m.next_var
            and isinstance(c2.rhs, A.Ident)):
        return None
    m.dest_var = c2.rhs.name
    th2 = _single(if2.then)
    if not (isinstance(th2, A.Assign) and isinstance(th2.lhs, A.Ident)
            and _is_true_const(th2.rhs)):
        return None
    m.flag_found = th2.lhs.name
    if if2.els is None:
        return None
    # while cond may only read the two exit flags
    names = set()

    def scan(e):
        if isinstance(e, A.Ident):
            names.add(e.name)
        for attr in ("lhs", "rhs", "operand"):
            sub = getattr(e, attr, None)
            if isinstance(sub, A.Expr):
                scan(sub)
    scan(s.cond)
    if not names <= {m.flag_failed, m.flag_found}:
        return None

    m.settled_writes = []
    m.dist_var = None
    removed = False
    loop = None
    for st in _stmts(if2.els):
        if isinstance(st, A.Assign) and isinstance(st.lhs, A.Field) and \
                st.lhs.driver == m.next_var:
            m.settled_writes.append(st)
        elif isinstance(st, A.VarDecl) and len(st.names) == 1 and \
                isinstance(st.init, A.MapAccess) and \
                st.init.map_name == m.map_name and \
                isinstance(st.init.key, A.Ident) and \
                st.init.key.name == m.next_var:
            m.dist_var = st.names[0]
        elif isinstance(st, A.CallStmt) and \
                st.call.name.lower() == "remove" and \
                st.call.driver == m.map_name:
            removed = True
        elif isinstance(st, A.Foreach) and loop is None:
            loop = st
        else:
            return None
    if m.dist_var is None or not removed or loop is None:
        return None
    it = loop.iterator
    if it.iter_type not in ("NBRS", "OUT_NBRS") or \
            it.source != m.next_var:
        return None
    m.v_var = it.var
    # filter must be absent or `!v.<settled prop>` (ignorable: relaxing
    # settled nodes never improves a monotone RELAX)
    m.filter_ok = True
    if loop.filter is not None:
        f = loop.filter
        settled_props = {w.lhs.prop for w in m.settled_writes}
        if not (isinstance(f, A.UnOp) and f.op == "NOT" and
                isinstance(f.operand, A.Field) and
                f.operand.driver == m.v_var and
                f.operand.prop in settled_props):
            return None
    lb = _stmts(loop.body)
    m.e_var = None
    if lb and isinstance(lb[0], A.VarDecl) and len(lb[0].names) == 1 \
            and isinstance(lb[0].init, A.Builtin) and \
            lb[0].init.name.lower() == "toedge":
        m.e_var = lb[0].names[0]
        lb = lb[1:]
    if len(lb) != 1 or not isinstance(lb[0], A.If):
        return None
    if3 = lb[0]
    c3 = if3.cond
    if not (isinstance(c3, A.UnOp) and c3.op == "NOT" and
            isinstance(c3.operand, A.Builtin) and
            c3.operand.name.lower() == "haskey" and
            c3.operand.driver == m.map_name):
        return None
    b1 = _stmts(if3.then)
    if4 = _single(if3.els) if if3.els is not None else None
    if not isinstance(if4, A.If) or if4.els is not None:
        return None
    c4 = if4.cond
    if not (isinstance(c4, A.BinOp) and c4.op == ">" and
            isinstance(c4.lhs, A.MapAccess) and
            c4.lhs.map_name == m.map_name):
        return None
    b2 = _stmts(if4.then)

    def split(blk):
        if not blk or not isinstance(blk[0], A.Assign) or \
                not isinstance(blk[0].lhs, A.MapAccess) or \
                blk[0].lhs.map_name != m.map_name:
            return None
        relax = blk[0].rhs
        writes = []
        for w in blk[1:]:
            if not (isinstance(w, A.Assign) and
                    isinstance(w.lhs, A.Field) and
                    w.lhs.driver == m.v_var):
                return None
            writes.append(w)
        return relax, writes

    r1 = split(b1)
    r2 = split(b2)
    if r1 is None or r2 is None:
        return None
    if not _expr_eq(r1[0], r2[0]) or not _expr_eq(c4.rhs, r1[0]):
        return None
    if len(r1[1]) != len(r2[1]) or any(
            not (_expr_eq(a.lhs, b.lhs) and _expr_eq(a.rhs, b.rhs))
            for a, b in zip(r1[1], r2[1])):
        return None
    m.relax = r1[0]
    m.edge_writes = r1[1]
    return m


def _bellman_ford(lw, env, dist0, relax_vals, inner_ids):
    """The fixpoint of ``dist = min(dist, segment_min(relax(dist)))``
    from ``dist0``: one superstep a pass, one host read of the "changed"
    flag.  RELAX is evaluated as in JAX's traced loop body (its draw sites
    numbered once)."""
    g = lw.g
    with lw._trace(env):
        dist = dist0.clone()
        base = lw._rng_site
        go = True
        while go:
            lw._rng_site = base
            best = _seg_min(relax_vals(dist), inner_ids, g)
            new = torch.minimum(dist, best)
            go = bool((new < dist).any())
            dist = new
    return dist


def _seg_min(vals, ids, g):
    from .lower import _seg
    return _seg("min", vals, ids, g.n_pad, safe=True)


def _argmin_slot(lw, g, win, inner_ids):
    """Lowest CSR slot per target among the winning slots."""
    cand = torch.where(win, lw._iota_e, g.e_pad)
    return _seg_min(cand, inner_ids, g).clamp(max=g.e_pad - 1)


def try_priority_while(lw, s: A.While, env) -> bool:
    """Attempt the device lowering; False -> caller falls back to the
    host-eager replay."""
    from .lower import (EdgeCtx, NodeCtx, _F, _coerce, _identity, _where)
    from ..runtime.collections import DenseNodeMap
    from ..runtime.lanes import expand_like, take

    if lw.axis is not None:
        return False          # sharded mode rejects maps earlier anyway
    m = _match(lw, s, env)
    if m is None:
        return False
    g = lw.g
    M = env[m.map_name]
    if not isinstance(M, DenseNodeMap):
        return False
    dt = M.val.dtype
    if dt.is_floating_point or dt == torch.bool:
        return False          # int-cost maps only (the reference's too)
    INF_I = _identity("MIN", dt, lw.dev)
    dest = env.get(m.dest_var)
    if dest is None:
        return False

    dist0 = torch.where(M.present, M.val, INF_I)
    src_ids = g.node_idx_src
    dst_ids = g.node_idx
    emask = g.edge_mask()
    zero = torch.zeros((), dtype=dt, device=lw.dev)

    def edge_env_ctx(dist_vec):
        """Edge context + env binding the body's locals generically:
        dist -> per-edge source distance, e -> CSR slot, next -> src."""
        ectx = EdgeCtx(g=g, layout="csr", outer_var=m.next_var,
                       inner_var=m.v_var, outer_ids=src_ids,
                       inner_ids=dst_ids, mask=emask, parent=None)
        env2 = dict(env)
        ds = lw._take(dist_vec, src_ids)
        finite = ds < INF_I
        env2[m.dist_var] = torch.where(finite, ds, zero)
        if m.e_var is not None:
            env2[m.e_var] = ectx.slots()
        return ectx, env2, finite

    def relax_vals(dist_vec):
        ectx, env2, finite = edge_env_ctx(dist_vec)
        val = expand_like(_coerce(lw.eval(m.relax, env2, ectx), dt), emask)
        return torch.where(emask & finite, val, INF_I)

    sdist = _bellman_ford(lw, env, dist0, relax_vals, dst_ids)

    destc = lw._a(dest, torch.int32).clamp(0, g.n_pad - 1)
    d_dest = take(sdist, destc)
    found = d_dest < INF_I
    finite = sdist < INF_I
    nmask = g.node_mask()
    # settled = popped before dest (strictly closer, or everything
    # reachable when dest is not)
    settled = finite & nmask & torch.where(found, sdist < d_dest, True)

    # settled writes (next.Settled = expr) over the settled set
    nctx = NodeCtx(g=g, var=m.next_var, ids=lw._iota_n, mask=settled)
    for w in m.settled_writes:
        lw.exec_stmt(w, env, nctx)

    # per-target writes at the argmin-winning edge from a settled source
    if m.edge_writes:
        ectx, env2, _fin = edge_env_ctx(sdist)
        val = expand_like(_coerce(lw.eval(m.relax, env2, ectx), dt), emask)
        # a relaxation u->v happened iff u was settled while v was not
        # yet (the `!v.Settled` pop-time filter): sdist[u] < sdist[v],
        # or v never settled at all — keeps the root's Parent at NIL
        was_open = (lw._take(sdist, src_ids) < lw._take(sdist, dst_ids)) \
            | ~lw._take(settled, dst_ids)
        active = emask & lw._take(settled, src_ids) & was_open
        cand = torch.where(active, val, INF_I)
        best = _seg_min(cand, dst_ids, g)
        touched = best < INF_I
        win = active & (cand == lw._take(best, dst_ids))
        win_slot = _argmin_slot(lw, g, win, dst_ids)
        wctx = ectx.with_mask(win)
        for w in m.edge_writes:
            loc, wdt = lw.props[w.lhs.prop]
            key = _F + w.lhs.prop
            rv = expand_like(_coerce(lw.eval(w.rhs, env2, wctx), wdt), emask)
            arr = env[key]
            lw._wr(env, key, _where(touched, take(rv, win_slot), arr))

    # exit flags + final map state (settled entries removed; dest and
    # the unsettled frontier remain)
    true = torch.ones((), dtype=torch.bool, device=lw.dev)
    lw._wr(env, m.flag_found,
           _where(found, true, lw._a(env[m.flag_found])))
    lw._wr(env, m.flag_failed,
           _where(found, lw._a(env[m.flag_failed]), true))
    present = finite & nmask & ~settled
    lw._wr(env, m.map_name,
           DenseNodeMap(torch.where(present, sdist, M.val), present))
    return True


# ---------------------------------------------------------------------------
# Bidirectional Dijkstra (apps/src/bidir_dijkstra.gm): the two-map,
# direction-alternating pop-min loop.  Device lowering: one forward +
# one reverse Bellman-Ford fixpoint (each the same label-correcting
# reformulation as ``try_priority_while``), meet at argmin(FCost+RCost).
# The size-balancing direction choice and the ``<= minCost`` pruning are
# traversal-order OPTIMIZATIONS of the sequential machine — dropping
# them changes no shortest distance and no reachable meet; documented
# deviations (PARITY.md): Parent trees are lowest-slot argmin edges over
# the FULL fixpoint (the pruned eager run leaves far-side Parents
# unwritten), pop-order scalars (curMin*) and leftover frontier map
# entries are reconstructed, and `mid` tie-breaks to the lowest node id.
# ---------------------------------------------------------------------------

class _BidirSide:
    map_name: str
    next_var: str
    settled_prop: str
    curmin_var: str
    cost_prop: str
    dist_var: str
    v_var: str
    e_var: Optional[str]
    iter_type: str
    relax: A.Expr
    writes: List[A.Assign]
    other_cost_prop: Optional[str]
    newcost_var: Optional[str]
    meet: Optional[A.ArgMinMaxAssign]


def _match_bidir_side(lw, block) -> Optional[_BidirSide]:
    m = _BidirSide()
    m.map_name = None
    m.next_var = None
    m.settled_prop = None
    m.curmin_var = None
    m.cost_prop = None
    m.dist_var = None
    m.e_var = None
    m.meet = None
    m.other_cost_prop = None
    m.newcost_var = None
    removed = False
    loop = None
    for st in _stmts(block):
        if isinstance(st, A.VarDecl) and len(st.names) == 1 and \
                isinstance(st.init, A.Builtin) and \
                st.init.name.lower() == "getminkey" and m.next_var is None:
            m.next_var = st.names[0]
            m.map_name = st.init.driver
        elif isinstance(st, A.CallStmt) and \
                st.call.name.lower() == "remove" and \
                st.call.driver == m.map_name:
            removed = True
        elif isinstance(st, A.Assign) and isinstance(st.lhs, A.Field) \
                and st.lhs.driver == m.next_var and \
                _is_true_const(st.rhs) and m.settled_prop is None:
            m.settled_prop = st.lhs.prop
        elif isinstance(st, A.Assign) and isinstance(st.lhs, A.Ident) \
                and isinstance(st.rhs, A.Field) and \
                st.rhs.driver == m.next_var and m.curmin_var is None:
            m.curmin_var = st.lhs.name
            m.cost_prop = st.rhs.prop
        elif isinstance(st, A.If) and st.els is None and \
                isinstance(_single(st.then), A.Assign) and \
                isinstance(_single(st.then).lhs, A.Ident) and \
                _is_true_const(_single(st.then).rhs):
            pass                      # early-termination check (dropped)
        elif isinstance(st, A.VarDecl) and len(st.names) == 1 and \
                isinstance(st.init, A.Field) and \
                st.init.driver == m.next_var and \
                st.init.prop == m.cost_prop and m.dist_var is None:
            m.dist_var = st.names[0]
        elif isinstance(st, A.Foreach) and loop is None:
            loop = st
        else:
            return None
    if None in (m.next_var, m.settled_prop, m.cost_prop, m.dist_var) \
            or not removed or loop is None:
        return None
    it = loop.iterator
    if it.source != m.next_var or it.iter_type not in \
            ("NBRS", "OUT_NBRS", "IN_NBRS"):
        return None
    m.iter_type = it.iter_type
    m.v_var = it.var
    f = loop.filter
    if not (isinstance(f, A.UnOp) and f.op == "NOT" and
            isinstance(f.operand, A.Field) and
            f.operand.driver == m.v_var and
            f.operand.prop == m.settled_prop):
        return None
    lb = _stmts(loop.body)
    if lb and isinstance(lb[0], A.VarDecl) and len(lb[0].names) == 1 \
            and isinstance(lb[0].init, A.Builtin) and \
            lb[0].init.name.lower() == "toedge":
        m.e_var = lb[0].names[0]
        lb = lb[1:]
    # prune guard If (dist + w + curMinOther <= minCost): dropped —
    # it only skips never-improving relaxations
    if len(lb) != 1 or not isinstance(lb[0], A.If) or \
            lb[0].els is not None:
        return None
    inner = _stmts(lb[0].then)
    if len(inner) != 1 or not isinstance(inner[0], A.If) or \
            inner[0].els is not None:
        return None
    if3 = inner[0]
    c3 = if3.cond
    if not (isinstance(c3, A.BinOp) and c3.op == ">" and
            isinstance(c3.lhs, A.Field) and c3.lhs.driver == m.v_var and
            c3.lhs.prop == m.cost_prop):
        return None
    m.relax = c3.rhs
    m.writes = []
    body = _stmts(if3.then)
    if not body or not (isinstance(body[0], A.Assign) and
                        isinstance(body[0].lhs, A.Field) and
                        body[0].lhs.driver == m.v_var and
                        body[0].lhs.prop == m.cost_prop and
                        _expr_eq(body[0].rhs, m.relax)):
        return None
    for st in body[1:]:
        if isinstance(st, A.Assign) and isinstance(st.lhs, A.MapAccess) \
                and st.lhs.map_name == m.map_name:
            continue                          # frontier push (implicit)
        if isinstance(st, A.Assign) and isinstance(st.lhs, A.Field) \
                and st.lhs.driver == m.v_var:
            m.writes.append(st)
            continue
        if isinstance(st, A.If) and st.els is None and m.meet is None:
            c = st.cond
            if not (isinstance(c, A.BinOp) and c.op == "!=" and
                    isinstance(c.lhs, A.Field) and
                    c.lhs.driver == m.v_var):
                return None
            m.other_cost_prop = c.lhs.prop
            mb = _stmts(st.then)
            if len(mb) == 2 and isinstance(mb[0], A.VarDecl) and \
                    len(mb[0].names) == 1 and \
                    isinstance(mb[1], A.ArgMinMaxAssign) and \
                    mb[1].op == "MIN":
                m.newcost_var = mb[0].names[0]
                m.meet = mb[1]
                continue
            return None
        return None
    if m.meet is None:
        return None
    return m


def _match_bidir(lw, s: A.While, env):
    if s.do_while:
        return None
    body = _stmts(s.body)
    if len(body) != 1 or not isinstance(body[0], A.If):
        return None
    if1 = body[0]
    if if1.els is None:
        return None
    els = _single(if1.els)
    if not isinstance(els, A.If) or els.els is not None:
        return None
    fwd = _match_bidir_side(lw, if1.then)
    rev = _match_bidir_side(lw, els.then)
    if fwd is None or rev is None:
        return None
    if fwd.iter_type == "IN_NBRS":
        fwd, rev = rev, fwd
    if fwd.iter_type not in ("NBRS", "OUT_NBRS") or \
            rev.iter_type != "IN_NBRS":
        return None
    # the two sides must meet on each other's cost prop and share the
    # same <minCost; mid> argmin target
    if fwd.other_cost_prop != rev.cost_prop or \
            rev.other_cost_prop != fwd.cost_prop:
        return None
    for side in (fwd, rev):
        t = side.meet
        if not (isinstance(t.lhs, A.Ident) and len(t.lhs_extra) == 1 and
                isinstance(t.lhs_extra[0], A.Ident) and
                isinstance(t.rhs, A.Ident) and
                t.rhs.name == side.newcost_var and
                len(t.rhs_extra) == 1 and
                isinstance(t.rhs_extra[0], A.Ident) and
                t.rhs_extra[0].name == side.v_var):
            return None
    if not (fwd.meet.lhs.name == rev.meet.lhs.name and
            fwd.meet.lhs_extra[0].name == rev.meet.lhs_extra[0].name):
        return None
    # While cond may only read the terminate flag + the two map sizes
    names = set()

    def scan(e):
        if isinstance(e, A.Ident):
            names.add(e.name)
        if isinstance(e, A.Builtin):
            if e.name.lower() != "size" or e.driver not in \
                    (fwd.map_name, rev.map_name):
                names.add("<bad>")
            return
        for attr in ("lhs", "rhs", "operand"):
            sub = getattr(e, attr, None)
            if isinstance(sub, A.Expr):
                scan(sub)
    scan(s.cond)
    term = [n for n in names if n != "<bad>"]
    if "<bad>" in names or len(term) != 1:
        return None
    return fwd, rev, term[0]


def try_bidir_while(lw, s: A.While, env) -> bool:
    """Device lowering of the bidir_dijkstra two-map loop; False ->
    caller falls back to the host-eager replay."""
    from .lower import EdgeCtx, _F, _coerce, _identity, _where
    from ..runtime.collections import DenseNodeMap

    if lw.axis is not None:
        return False
    r = _match_bidir(lw, s, env)
    if r is None:
        return False
    fwd, rev, term_flag = r
    g = lw.g
    for side in (fwd, rev):
        if not isinstance(env.get(side.map_name), DenseNodeMap):
            return False
    dt = lw._a(env[_F + fwd.cost_prop]).dtype
    if dt.is_floating_point or dt == torch.bool:
        return False
    INF_I = _identity("MIN", dt, lw.dev)
    emask = g.edge_mask()
    nmask = g.node_mask()
    zero = torch.zeros((), dtype=dt, device=lw.dev)

    def run_side(side, outer_ids, inner_ids, layout):
        dist0 = lw._a(env[_F + side.cost_prop])[: g.n_pad]

        def ectx_env(dist_vec):
            ectx = EdgeCtx(g=g, layout=layout, outer_var=side.next_var,
                           inner_var=side.v_var, outer_ids=outer_ids,
                           inner_ids=inner_ids, mask=emask, parent=None)
            env2 = dict(env)
            do = dist_vec.index_select(0, outer_ids)
            finite = do < INF_I
            env2[side.dist_var] = torch.where(finite, do, zero)
            if side.e_var is not None:
                env2[side.e_var] = ectx.slots()
            return ectx, env2, finite

        def relax_vals(dist_vec):
            ectx, env2, finite = ectx_env(dist_vec)
            val = _coerce(lw.eval(side.relax, env2, ectx), dt).expand(
                emask.shape)
            return torch.where(emask & finite, val, INF_I)

        sdist = _bellman_ford(lw, env, dist0, relax_vals, inner_ids)

        # per-target writes at the lowest-slot argmin edge achieving the
        # final distance (Parent/ParentEdge trees)
        if side.writes:
            ectx, env2, _fin = ectx_env(sdist)
            val = _coerce(lw.eval(side.relax, env2, ectx), dt).expand(
                emask.shape)
            active = emask & (sdist.index_select(0, outer_ids) < INF_I)
            cand = torch.where(active, val, INF_I)
            best = _seg_min(cand, inner_ids, g)
            finite_t = sdist < INF_I
            touched = (best <= sdist) & finite_t & (best < INF_I)
            win = active & (cand == best.index_select(0, inner_ids)) & \
                touched.index_select(0, inner_ids)
            win_slot = _argmin_slot(lw, g, win, inner_ids)
            wctx = ectx.with_mask(win)
            for w in side.writes:
                loc, wdt = lw.props[w.lhs.prop]
                key = _F + w.lhs.prop
                rv = _coerce(lw.eval(w.rhs, env2, wctx), wdt).expand(
                    emask.shape)
                arr = env[key]
                lw._wr(env, key,
                       _where(touched, rv[win_slot.long()], arr))
        return sdist

    sdist_f = run_side(fwd, g.node_idx_src, g.node_idx, "csr")
    sdist_r = run_side(rev, g.r_node_idx_dst, g.r_node_idx, "csc")

    fin_f = (sdist_f < INF_I) & nmask
    fin_r = (sdist_r < INF_I) & nmask
    both = fin_f & fin_r
    tot = torch.where(both, sdist_f + sdist_r, INF_I)
    min_cost = tot.min()
    found = min_cost < INF_I
    mid = torch.argmin(tot).to(torch.int32)      # lowest-id tie-break

    # commit state: cost/settled fields are the fixpoint (superset of
    # the pruned eager traversal — temporaries in the app)
    for side, sdist, fin in ((fwd, sdist_f, fin_f),
                             (rev, sdist_r, fin_r)):
        key = _F + side.cost_prop
        lw._wr(env, key, sdist.to(env[key].dtype))
        skey = _F + side.settled_prop
        lw._wr(env, skey, fin.to(env[skey].dtype))
        if side.curmin_var in env:
            lw._wr(env, side.curmin_var,
                   torch.where(fin, sdist, zero).max())
        M = env[side.map_name]
        lw._wr(env, side.map_name,
               DenseNodeMap(M.val, torch.zeros_like(M.present)))
    mc_name = fwd.meet.lhs.name
    mid_name = fwd.meet.lhs_extra[0].name
    true = torch.ones((), dtype=torch.bool, device=lw.dev)
    lw._wr(env, mc_name, _where(found, min_cost, lw._a(env[mc_name], dt)))
    lw._wr(env, mid_name,
           _where(found, mid, lw._a(env[mid_name], torch.int32)))
    lw._wr(env, term_flag,
           _where(found, true, lw._a(env[term_flag], torch.bool)))
    return True
