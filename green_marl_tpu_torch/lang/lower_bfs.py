"""Lowering of InBFS/InDFS statements (gm_grammer.y:266-304).

Counterpart of ``green_marl_tpu/lang/lower_bfs.py``.  The reference
compiles a BFS statement into a subclass of the direction-optimizing
``gm_bfs_template`` with ``visit_fw``/``visit_rv`` virtuals
(``gm_cpp_gen_bfs.cc:7-275``).  Here instead:

1. the full level array comes from level-synchronous frontier expansion
   (the transposed BFS of ``InReverse``-style traversals counts
   out-neighbours in the frontier through ``scan_reduce``, i.e. the
   prefix-sum kernel);
2. the forward body is replayed once per level in a node context masked to
   that level's frontier (``UpNbrs``/``DownNbrs`` become level-filtered
   neighbor contexts);
3. the reverse body is replayed from the deepest level back to the root.

The level count is data-dependent: it is read on the host once, and each
level's expansion reads one flag.  Under a mesh axis (``lang.distribute``)
the graph is one shard's edge slab: each level's reach is reduced over the
slab's endpoints and combined across shards, the flag every shard reads
comes out of that combine, and the replay is :func:`_replay_traced`.

In a batched run (``CompiledProc.batch``) a root or navigator that depends
on the lanes gives every lane its own level array and depth: the expansion
runs while any lane finds new nodes, a lane that found none stops counting,
and the replay is :func:`_replay_traced`, as the JAX package's is where the
depth is a tracer.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gm_ast as A
from ..runtime import lanes as LN


def _levels(lw, root, transpose: bool, allowed=None):
    """Level array by iterative masked expansion; returns (level, depth).

    ``allowed`` is the navigator mask: nodes failing it are neither
    visited nor expanded (reference ``check_navigator``).  Navigator state
    mutated *inside* the BFS body is not re-evaluated mid-traversal.  With
    lane values the level array is [B, N_pad] and the depth a [B, 1] lane
    value: the passes a lane ran."""
    from ..ops import scan_reduce
    from ..ops.segment import segment_max
    from .lower import _seg
    g = lw.g
    INF = torch.iinfo(torch.int32).max
    ids = lw._iota_n
    is_root = ids == root
    level = torch.where(is_root, 0, INF).to(torch.int32)
    mask = g.node_mask()
    if allowed is not None:
        mask = mask & allowed
        level = torch.where(mask | is_root, level, INF).to(torch.int32)
    d = 0
    go = True
    lanes = LN.is_lanes(level)
    if lanes:
        # the lanes still expanding, and the passes each ran
        run = LN.spread(torch.ones((), dtype=torch.bool, device=ids.device),
                        level.shape[0])
        depth = torch.zeros_like(run, dtype=torch.int32)
    while go:
        fr = (level == d) & mask
        if transpose and lw.axis is None:
            # BFS over G^: v joins when some OUT-neighbor w is in the
            # frontier — Exist(w: v.OutNbrs){fr[w]}
            reach = scan_reduce.out_nbr_count_true(g, fr) > 0
            if lanes:
                reach = LN.mark(reach)
        elif lanes:
            vals = lw._take(fr, g.node_idx_src).to(torch.int8)
            reach = _seg("max", vals, g.node_idx, g.n_pad) > 0
        elif transpose:
            # sharded slabs: g.begin is global, the slot arrays are the
            # shard's, so reduce by the slab's source endpoints
            vals = fr.index_select(0, g.node_idx).to(torch.int8)
            reach = segment_max(vals, g.node_idx_src, g.n_pad) > 0
        else:
            vals = fr.index_select(0, g.node_idx_src).to(torch.int8)
            reach = segment_max(vals, g.node_idx, g.n_pad) > 0
        if lw.axis is not None:
            # combine the shards' partial reach (the per-superstep message
            # combine of gm_gps_opt_transform_bfs.cc's level-sync form)
            reach = lw._pcomb(reach.to(torch.int8), "max") > 0
        newly = reach & (level == INF) & mask
        if lanes:
            newly = newly & run
        level = torch.where(newly, d + 1, level).to(torch.int32)
        d += 1
        if lanes:
            depth = depth + run.to(torch.int32)
            run = run & LN.reduce("any", newly)
            go = bool(LN.plain(run).any())
            continue
        go = bool(newly.any())
        if lw.axis is not None:
            go = lw.axis.agree(go)
    return level, (depth if lanes else d)


def exec_bfs(lw, s: A.BFS, env, ctx):
    from .lower import LowerError, NodeCtx

    if ctx is not None:
        raise LowerError("InBFS nested inside a parallel loop")
    if not s.is_bfs:
        return exec_dfs(lw, s, env, ctx)
    if lw._concrete is not None and lw.axis is None:
        raise LowerError("InBFS inside a traced loop is not lowerable")
    g = lw.g
    root = lw._ident(s.root, env, None)
    allowed = None
    if s.navigator is not None:
        nav_ctx = NodeCtx(g=g, var=s.var, ids=lw._iota_n,
                          mask=g.node_mask())
        allowed = LN.expand_like(lw._a(lw.eval(s.navigator, env, nav_ctx)),
                                 lw._iota_n).to(torch.bool)
    level, depth = _levels(lw, root, s.transpose, allowed)
    env["__bfs_level$" + s.var] = level
    if lw.axis is not None or LN.is_lanes(depth):
        _replay_traced(lw, s, env, level, depth)
        return
    base_mask = g.node_mask()

    def level_ctx(d):
        return NodeCtx(g=g, var=s.var, ids=lw._iota_n,
                       mask=base_mask & (level == d))

    def replay(body, d, nctx):
        lw._bfs_ctx = (s.var, level, d)
        try:
            lw._defer_stack.append((s.var, []))
            try:
                lw.exec_stmt(body, env, nctx)
            finally:
                _, pend = lw._defer_stack.pop()
            lw._apply_pending(env, pend)
        finally:
            lw._bfs_ctx = None

    # forward pass: shallow -> deep
    for d in range(depth + 1):
        nctx = level_ctx(d)
        if s.navigator is not None:
            nctx = nctx.with_mask(nctx.mask &
                                  lw.eval(s.navigator, env, nctx))
        if s.filter_fw is not None:
            nctx = nctx.with_mask(nctx.mask &
                                  lw.eval(s.filter_fw, env, nctx))
        replay(s.body_fw, d, nctx)
    # reverse pass: deep -> shallow (InReverse body)
    if s.body_bw is not None:
        for d in range(depth, -1, -1):
            nctx = level_ctx(d)
            if s.filter_bw is not None:
                nctx = nctx.with_mask(nctx.mask &
                                      lw.eval(s.filter_bw, env, nctx))
            replay(s.body_bw, d, nctx)


def _replay_traced(lw, s, env, level, depth):
    """Forward and reverse level replay as JAX's traced ``fori_loop`` s run
    them: the body's written environment entries are the carry and keep
    their dtypes, every carried value counts as traced (an ``If`` on it
    runs both branches), and each pass reuses the draw sites of the first.
    Sharded runs reach it (they refuse draws), and batched runs whose
    depth is a lane value: JAX runs a ``fori_loop`` with a lane bound as a
    batched ``while_loop``, so the passes go on to the deepest lane's
    depth, every carry entry is per lane, and a lane past its own depth
    keeps its state."""
    from .lower import (LowerError, NodeCtx, _DONE, _RET, _RNG,
                        declared_keys, uses_rng, written_keys)
    g = lw.g
    base_mask = g.node_mask()
    lanes = LN.is_lanes(depth)
    passes = int(LN.plain(depth).max()) + 1 if lanes else depth + 1

    def run_phase(body, filt, reverse):
        if body is None:
            return
        wkeys = written_keys(body)
        if uses_rng(body):
            wkeys.add(_RNG)
            env.setdefault(_RNG, lw._c(0, torch.int64))
        carry_keys = sorted((wkeys - declared_keys(body)) - {_RET, _DONE})
        for k in carry_keys:
            if k not in env:
                raise LowerError(f"BFS body writes undeclared {k}")
        dtypes = [env[k].dtype if isinstance(env[k], torch.Tensor)
                  else None for k in carry_keys]
        if lanes:
            env.update(zip(carry_keys, lw._spread(
                tuple(env[k] for k in carry_keys), depth.shape[0])))
        base = end = lw._rng_site
        with lw._trace(env, set(carry_keys)):
            for i in range(passes):
                lw._rng_site = base
                d = depth - i if reverse else i
                e2 = dict(env)
                m = base_mask & (level == d)
                nctx = NodeCtx(g=g, var=s.var, ids=lw._iota_n, mask=m)
                if s.navigator is not None and not reverse:
                    nctx = nctx.with_mask(nctx.mask & LN.expand_like(
                        lw._a(lw.eval(s.navigator, e2, nctx)), m))
                if filt is not None:
                    nctx = nctx.with_mask(nctx.mask & LN.expand_like(
                        lw._a(lw.eval(filt, e2, nctx)), m))
                lw._bfs_ctx = (s.var, level, d)
                try:
                    lw._defer_stack.append((s.var, []))
                    try:
                        lw.exec_stmt(body, e2, nctx)
                    finally:
                        _, pend = lw._defer_stack.pop()
                    lw._apply_pending(e2, pend)
                finally:
                    lw._bfs_ctx = None
                end = lw._rng_site
                new = tuple(lw._a(e2[k]).to(dt) if dt is not None else e2[k]
                            for k, dt in zip(carry_keys, dtypes))
                if lanes:
                    new = lw._keep(i <= depth, new,
                                   tuple(env[k] for k in carry_keys))
                env.update(zip(carry_keys, new))
        lw._rng_site = end

    run_phase(s.body_fw, s.filter_fw, False)
    run_phase(s.body_bw, s.filter_bw, True)


def exec_dfs(lw, s: A.BFS, env, ctx):
    """InDFS: host-sequential iterative DFS with pre/post visit bodies.

    The reference DFS template is sequential by design
    (``gm_dfs_template.h``), so an eager host loop over the concrete CSR is
    the faithful lowering.  The navigator is checked at entry time with the
    *current* environment."""
    from .lower import LowerError

    if ctx is not None:
        raise LowerError("InDFS nested inside a parallel loop")
    g = lw.g

    def host(e, what):
        return lw._host_bool(lw.eval(e, env, None),
                             f"traced {what} of a sequential InDFS")

    root = lw._ident(s.root, env, None)
    if lw._traced(root):
        raise LowerError("InDFS from a traced root")
    root = int(root)
    if s.transpose:
        begin = g.r_begin.cpu().numpy()
        ni = g.r_node_idx.cpu().numpy()
    else:
        begin = g.begin.cpu().numpy()
        ni = g.node_idx.cpu().numpy()
    visited = np.zeros(g.num_nodes, bool)
    stack = [(root, False)]
    while stack:
        v, post = stack.pop()
        env[s.var] = lw._c(v, torch.int32)
        if post:
            if s.filter_bw is not None and not host(s.filter_bw, "filter"):
                continue
            if s.body_bw is not None:
                lw.exec_stmt(s.body_bw, env, None)
            continue
        if visited[v]:
            continue
        if s.navigator is not None and not host(s.navigator, "navigator"):
            continue
        visited[v] = True
        stack.append((v, True))          # post-visit after children
        run_pre = True
        if s.filter_fw is not None:
            run_pre = host(s.filter_fw, "filter")
        if run_pre and s.body_fw is not None:
            lw.exec_stmt(s.body_fw, env, None)
        for w in ni[begin[v]:begin[v + 1]][::-1]:
            if not visited[w]:
                stack.append((int(w), False))
    env.pop(s.var, None)
