"""Per-algorithm CLI drivers (the reference's generated ``*_main.cc``).

Counterpart of the single-device paths of ``green_marl_tpu/cli/apps.py``
for pagerank (``pagerank_main.cc``: ``rank[%d] = %0.9lf``, defaults
e=0.001 d=0.85 max=100), hop_dist (``dist[%d] = %d``), sssp (edge
lengths from the reference's xorshift RNG when the file carries none),
multi_bfs (the batched bit-plane BFS; one ``batched bfs:`` line),
triangle_counting (``number of triangles: %d``), conduct and conduct_main
(``sum C = %lf`` over the four cuts of the xorshift membership), weak_cc,
avg_teen_cnt (``avg = %0.9f``; the main sets age=10, K=5), v_cover,
communities (the table of community sizes), potential_friends, kosaraju and
tarjan_scc (``num_membership = %d``), bc, bc_random and bc_adj (``BC[0..3]``),
sssp_path and sssp_path_adj (the path), sssp_dijkstra and bidir_dijkstra
(the ``weight`` line), random_node_sampling, random_degree_node_sampling and
random_walk_sampling_with_random_jump (the ``sampled`` set, drawn from JAX's
threefry stream with ``PRNGKey(0)``), random_bipartite_matching
(``matched = %d``), and adamicAdar and b2, which compile the reference's
``.gm`` sources.  bc_adj and sssp_path_adj read ADJ input by default.
With ``-GMProfile``, pagerank and hop_dist time each superstep.  A path to
a ``.gm`` file in place of an app compiles it and makes its declared
schema the command line (``make_custom``).

``-GMNumChips=k`` (k > 1) runs pagerank, hop_dist, sssp, conduct,
avg_teen_cnt and ``.gm`` files on k shards, as ``-GMPlacement`` says:
``distribute`` (the default) runs the compiled ``.gm`` program
vertex-sharded (``lang.lower_vertex``), ``engine`` the hand-written
vertex-sharded supersteps (``parallel.vertex_sharded``; pagerank, hop_dist,
sssp), ``replicate`` the compiled program edge-sharded with node state
replicated (``lang.distribute``).  The named apps compile the reference's
sources from ``GM_REFERENCE_APPS`` for the compiled placements.
``-GMPlace=arr:policy`` and ``-GMPlacementFile`` pin arrays of the
distribute placement.  The placement report goes to stderr.
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..graph import binary_io as bio
from .usermain import GM_EDGEPROP, GM_NODEPROP, RunContext, UserMain


def _root(ctx: RunContext) -> int:
    root = ctx.scalars.get("root")
    return int(root) if root is not None else 0


# Directory of the reference's ``apps/src/*.gm`` sources, which
# ``adamicAdar`` and ``b2`` compile and the literal routes of ``tarjan_scc``
# and ``bidir_dijkstra`` take where present (the JAX CLI reads the same
# files from its reference checkout).  Empty: no reference sources.
REFERENCE_APPS = os.environ.get("GM_REFERENCE_APPS", "")


def _reference_gm(app: str) -> Optional[str]:
    """Path of the reference's ``<app>.gm`` if it exists, else None."""
    path = os.path.join(REFERENCE_APPS, f"{app}.gm")
    return path if REFERENCE_APPS and os.path.exists(path) else None


def _compile_reference(app: str):
    """The reference's ``<app>.gm``, compiled; a missing source raises
    FileNotFoundError with its path, as the JAX CLI's ``compile_file``
    does."""
    from ..lang.lower import compile_file
    path = os.path.join(REFERENCE_APPS, f"{app}.gm")
    if not REFERENCE_APPS:
        raise FileNotFoundError(
            f"{app} compiles the reference's {app}.gm: set "
            "GM_REFERENCE_APPS to the reference's apps/src directory")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return compile_file(path)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _profile(ctx: RunContext) -> bool:
    """``-GMProfile``: print the graph's array report on stderr; the app
    then takes its per-superstep timed path."""
    if not ctx.options.get_option("GMProfile"):
        return False
    from ..utils.timing import graph_placement_report
    print(graph_placement_report(ctx.graph), file=sys.stderr)
    return True


def _num_chips(ctx: RunContext) -> int:
    """-GMNumChips: the shard count of the sharded paths (the
    -GMNumThreads analog; reference common_main.h:29-230)."""
    k = ctx.options.get_option("GMNumChips") if ctx.options else None
    return int(k) if k else 1


def _placement(ctx: RunContext) -> str:
    p = (ctx.options.get_option("GMPlacement")
         if ctx.options else None) or "distribute"
    return p.lower()


def _placement_overrides(ctx: RunContext) -> Dict[str, str]:
    """Per-array placement overrides from -GMPlace / -GMPlacementFile
    (Shoal's local_array_settings.lua, run.sh:218-246)."""
    ov: Dict[str, str] = {}
    o = ctx.options
    if o is None:
        return ov
    f = o.get_option("GMPlacementFile")
    if f:
        import json
        try:
            with open(f) as fh:
                loaded = json.load(fh)
        except (OSError, ValueError) as e:
            raise SystemExit(f"-GMPlacementFile={f}: {e}")
        if not isinstance(loaded, dict):
            raise SystemExit(
                f"-GMPlacementFile={f}: expected a JSON object "
                "{\"arr\": \"policy\"}")
        ov.update({str(k): str(v) for k, v in loaded.items()})
    p = o.get_option("GMPlace")
    if p:
        for item in p.split(","):
            if ":" not in item:
                raise SystemExit(
                    f"-GMPlace expects arr:policy, got '{item}'")
            k, v = item.split(":", 1)
            ov[k.strip()] = v.strip()
    return ov


def _resolve_cp(gm_app):
    """An app name (compiled from the reference's source) or an already
    compiled ``CompiledProc`` (a ``.gm`` file's main)."""
    return _compile_reference(gm_app) if isinstance(gm_app, str) else gm_app


def _no_overrides(ctx: RunContext, policy: str) -> None:
    """Per-array overrides apply only under the distribute policy: exit
    instead of silently ignoring the flag."""
    ov = _placement_overrides(ctx)
    if ov:
        raise SystemExit(
            f"-GMPlace/-GMPlacementFile overrides ({', '.join(ov)}) "
            f"apply only with -GMPlacement=distribute, not "
            f"'{policy}'")


def _mesh(ctx: RunContext, k: int):
    """A 1-D mesh of k shards on -GMDevice's kind of device; exits when
    there are fewer devices (nothing runs on fewer shards)."""
    from ..parallel import comm
    devs = comm.devices(ctx.graph.device.type)
    if len(devs) < k:
        raise SystemExit(
            f"-GMNumChips={k}: only {len(devs)} devices "
            f"(set {comm.VIRTUAL_ENV}=<shards per device> for a virtual "
            "mesh)")
    return comm.Mesh(devs[:k], ("v",))


def _run_replicated(ctx: RunContext, gm_app, k: int, **kw):
    """-GMPlacement=replicate: the compiled program with the edge arrays
    sharded over k shards and node state replicated + psum (the round-1
    scheme, Shoal's baseline config)."""
    from ..lang import distribute
    _no_overrides(ctx, "replicate")
    mesh = _mesh(ctx, k)
    cp = _resolve_cp(gm_app)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return distribute.run_sharded(cp, ctx.graph, mesh=mesh, **kw)


def _vsharded(ctx: RunContext, k: int):
    """-GMPlacement=engine: the hand-written vertex-sharded engine's
    placed partition, its report on stderr."""
    from ..parallel import vertex_sharded as V
    _no_overrides(ctx, "engine")
    mesh = _mesh(ctx, k)
    vsg = V.place(V.build_vertex_sharded(ctx.graph, k), mesh)
    print(V.placement_report(vsg, mesh), file=sys.stderr)
    return vsg, mesh


def _run_compiled_vsharded(ctx: RunContext, gm_app, k: int, **kw):
    """-GMPlacement=distribute (default): the COMPILED program executed
    vertex-sharded (owned [N/S] node slabs + a cut-sized ghost exchange
    inside the lowerer, ``lang.lower_vertex``), the GPS backend's
    capability."""
    from ..lang import lower_vertex as LV
    from ..lang.lower import LowerError
    mesh = _mesh(ctx, k)
    sched = LV.place_schedule(LV.build_schedule(ctx.graph, k), mesh)
    ov = _placement_overrides(ctx)
    print(LV.placement_report(sched, placements=ov), file=sys.stderr)
    cp = _resolve_cp(gm_app)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return LV.run_vertex_sharded(cp, ctx.graph, mesh=mesh,
                                         sched=sched, placements=ov, **kw)
        except LowerError as e:
            if ov:
                raise SystemExit(f"placement override error: {e}")
            raise


def make_pagerank() -> UserMain:
    m = UserMain("pagerank", "PageRank power iteration (pagerank.gm)")
    m.declare_scalar("max_iter", bio.GMTYPE_INT, True, False, default=100)
    m.declare_scalar("e", bio.GMTYPE_DOUBLE, True, False, default=0.001)
    m.declare_scalar("d", bio.GMTYPE_DOUBLE, True, False, default=0.85)
    m.declare_property("rank", bio.GMTYPE_DOUBLE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        k = _num_chips(ctx)
        e, d = float(ctx.scalars["e"]), float(ctx.scalars["d"])
        max_iter = int(ctx.scalars["max_iter"])
        if k > 1 and _placement(ctx) == "replicate":
            out = _run_replicated(ctx, "pagerank", k, e=e, d=d, max=max_iter)
            return {"rank": _host(out["pg_rank"])}
        if k > 1 and _placement(ctx) == "engine":
            from ..parallel.vertex_sharded import pagerank_vsharded
            vsg, mesh = _vsharded(ctx, k)
            rank, _, _ = pagerank_vsharded(vsg, mesh, e=e, d=d,
                                           max_iter=max_iter)
            return {"rank": _host(rank)}
        if k > 1:
            out = _run_compiled_vsharded(ctx, "pagerank", k, e=e, d=d,
                                         max=max_iter)
            return {"rank": _host(out["pg_rank"])}
        from ..models import pagerank as pr
        fn = pr.pagerank
        if _profile(ctx):
            fn = pr.pagerank_profiled
        res = fn(ctx.graph, e=float(ctx.scalars["e"]),
                 d=float(ctx.scalars["d"]),
                 max_iter=int(ctx.scalars["max_iter"]))
        return {"rank": res.rank.cpu().numpy()}

    m.set_run(run)
    return m


def make_hop_dist() -> UserMain:
    m = UserMain("hop_dist", "Level-synchronous BFS distances (hop_dist.gm)")
    m.declare_scalar("root", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_property("dist", bio.GMTYPE_INT, False, True, GM_NODEPROP,
                       dump_count=10)  # hop_dist_main.cc prints dist[0..9]

    def run(ctx: RunContext) -> Dict:
        k = _num_chips(ctx)
        if k > 1 and _placement(ctx) == "replicate":
            out = _run_replicated(ctx, "hop_dist", k, root=_root(ctx))
            return {"dist": _host(out["dist"])}
        if k > 1 and _placement(ctx) == "engine":
            from ..parallel.vertex_sharded import hop_dist_vsharded
            vsg, mesh = _vsharded(ctx, k)
            dist, _ = hop_dist_vsharded(vsg, mesh, _root(ctx))
            return {"dist": _host(dist)}
        if k > 1:
            out = _run_compiled_vsharded(ctx, "hop_dist", k,
                                         root=_root(ctx))
            return {"dist": _host(out["dist"])}
        if _profile(ctx):
            from ..models.relax import min_relax_profiled
            res = min_relax_profiled(ctx.graph, _root(ctx))
        else:
            from ..models.hop_dist import hop_dist
            res = hop_dist(ctx.graph, _root(ctx))
        return {"dist": res.dist.cpu().numpy()}

    m.set_run(run)
    return m


def _device_weights(ctx: RunContext, name: str) -> torch.Tensor:
    """[E_pad] int32 edge weights ``name`` on the graph's device.

    Without the property in the file, the reference mains draw lengths
    from their xorshift RNG over CSR slots (sssp_main.cc:31-33).  Host
    lengths and device weights stay on ``ctx``, so that -GMMeasureTime's
    warm-up run pays for drawing and uploading them, as the reference's
    prepare() does outside its timed run."""
    if name not in ctx.device_props:
        g = ctx.graph
        if name not in ctx.edge_props:
            from ..utils.gm_rand import sssp_edge_lengths
            ctx.edge_props[name] = sssp_edge_lengths(g.num_edges)
        w = np.zeros(g.e_pad, np.int32)
        w[: g.num_edges] = ctx.edge_props[name]
        ctx.device_props[name] = torch.from_numpy(w).to(g.device)
    return ctx.device_props[name]


def make_sssp() -> UserMain:
    m = UserMain("sssp", "Bellman-Ford SSSP (sssp.gm)")
    m.declare_scalar("root", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)
    m.declare_property("dist", bio.GMTYPE_INT, False, True, GM_NODEPROP,
                       dump_count=10)

    def run(ctx: RunContext) -> Dict:
        w = _device_weights(ctx, "len")
        k = _num_chips(ctx)
        if k > 1 and _placement(ctx) == "engine":
            from ..parallel import comm, vertex_sharded as V
            vsg, mesh = _vsharded(ctx, k)
            w_slab = comm.place_rows(V.shard_edge_prop(vsg, ctx.graph, w),
                                     mesh)
            dist, _ = V.sssp_vsharded(vsg, mesh, w_slab, _root(ctx))
            return {"dist": _host(dist)}
        if k > 1 and _placement(ctx) == "replicate":
            out = _run_replicated(ctx, "sssp", k, len=w, root=_root(ctx))
            return {"dist": _host(out["dist"])}
        if k > 1:
            out = _run_compiled_vsharded(ctx, "sssp", k, len=w,
                                         root=_root(ctx))
            return {"dist": _host(out["dist"])}
        from ..models.sssp import sssp
        res = sssp(ctx.graph, _root(ctx), w)
        return {"dist": res.dist.cpu().numpy()}

    m.set_run(run)
    return m


def make_multi_bfs() -> UserMain:
    m = UserMain("multi_bfs", "Batched multi-source BFS on the "
                 "bit-packed binned engine (the capability the "
                 "reference lacks; SURVEY.md §2.10)")
    m.declare_scalar("num_roots", bio.GMTYPE_INT, True, False, default=1024)
    m.declare_scalar("plane_bits", bio.GMTYPE_INT, True, False, default=32)

    def run(ctx: RunContext) -> Dict:
        import time

        from ..models import batched
        g = ctx.graph
        B = int(ctx.scalars["num_roots"])
        pb = int(ctx.scalars["plane_bits"])
        if pb not in (8, 16, 32):
            raise SystemExit("plane_bits must be 8, 16 or 32")
        if B > 128 * pb:
            raise SystemExit(f"num_roots <= {128 * pb} at "
                             f"plane_bits={pb}")
        bp, deg_rows, chunk = batched.bits_schedule(g, B, pb)
        # the JAX CLI's numpy call on the same int32 degrees: equal ties
        order = np.argsort(g.out_degree().cpu().numpy()[: g.num_nodes])
        roots = order[::-1][:B].astype(np.int32)
        if g.device.type == "cuda":
            torch.cuda.synchronize(g.device)
        t0 = time.time()
        res = batched.multi_source_bfs_bits(bp, roots, deg_rows,
                                            plane_bits=pb, slot_chunk=chunk)
        trav = res.traversed.cpu().numpy().astype(np.int64)
        dt = time.time() - t0
        total = int(trav.sum())
        print(f"batched bfs: B={B} levels={int(res.levels_run)} "
              f"traversed={total} "
              f"aggregate={total / dt / 1e9:.3f} GTEPS "
              "(incl. compile on first run)")
        return {}

    m.set_run(run)
    return m


def make_triangle_counting() -> UserMain:
    m = UserMain("triangle_counting",
                 "Triangle counting, undirected (triangle_counting.gm)")
    m.declare_scalar("return", bio.GMTYPE_LONG, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.triangle import triangle_count_literal
        t = triangle_count_literal(ctx.graph)
        print(f"number of triangles: {t}")
        return {"return": t}

    m.set_run(run)
    return m


def _device_member(ctx: RunContext, name: str, values) -> torch.Tensor:
    """[N_pad] int32 membership on the graph's device, kept on ``ctx``."""
    if name not in ctx.device_props:
        g = ctx.graph
        member = np.zeros(g.n_pad, np.int32)
        if values is not None:
            member[: g.num_nodes] = values
        ctx.device_props[name] = torch.from_numpy(member).to(g.device)
    return ctx.device_props[name]


def make_conduct() -> UserMain:
    m = UserMain("conduct", "Conductance of a cut (conduct.gm)")
    m.declare_scalar("num", bio.GMTYPE_INT, True, False, default=1)
    m.declare_property("member", bio.GMTYPE_INT, True, False, GM_NODEPROP)
    m.declare_scalar("return", bio.GMTYPE_FLOAT, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.conductance import conductance
        member = _device_member(ctx, "member", ctx.node_props.get("member"))
        k = _num_chips(ctx)
        if k > 1:
            # conduct.gm is a pure reduction program: the compiled
            # vertex-sharded path covers it
            out = _run_compiled_vsharded(ctx, "conduct", k, member=member,
                                         num=int(ctx.scalars["num"]))
            return {"return": float(out["_return"])}
        return {"return": float(conductance(ctx.graph, member,
                                            int(ctx.scalars["num"])))}

    m.set_run(run)
    return m


def make_cc() -> UserMain:
    m = UserMain("weak_cc", "Weakly-connected components")
    m.declare_property("comp", bio.GMTYPE_NODE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.cc import weak_cc
        return {"comp": weak_cc(ctx.graph).comp.cpu().numpy()}

    m.set_run(run)
    return m


def make_conduct_main() -> UserMain:
    """conduct_main.cc: xorshift 10/20/30/40% membership, the sum of the
    conductances of the 4 cuts, ``sum C = %lf``."""
    m = UserMain("conduct_main", "Sum of conductances over 4 random "
                 "cuts (conduct_main.cc)")
    m.declare_scalar("return", bio.GMTYPE_DOUBLE, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.conductance import conductance
        if "__member" not in ctx.node_props:
            from ..utils.gm_rand import conduct_membership
            ctx.node_props["__member"] = conduct_membership(
                ctx.graph.num_nodes)
        member = _device_member(ctx, "__member", ctx.node_props["__member"])
        c = sum(float(conductance(ctx.graph, member, i)) for i in range(4))
        print(f"sum C = {c:f}")
        return {"return": c}

    m.set_run(run)
    return m


def make_avg_teen_cnt() -> UserMain:
    m = UserMain("avg_teen_cnt", "Average teen count (avg_teen_cnt.gm; "
                 "main sets age=10, K=5)")
    m.declare_scalar("K", bio.GMTYPE_INT, True, False, default=5)
    m.declare_scalar("return", bio.GMTYPE_FLOAT, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.analytics import avg_teen_cnt
        g = ctx.graph
        age = g.node_prop(10, torch.int32)
        k = _num_chips(ctx)
        if k > 1:
            out = _run_compiled_vsharded(ctx, "avg_teen_cnt", k,
                                         K=int(ctx.scalars["K"]), age=age)
            avg = float(out["_return"])
        else:
            avg, _ = avg_teen_cnt(g, age, int(ctx.scalars["K"]))
        print(f"avg = {float(avg):0.9f}")
        return {"return": float(avg)}

    m.set_run(run)
    return m


def make_v_cover() -> UserMain:
    m = UserMain("v_cover", "Vertex cover (v_cover_main.cc)")
    m.declare_property("select", bio.GMTYPE_BOOL, False, True, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.v_cover import v_cover
        res = v_cover(ctx.graph)
        print(f"covered (may be non-deterministic) = {int(res.count)}")
        return {"select": res.select.cpu().numpy()}

    m.set_run(run)
    return m


def make_communities() -> UserMain:
    m = UserMain("communities", "Label propagation (communities_main.cc)")
    m.declare_property("Comm", bio.GMTYPE_NODE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.communities import communities
        comm = communities(ctx.graph).comm.cpu().numpy()
        ids, cnt = np.unique(comm[: ctx.graph.num_nodes], return_counts=True)
        print("Community\t#Nodes\t\t(showing max 10 entries)")
        for i, c in list(zip(ids, cnt))[:10]:
            print(f"{i}\t\t{c}")
        return {"Comm": comm}

    m.set_run(run)
    return m


def make_potential_friends() -> UserMain:
    m = UserMain("potential_friends", "Friend-of-friend candidates "
                 "(potential_friends.gm; bit-matrix set property)")
    m.declare_scalar("return", bio.GMTYPE_LONG, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.analytics import potential_friends
        n = ctx.graph.num_nodes
        total = int(potential_friends(ctx.graph)[:n, :n].sum())
        print(f"potential friend pairs = {total}")
        return {"return": total}

    m.set_run(run)
    return m


def make_bc(name: str = "bc") -> UserMain:
    """bc (seeds 0..k-1), bc_random (xorshift seeds) and bc_adj (seeds
    0..k-1, ADJ input by default): one model, three mains."""
    m = UserMain(name, "Betweenness centrality, estimated over seeds "
                 f"({name}_main.cc)")
    m.declare_scalar("num_seeds", bio.GMTYPE_INT, True, False, default=4)
    m.declare_property("BC", bio.GMTYPE_FLOAT, False, True, GM_NODEPROP,
                       dump_count=4)   # the mains print BC[0..3]
    if name == "bc_adj":
        m.O.add_option("GMInputFormat", str, "ADJ",
                       "input format (default ADJ for this main)")

    def run(ctx: RunContext) -> Dict:
        from ..models.bc import bc
        n = ctx.graph.num_nodes
        k = int(ctx.scalars["num_seeds"])
        if name == "bc_random":
            # the JAX CLI's expression: int64 % uint64 is float64 in numpy
            from ..utils.gm_rand import GmRand32
            seeds = (GmRand32().sequence(k) % np.uint64(n)).astype(np.int32)
        else:
            seeds = np.arange(k) % n
        return {"BC": bc(ctx.graph, seeds).bc.cpu().numpy()}

    m.set_run(run)
    return m


def make_sssp_path(name: str = "sssp_path") -> UserMain:
    """sssp_path (``shortest path from b to e`` and the path) and
    sssp_path_adj (ADJ input by default; cost and link count)."""
    m = UserMain(name, "SSSP with path reconstruction "
                 f"({name}_main.cc)")
    m.declare_scalar("begin", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("end", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)
    if name == "sssp_path_adj":
        m.O.add_option("GMInputFormat", str, "ADJ",
                       "input format (default ADJ for this main)")

    def run(ctx: RunContext) -> Dict:
        from ..models.sssp_path import get_path, sssp_path
        b = int(ctx.scalars["begin"])
        e = int(ctx.scalars["end"])
        res = sssp_path(ctx.graph, b, _device_weights(ctx, "len"))
        path = get_path(res.prev.cpu().numpy(), b, e)
        if name == "sssp_path":
            print(f"shortest path from {b} to {e}")
            print(" -> ".join(str(v) for v in path) if path else "NO_PATH")
        elif not path:
            print("PATH NOT FOUND")
        else:
            print(f"{b} -> {e}")
            print(f"    Costs are {float(res.dist[e]):f}")
            print(f"    Number of links is {max(len(path) - 1, 0)}")
        return {}

    m.set_run(run)
    return m


def make_scc(name: str = "kosaraju") -> UserMain:
    """kosaraju and tarjan_scc run the forward-backward ``scc``; tarjan_scc
    runs the reference's tarjan_scc.gm literally instead where the source
    is present and the graph is within the host DFS's scale cap (100k
    nodes), as the JAX CLI does: the reference program is not exact Tarjan
    (its post-visit LowLink fold reads popped neighbors), and the literal
    run matches the reference app's output."""
    m = UserMain(name, "Strongly connected components "
                 "(kosaraju_main.cc protocol)")
    m.declare_property("mem", bio.GMTYPE_NODE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        n = ctx.graph.num_nodes
        if name == "tarjan_scc" and n <= 100_000 and \
                _reference_gm("tarjan_scc"):
            out = _compile_reference("tarjan_scc")(ctx.graph)
            comp = _host(out["SCC"])
            print(f"num_membership = {len(np.unique(comp[:n]))}")
            return {"mem": comp}
        from ..models.scc import scc
        comp = scc(ctx.graph).comp.cpu().numpy()
        mem = comp[: ctx.graph.num_nodes]
        print(f"num_membership = {len(np.unique(mem))}")
        return {"mem": comp}

    m.set_run(run)
    return m


def make_sssp_dijkstra() -> UserMain:
    m = UserMain("sssp_dijkstra", "Dijkstra-class SSSP (delta-stepping "
                 "reformulation; sssp_dijkstra_main.cc)")
    m.declare_scalar("src", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("dst", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.delta_stepping import delta_stepping
        res = delta_stepping(ctx.graph, int(ctx.scalars["src"]),
                             _device_weights(ctx, "len"))
        cost = int(res.dist[int(ctx.scalars["dst"])])
        if cost >= np.iinfo(np.int32).max // 2:
            print("weight   -1 ,hops  -1, path=NO_PATH_EXISTS")
        else:
            print(f"weight {cost:4d} ,hops  -1, path=FOUND")
        return {}

    m.set_run(run)
    return m


def make_bidir_dijkstra() -> UserMain:
    """bidir_dijkstra_main.cc's ``weight .. path=`` line.  Where the
    reference's bidir_dijkstra.gm is present it runs literally (the
    idiom recognizer lowers its two-map pop-min loop to forward and
    reverse device Bellman-Ford, ``lang/lower_priority.try_bidir_while``),
    as in the JAX CLI.  Elsewhere: forward ``sssp_path`` from src and
    ``sssp_path`` from dst over the transposed graph, met at the node of
    the smallest total, the two parent chains stitched."""
    m = UserMain("bidir_dijkstra", "Bidirectional Dijkstra "
                 "(bidir_dijkstra_main.cc: 'weight .. path=' line)")
    m.declare_scalar("src", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("dst", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("Weight", bio.GMTYPE_INT, True, False, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        g = ctx.graph
        n, e = g.num_nodes, g.num_edges
        w = _device_weights(ctx, "Weight")
        s = int(ctx.scalars["src"])
        t = int(ctx.scalars["dst"])
        if _reference_gm("bidir_dijkstra"):
            out = _compile_reference("bidir_dijkstra")(g, Weight=w, src=s,
                                                       dst=t)
            par = _host(out["Parent"])[:n].astype(np.int64)
            found = bool(out["_return"])
        else:
            found, par = _bidir_stitched(ctx, w, s, t)
        if not found:
            print("weight %4d ,hops %3d, time %7.2f path=%s"
                  % (0, -1, 0.0, "NO_PATH_EXISTS"))
            return {}
        # walk dst -> src through the parents, print src -> dst
        path = [t]
        seen = set()
        cur = t
        while cur != s and par[cur] >= 0 and cur not in seen:
            seen.add(cur)
            cur = int(par[cur])
            path.append(cur)
        path.reverse()
        # each hop costs its lightest parallel edge (at most 2^30), 0 where
        # the parent chain has no edge
        begin = g.begin.cpu().numpy()
        node_idx = g.node_idx[:e].cpu().numpy()
        w_h = ctx.edge_props["Weight"]
        weight = 0
        for a, b in zip(path[:-1], path[1:]):
            row = slice(begin[a], begin[a + 1])
            hit = w_h[row][node_idx[row] == b]
            weight += min(1 << 30, int(hit.min())) if hit.size else 0
        print("weight %4d ,hops %3d, time %7.2f path="
              % (weight, len(path), 0.0)
              + "".join(f"v{v}=>" for v in path))
        return {}

    m.set_run(run)
    return m


def _bidir_stitched(ctx: RunContext, w, s: int, t: int):
    """(found, parents) of the meet of forward and backward sssp_path."""
    from ..graph.csr import from_edges
    from ..models.sssp_path import sssp_path
    g = ctx.graph
    n, e = g.num_nodes, g.num_edges
    if "__transpose" not in ctx.device_props:
        gt, _ = from_edges(g.node_idx[:e].cpu().numpy(),
                           g.node_idx_src[:e].cpu().numpy(), n)
        # the transposed graph's CSR is g's CSC: weights through e_rev2idx
        wr = torch.zeros(gt.e_pad, dtype=torch.int32, device=g.device)
        wr[:e] = w.index_select(0, g.e_rev2idx[:e])
        ctx.device_props["__transpose"] = (gt.to(g.device), wr)
    gt, wr = ctx.device_props["__transpose"]
    rf = sssp_path(g, s, w)
    rb = sssp_path(gt, t, wr)
    big = np.int64(np.iinfo(np.int32).max)
    df = rf.dist[:n].cpu().numpy().astype(np.int64)
    db = rb.dist[:n].cpu().numpy().astype(np.int64)
    tot = np.where((df < big) & (db < big), df + db, big)
    mid = int(np.argmin(tot))
    par = np.full(n, -1, np.int64)
    if tot[mid] >= big:
        return False, par
    pf = rf.prev[:n].cpu().numpy()
    pb = rb.prev[:n].cpu().numpy()
    cur = mid
    while cur != s and pf[cur] >= 0:
        par[cur] = pf[cur]
        cur = int(pf[cur])
    cur = mid
    while cur != t and pb[cur] >= 0:
        par[int(pb[cur])] = cur
        cur = int(pb[cur])
    return True, par


def _make_sampling(name: str) -> UserMain:
    m = UserMain(name, f"{name} (sampling family; the JAX package's "
                 "counter-based threefry stream, not the reference xorshift: "
                 "outputs are distributional)")
    m.declare_scalar("n", bio.GMTYPE_INT, True, False, default=100)
    m.declare_property("sampled", bio.GMTYPE_BOOL, False, True,
                       GM_NODEPROP, dump_count=0)

    def run(ctx: RunContext) -> Dict:
        from ..models import sampling as S
        from ..runtime.rng import PRNGKey
        g = ctx.graph
        key = PRNGKey(0, g.device)
        n = int(ctx.scalars["n"])
        if name == "random_node_sampling":
            out = S.random_node_sampling(g, key, n)
        elif name == "random_degree_node_sampling":
            out = S.random_degree_node_sampling(g, key, n)
        else:
            out = S.random_walk_with_jump(g, key, steps=n)
        return {"sampled": out.cpu().numpy()}

    m.set_run(run)
    return m


def make_random_bipartite_matching() -> UserMain:
    m = UserMain("random_bipartite_matching",
                 "Parallel maximal bipartite matching")
    m.declare_property("isLeft", bio.GMTYPE_BOOL, True, False, GM_NODEPROP)
    m.declare_scalar("return", bio.GMTYPE_INT, False, True)

    def run(ctx: RunContext) -> Dict:
        from ..models.sampling import random_bipartite_matching
        g = ctx.graph
        if "__isLeft" not in ctx.device_props:
            left = np.zeros(g.n_pad, bool)
            if "isLeft" in ctx.node_props:
                left[: g.num_nodes] = np.asarray(
                    ctx.node_props["isLeft"]).astype(bool)
            else:
                # no property in the file: nodes with out-edges are left
                left[: g.num_nodes] = np.diff(g.begin.cpu().numpy()) > 0
            ctx.device_props["__isLeft"] = torch.from_numpy(left).to(
                g.device)
        res = random_bipartite_matching(g, ctx.device_props["__isLeft"])
        print(f"matched = {res.count}")
        return {"return": res.count}

    m.set_run(run)
    return m


def make_adamic_adar() -> UserMain:
    m = UserMain("adamicAdar", "Adamic-Adar edge scores "
                 "(adamicAdar_main.cc: '%d-> %5.5f' lines)")
    m.declare_property("aa", bio.GMTYPE_DOUBLE, False, True, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        aa = _host(_compile_reference("adamicAdar")(ctx.graph)["aa"])
        for i in range(min(10, ctx.graph.num_edges)):  # reference: all
            print(f"{i}-> {aa[i]:5.5f}")
        return {"aa": aa}

    m.set_run(run)
    return m


def make_b2() -> UserMain:
    m = UserMain("b2", "DFS pre/post-order smoke (b2_main.cc: timing "
                 "only)")
    m.declare_scalar("root", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_property("A", bio.GMTYPE_INT, False, True, GM_NODEPROP)
    m.declare_property("B", bio.GMTYPE_INT, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        out = _compile_reference("b2")(ctx.graph, s=_root(ctx))
        return {k: _host(out[k]) for k in ("A", "B") if k in out}

    m.set_run(run)
    return m


APPS = {
    "pagerank": make_pagerank,
    "hop_dist": make_hop_dist,
    "sssp": make_sssp,
    "multi_bfs": make_multi_bfs,
    "triangle_counting": make_triangle_counting,
    "conduct": make_conduct,
    "weak_cc": make_cc,
    "conduct_main": make_conduct_main,
    "avg_teen_cnt": make_avg_teen_cnt,
    "v_cover": make_v_cover,
    "communities": make_communities,
    "potential_friends": make_potential_friends,
    "kosaraju": make_scc,
    "tarjan_scc": lambda: make_scc("tarjan_scc"),
    "bc": make_bc,
    "bc_random": lambda: make_bc("bc_random"),
    "bc_adj": lambda: make_bc("bc_adj"),
    "sssp_path": make_sssp_path,
    "sssp_path_adj": lambda: make_sssp_path("sssp_path_adj"),
    "sssp_dijkstra": make_sssp_dijkstra,
    "bidir_dijkstra": make_bidir_dijkstra,
    "random_node_sampling": lambda: _make_sampling("random_node_sampling"),
    "random_degree_node_sampling":
        lambda: _make_sampling("random_degree_node_sampling"),
    "random_walk_sampling_with_random_jump":
        lambda: _make_sampling("random_walk_sampling_with_random_jump"),
    "random_bipartite_matching": make_random_bipartite_matching,
    "adamicAdar": make_adamic_adar,
    "b2": make_b2,
}


_GM_PRIM2BIO = {
    "BOOL": bio.GMTYPE_BOOL, "INT": bio.GMTYPE_INT,
    "LONG": bio.GMTYPE_LONG, "FLOAT": bio.GMTYPE_FLOAT,
    "DOUBLE": bio.GMTYPE_DOUBLE, "NODE": bio.GMTYPE_NODE,
    "EDGE": bio.GMTYPE_EDGE,
}


def make_custom(path: str) -> UserMain:
    """``gm_default_usermain`` analog for an arbitrary ``.gm`` file: the
    procedure's declared schema becomes the CLI.  Scalar inputs turn into
    flags, input properties load from the graph file (EBIN/AVRO), output
    properties and the return value print through the stdout protocol and
    store with ``-GMDumpGraph``, as the reference generates with
    ``-CppMain`` (``gm_default_usermain.cc:123``).  Collection and map
    arguments are not CLI-bindable; the library API
    (``compile_file(path)(g, ...)``) takes them."""
    from ..lang.lower import compile_file
    cp = compile_file(path)
    proc = cp.proc
    m = UserMain(proc.name,
                 f"{proc.name} (compiled from {os.path.basename(path)})")
    in_scalars, in_props, out_props, skipped = [], [], [], []
    for decl in proc.args:
        t = decl.type
        for nm in decl.names:
            if t.kind == "GRAPH":
                continue
            if t.is_property():
                bt = _GM_PRIM2BIO.get(getattr(t.elem, "kind", None),
                                      bio.GMTYPE_DOUBLE)
                kind = GM_NODEPROP if t.kind == "NODEPROP" else GM_EDGEPROP
                m.declare_property(nm, bt, True, False, kind)
                in_props.append((nm, kind))
            elif t.kind in _GM_PRIM2BIO:
                m.declare_scalar(nm, _GM_PRIM2BIO[t.kind], True, False,
                                 default=0)
                in_scalars.append(nm)
            else:
                skipped.append(nm)
    for decl in proc.out_args:
        t = decl.type
        for nm in decl.names:
            if t.is_property():
                bt = _GM_PRIM2BIO.get(getattr(t.elem, "kind", None),
                                      bio.GMTYPE_DOUBLE)
                kind = GM_NODEPROP if t.kind == "NODEPROP" else GM_EDGEPROP
                m.declare_property(nm, bt, False, True, kind)
                out_props.append(nm)
            elif t.kind in _GM_PRIM2BIO:
                m.declare_scalar(nm, _GM_PRIM2BIO[t.kind], False, True)
                out_props.append(nm)
    rt = proc.return_type
    if rt is not None and rt.kind in _GM_PRIM2BIO:
        m.declare_scalar("return", _GM_PRIM2BIO[rt.kind], False, True)
    if skipped:
        print(f"# note: collection/map args {skipped} are not "
              "CLI-bindable; pass them via the library API",
              file=sys.stderr)

    def run(ctx: RunContext) -> Dict:
        kw = {}
        for nm in in_scalars:
            v = ctx.scalars.get(nm)
            if v is not None:
                kw[nm] = v
        g = ctx.graph
        for nm, kind in in_props:
            src = (ctx.node_props if kind == GM_NODEPROP
                   else ctx.edge_props)
            if nm not in src:
                # gm_default_usermain.cc:419 do_preprocess fails the run
                # when a declared input property cannot be loaded
                k = ("node" if kind == GM_NODEPROP else "edge")
                have = sorted(src) or ["<none>"]
                raise SystemExit(
                    f"error: declared input {k} property '{nm}' is "
                    f"not present in the graph file (loaded {k} "
                    f"properties: {', '.join(have)}). Input "
                    "properties load only from formats that carry "
                    "them: EBIN (-GMInputFormat=ebin), AVRO, or a "
                    "typed EDGE list - plain BIN/ADJ files have "
                    "none.")
            a = np.asarray(src[nm])
            # the compiled binding takes padded arrays
            padded = np.zeros(g.n_pad if kind == GM_NODEPROP else g.e_pad,
                              a.dtype)
            padded[: a.shape[0]] = a
            kw[nm] = padded
        k = _num_chips(ctx)
        if k > 1 and _placement(ctx) == "replicate":
            out = _run_replicated(ctx, cp, k, **kw)
        elif k > 1:
            out = _run_compiled_vsharded(ctx, cp, k, **kw)
        else:
            out = cp(g, **kw)
        res = {nm: _host(out[nm]) for nm in out_props if nm in out}
        if "_return" in out:
            res["return"] = _host(out["_return"])
        return res

    m.set_run(run)
    return m


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m green_marl_tpu_torch.cli.run "
              "<app | file.gm> [options] <graph> [output]")
        print("apps: " + ", ".join(sorted(APPS)))
        return 1
    app = argv[0]
    if app not in APPS:
        if app.endswith(".gm") and os.path.exists(app):
            return make_custom(app).main(argv[1:])
        print(f"unknown app '{app}'; available: {', '.join(sorted(APPS))}"
              " (or a path to a .gm file)", file=sys.stderr)
        return 1
    return APPS[app]().main(argv[1:])
