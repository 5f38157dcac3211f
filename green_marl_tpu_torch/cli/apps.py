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
threefry stream with ``PRNGKey(0)``) and random_bipartite_matching
(``matched = %d``).  bc_adj and sssp_path_adj read ADJ input by default.
With ``-GMProfile``, pagerank and hop_dist time each superstep.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from ..graph import binary_io as bio
from .usermain import GM_EDGEPROP, GM_NODEPROP, RunContext, UserMain


def _root(ctx: RunContext) -> int:
    root = ctx.scalars.get("root")
    return int(root) if root is not None else 0


def _profile(ctx: RunContext) -> bool:
    """``-GMProfile``: print the graph's array report on stderr; the app
    then takes its per-superstep timed path."""
    if not ctx.options.get_option("GMProfile"):
        return False
    from ..utils.timing import graph_placement_report
    print(graph_placement_report(ctx.graph), file=sys.stderr)
    return True


def make_pagerank() -> UserMain:
    m = UserMain("pagerank", "PageRank power iteration (pagerank.gm)")
    m.declare_scalar("max_iter", bio.GMTYPE_INT, True, False, default=100)
    m.declare_scalar("e", bio.GMTYPE_DOUBLE, True, False, default=0.001)
    m.declare_scalar("d", bio.GMTYPE_DOUBLE, True, False, default=0.85)
    m.declare_property("rank", bio.GMTYPE_DOUBLE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
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
        from ..models.sssp import sssp
        res = sssp(ctx.graph, _root(ctx), _device_weights(ctx, "len"))
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
        from ..ops import binned
        g = ctx.graph
        B = int(ctx.scalars["num_roots"])
        pb = int(ctx.scalars["plane_bits"])
        if pb not in (8, 16, 32):
            raise SystemExit("plane_bits must be 8, 16 or 32")
        if B > 128 * pb:
            raise SystemExit(f"num_roots <= {128 * pb} at "
                             f"plane_bits={pb}")
        bp = binned.binned_in(g).to(g.device, with_edges=False)
        out_deg = g.out_degree().cpu().numpy()
        deg_rows = np.zeros(bp.n_rows, np.int32)
        deg_rows[: bp.n_nodes] = out_deg[: bp.n_nodes][bp.perm.cpu().numpy()]
        deg_rows = torch.from_numpy(deg_rows).to(g.device)
        # the JAX CLI's numpy call on the same int32 degrees: equal ties
        order = np.argsort(out_deg[: g.num_nodes])
        roots = order[::-1][:B].astype(np.int32)
        # eager PyTorch writes each gathered bin before reducing it: cap
        # that transient (the results do not change)
        lanes = (B + pb - 1) // pb
        chunk = binned.slot_chunk_for(lanes * pb // 8)
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
        avg, _ = avg_teen_cnt(g, g.node_prop(10, torch.int32),
                              int(ctx.scalars["K"]))
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
    """kosaraju and tarjan_scc: both run the forward-backward ``scc``.
    The JAX CLI runs tarjan_scc.gm literally when the reference's source
    is present; that route waits for the port of the .gm executor."""
    m = UserMain(name, "Strongly connected components "
                 "(kosaraju_main.cc protocol)")
    m.declare_property("mem", bio.GMTYPE_NODE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
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
    """bidir_dijkstra_main.cc's ``weight .. path=`` line.  This is the JAX
    CLI's route where the reference's bidir_dijkstra.gm is absent: forward
    ``sssp_path`` from src and ``sssp_path`` from dst over the transposed
    graph, met at the node of the smallest total, the two parent chains
    stitched.  The literal .gm route waits for the port of the .gm
    executor."""
    m = UserMain("bidir_dijkstra", "Bidirectional Dijkstra "
                 "(bidir_dijkstra_main.cc: 'weight .. path=' line)")
    m.declare_scalar("src", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_scalar("dst", bio.GMTYPE_NODE, True, False, default=1)
    m.declare_property("Weight", bio.GMTYPE_INT, True, False, GM_EDGEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..graph.csr import from_edges
        from ..models.sssp_path import sssp_path
        g = ctx.graph
        n, e = g.num_nodes, g.num_edges
        w = _device_weights(ctx, "Weight")
        if "__transpose" not in ctx.device_props:
            gt, _ = from_edges(g.node_idx[:e].cpu().numpy(),
                               g.node_idx_src[:e].cpu().numpy(), n)
            # the transposed graph's CSR is g's CSC: weights through e_rev2idx
            wr = torch.zeros(gt.e_pad, dtype=torch.int32, device=g.device)
            wr[:e] = w.index_select(0, g.e_rev2idx[:e])
            ctx.device_props["__transpose"] = (gt.to(g.device), wr)
        gt, wr = ctx.device_props["__transpose"]
        s = int(ctx.scalars["src"])
        t = int(ctx.scalars["dst"])
        rf = sssp_path(g, s, w)
        rb = sssp_path(gt, t, wr)
        big = np.int64(np.iinfo(np.int32).max)
        df = rf.dist[:n].cpu().numpy().astype(np.int64)
        db = rb.dist[:n].cpu().numpy().astype(np.int64)
        tot = np.where((df < big) & (db < big), df + db, big)
        mid = int(np.argmin(tot))
        if tot[mid] >= big:
            print("weight %4d ,hops %3d, time %7.2f path=%s"
                  % (0, -1, 0.0, "NO_PATH_EXISTS"))
            return {}
        par = np.full(n, -1, np.int64)
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
        # the stitched chain has no edge
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
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m green_marl_tpu_torch.cli.run "
              "<app> [options] <graph>")
        print("apps: " + ", ".join(sorted(APPS)))
        return 1
    if argv[0] not in APPS:
        print(f"unknown app '{argv[0]}'; available: "
              f"{', '.join(sorted(APPS))}", file=sys.stderr)
        return 1
    return APPS[argv[0]]().main(argv[1:])
