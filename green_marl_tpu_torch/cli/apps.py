"""Per-algorithm CLI drivers (the reference's generated ``*_main.cc``).

Counterpart of the single-device paths of ``green_marl_tpu/cli/apps.py``
for pagerank (``pagerank_main.cc``: ``rank[%d] = %0.9lf``, defaults
e=0.001 d=0.85 max=100), hop_dist (``dist[%d] = %d``), sssp (edge
lengths from the reference's xorshift RNG when the file carries none),
multi_bfs (the batched bit-plane BFS; one ``batched bfs:`` line),
triangle_counting (``number of triangles: %d``), conduct and conduct_main
(``sum C = %lf`` over the four cuts of the xorshift membership), weak_cc,
avg_teen_cnt (``avg = %0.9f``; the main sets age=10, K=5), v_cover,
communities (the table of community sizes) and potential_friends.
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


def make_pagerank() -> UserMain:
    m = UserMain("pagerank", "PageRank power iteration (pagerank.gm)")
    m.declare_scalar("max_iter", bio.GMTYPE_INT, True, False, default=100)
    m.declare_scalar("e", bio.GMTYPE_DOUBLE, True, False, default=0.001)
    m.declare_scalar("d", bio.GMTYPE_DOUBLE, True, False, default=0.85)
    m.declare_property("rank", bio.GMTYPE_DOUBLE, False, True, GM_NODEPROP)

    def run(ctx: RunContext) -> Dict:
        from ..models.pagerank import pagerank
        res = pagerank(ctx.graph, e=float(ctx.scalars["e"]),
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
        from ..models.hop_dist import hop_dist
        return {"dist": hop_dist(ctx.graph, _root(ctx)).dist.cpu().numpy()}

    m.set_run(run)
    return m


def make_sssp() -> UserMain:
    m = UserMain("sssp", "Bellman-Ford SSSP (sssp.gm)")
    m.declare_scalar("root", bio.GMTYPE_NODE, True, False, default=0)
    m.declare_property("len", bio.GMTYPE_INT, True, False, GM_EDGEPROP)
    m.declare_property("dist", bio.GMTYPE_INT, False, True, GM_NODEPROP,
                       dump_count=10)

    def run(ctx: RunContext) -> Dict:
        from ..models.sssp import sssp
        g = ctx.graph
        if "len" not in ctx.device_props:
            if "len" not in ctx.edge_props:
                # the reference main draws lengths from its xorshift RNG
                # over CSR slots (sssp_main.cc:31-33)
                from ..utils.gm_rand import sssp_edge_lengths
                ctx.edge_props["len"] = sssp_edge_lengths(g.num_edges)
            # host lengths and device weights stay on ctx, so that
            # -GMMeasureTime's warm-up run pays for drawing and uploading
            # them, as the reference's prepare() does outside its timed run
            w = np.zeros(g.e_pad, np.int32)
            w[: g.num_edges] = ctx.edge_props["len"]
            ctx.device_props["len"] = torch.from_numpy(w).to(g.device)
        res = sssp(g, _root(ctx), ctx.device_props["len"])
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
