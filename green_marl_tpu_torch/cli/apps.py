"""Per-algorithm CLI drivers (the reference's generated ``*_main.cc``).

Counterpart of the single-device paths of ``green_marl_tpu/cli/apps.py``
for pagerank (``pagerank_main.cc``: ``rank[%d] = %0.9lf``, defaults
e=0.001 d=0.85 max=100), hop_dist (``dist[%d] = %d``), sssp (edge
lengths from the reference's xorshift RNG when the file carries none) and
multi_bfs (the batched bit-plane BFS; one ``batched bfs:`` line).
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
        if "len" not in ctx.edge_props:
            # the reference main draws lengths from its xorshift RNG over
            # CSR slots (sssp_main.cc:31-33); cached on ctx, so that
            # -GMMeasureTime's warm-up run pays for them
            from ..utils.gm_rand import sssp_edge_lengths
            ctx.edge_props["len"] = sssp_edge_lengths(g.num_edges)
        w = np.zeros(g.e_pad, np.int32)
        w[: g.num_edges] = ctx.edge_props["len"]
        res = sssp(g, _root(ctx), torch.from_numpy(w).to(g.device))
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


APPS = {
    "pagerank": make_pagerank,
    "hop_dist": make_hop_dist,
    "sssp": make_sssp,
    "multi_bfs": make_multi_bfs,
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
