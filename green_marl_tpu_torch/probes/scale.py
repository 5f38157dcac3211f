"""Graphs past 2^24 nodes: the port of ``scripts/probe_vsharded_scale.py``.

    python -m green_marl_tpu_torch.probes.scale [--smoke] [--device cuda|cpu]

The graph is the JAX probe's (``probe_vsharded_scale.py:50-53``): N = 2^25
= 33,554,432 nodes and E = 250,000,000 RMAT edges, seed 77, drawn by
``native/gm_io.cc`` (``graph.native.rmat_edges``).  ``--smoke`` takes the
probe's ``VS_SCALE_SMOKE`` sizes, N = 2^17, E = 1.2M, B = 64.

On one device: ``pagerank`` (e=0, d=0.85, 3 supersteps, as the probe runs
pagerank.gm), ``hop_dist`` from ``roots[0]`` (the node of highest
out-degree) and the bit BFS ``multi_source_bfs_bits`` from the probe's B
roots (``default_rng(5)``, without replacement, ``roots[0]`` pinned), and
the compiled pagerank.gm.  Then S = 4 shards that share the device:
``hop_dist_vsharded``,
``multi_bfs_vsharded`` from the same roots, and the compiled hop_dist.gm
and pagerank.gm through ``lang.lower_vertex.run_vertex_sharded``.

Checks: BFS levels bit for bit against a scipy oracle for ``roots[0]``
(hop_dist, hop_dist_vsharded, hop_dist.gm); the reached sets of both bit
BFSs against the scipy oracle for roots 0, B/2 and B-1 (the probe's
sample); ``pagerank`` and the sharded pagerank.gm within relative error
1e-3 of a float64 host power iteration (the probe's bound,
``probe_vsharded_scale.py:235-237``), and the sharded pagerank.gm within
rtol 1e-5 of the one-device one.  Then the segment reduce against its
plain version on the slabs these runs gave it (the one-device CSC, the
engine's and the compiled schedule's shard 0): float add within rtol 1e-5
of the float64 sum, int32 min and max exactly.

Prints one JSON line: the sizes, host seconds of each stage, device ms of
each run (CUDA events around its one run, the first at these sizes; null
on the CPU), the kernel launches of each run, the device memory peak of the
runs, each slab's kernel and plain ms, the checks, and the card's name and
power limit.  Exits 1 when a check fails.
The entry point runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.timing import card, kernel_ms, timed
from .profile_sharded import PAGERANK_GM

SEED = 77
FULL = dict(n=1 << 25, e=250_000_000, b=256)        # probe :50-53
SMOKE = dict(n=1 << 17, e=1_200_000, b=64)          # probe :57-58
SHARDS = 4
PR_ITERS, PR_D = 3, 0.85       # pagerank.gm e=0 d=0.85 max=3 (probe :221)
PR_REL_ERR = 1e-3              # probe :235-237
INT32_MAX = 2**31 - 1

# the inline text of tests/test_lower.py (the reference's hop_dist.gm)
HOP_DIST_GM = """
Procedure hop_dist(G:Graph, dist:N_P<Int>, root: Node)
{
    N_P<Bool> updated;
    N_P<Bool> updated_nxt;
    N_P<Int>  dist_nxt;
    Bool fin = False;
    G.dist = (G == root) ? 0 : +INF;
    G.updated = (G == root) ? True: False;
    G.dist_nxt = G.dist;
    G.updated_nxt = G.updated;
    While(!fin) {
        fin = True;
        Foreach(n: G.Nodes)(n.updated) {
            Foreach(s: n.Nbrs) {
                <s.dist_nxt; s.updated_nxt> min= <n.dist + 1; True>;
            }
        }
        G.dist = G.dist_nxt;
        G.updated = G.updated_nxt;
        G.updated_nxt = False;
        fin = ! Exist(n: G.Nodes){n.updated};
    }
}
"""


def host_graph(n: int, e: int, seed: int = SEED):
    """``(Graph on the host, {stage: seconds})`` of the native RMAT
    stream."""
    from ..graph import native
    from ..graph.csr import from_edges
    t0 = time.time()
    src, dst = native.rmat_edges(n, e, seed=seed)
    t1 = time.time()
    g = from_edges(src, dst, n)[0]
    return g, {"t_gen_s": t1 - t0, "t_freeze_s": time.time() - t1}


def probe_roots(g, b: int) -> np.ndarray:
    """The probe's B roots: distinct, ``default_rng(5)``, and ``roots[0]``
    the node of highest out-degree (``probe_vsharded_scale.py:119-125``)."""
    out_deg = np.diff(g.begin.numpy())
    roots = np.random.default_rng(5).choice(
        g.num_nodes, size=b, replace=False).astype(np.int32)
    roots[0] = int(np.argmax(out_deg))
    return roots


def sample(b: int):
    """The instances whose reached sets are checked (probe :126)."""
    return [0, b // 2, b - 1]


def bfs_oracle(g, root: int) -> np.ndarray:
    """Exact BFS levels of the host CSR by scipy.sparse.csgraph (INT32_MAX
    where unreached)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    n, e = g.num_nodes, g.num_edges
    mat = csr_matrix((np.ones(e, np.int8), g.node_idx.numpy()[:e],
                      g.begin.numpy()), shape=(n, n))
    d = dijkstra(mat, directed=True, indices=root, unweighted=True)
    return np.where(np.isinf(d), INT32_MAX, d).astype(np.int32)


def pagerank_oracle(g, iters: int = PR_ITERS, d: float = PR_D) -> np.ndarray:
    """``iters`` float64 power iterations of pagerank.gm on the host CSC
    (nodes without out-edges contribute nothing)."""
    n, e = g.num_nodes, g.num_edges
    out_deg = np.diff(g.begin.numpy())
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1), 0.0)
    src = g.r_node_idx.numpy()[:e]
    dst = g.r_node_idx_dst.numpy()[:e]
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = (1 - d) / n + d * np.bincount(dst, weights=(r * inv)[src],
                                          minlength=n)
    return r


def oracles(g, roots) -> Dict:
    """The host oracles: BFS levels of the sampled roots and the float64
    ranks, with their seconds."""
    t0 = time.time()
    bfs = {b: bfs_oracle(g, int(roots[b])) for b in sample(len(roots))}
    t1 = time.time()
    rank = pagerank_oracle(g)
    return {"bfs": bfs, "rank": rank, "t_bfs_oracle_s": t1 - t0,
            "t_rank_oracle_s": time.time() - t1}


def _timed(dev, fn, ms: Dict, launches: Dict, run: str):
    """``fn()``; its device ms (``utils.timing.timed``: CUDA events on the
    card, None on the CPU) into ``ms[run]`` and the kernel launches it made
    into ``launches[run]``."""
    from ..ops import kernels as K
    before = K.launch_counts()
    out, _, ms[run] = timed(fn, dev)
    launches[run] = {k: v - before[k] for k, v in K.launch_counts().items()
                     if v != before[k]}
    return out


def _compile(text):
    from ..lang.lower import compile_source
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return compile_source(text)


def bit(planes: torch.Tensor, b: int) -> np.ndarray:
    """Instance b's reached set from [N, W] int32 bit planes."""
    return ((planes[:, b // 32] >> (b % 32)) & 1).bool().cpu().numpy()


def one_device(g_host, roots, dev, keep: Optional[Dict] = None) -> Dict:
    """pagerank, hop_dist from ``roots[0]``, the bit BFS from ``roots`` and
    the compiled pagerank.gm on one device; results on the host, and the
    pulls' slab (ids, offsets, n_out) on the host.  ``keep`` (a dict)
    receives the bit BFS's schedule on the host as ``"binned"``."""
    from ..models import batched
    from ..models.hop_dist import hop_dist
    from ..models.pagerank import pagerank
    from ..ops import binned
    n, B = g_host.num_nodes, len(roots)
    out, ms, sec, launches = {}, {}, {}, {}
    t0 = time.time()
    g = g_host.to(dev)
    sec["t_to_device_s"] = time.time() - t0
    pr = _timed(dev, lambda: pagerank(g, e=0.0, d=PR_D, max_iter=PR_ITERS),
                ms, launches, "pagerank")
    out["rank"] = pr.rank[:n].cpu().numpy()
    out["pr_iterations"] = pr.iterations
    hd = _timed(dev, lambda: hop_dist(g, int(roots[0])), ms, launches,
                "hop_dist")
    out["dist"] = hd.dist[:n].cpu().numpy()
    out["hop_levels"] = hd.iterations
    del pr, hd
    cp = _compile(PAGERANK_GM)
    res = _timed(dev, lambda: cp(g, e=0.0, d=PR_D, max=PR_ITERS), ms,
                 launches, "pagerank.gm")
    out["rank_gm"] = res["pg_rank"][:n].cpu().numpy()
    del g, res
    t0 = time.time()
    bp = binned.binned_in(g_host)
    sec["t_binned_build_s"] = time.time() - t0
    if keep is not None:
        keep["binned"] = bp
    bp = bp.to(dev, with_edges=False)
    rows = np.zeros(bp.n_rows, np.int32)
    rows[:n] = np.diff(g_host.begin.numpy())[bp.perm.cpu().numpy()]
    deg_rows = torch.from_numpy(rows).to(dev)
    bits = _timed(dev, lambda: batched.multi_source_bfs_bits(
        bp, roots, deg_rows, plane_bits=32,
        slot_chunk=binned.slot_chunk_for(B // 8)), ms, launches, "bit_bfs")
    planes = bp.from_binned(bits.visited[:n])
    out["reach"] = {b: bit(planes, b) for b in sample(B)}
    out["bit_levels"] = bits.levels_run
    out["bit_traversed"] = int(bits.traversed.sum())
    del bp, bits, planes, deg_rows
    slabs = {"one device": (g_host.r_node_idx_dst, g_host.r_begin,
                            g_host.n_pad)}
    return {"out": out, "ms": ms, "sec": sec, "launches": launches,
            "slabs": slabs}


def sharded(g_host, roots, dev, shards: int = SHARDS) -> Dict:
    """S shards that share ``dev``: hop_dist_vsharded, multi_bfs_vsharded,
    and the compiled hop_dist.gm and pagerank.gm vertex-sharded; results on
    the host, and shard 0's slabs of the engine and the schedule (ids,
    offsets, n_out) on the host."""
    from ..lang import lower_vertex as LV
    from ..parallel import comm
    from ..parallel import vertex_sharded as V
    n = g_host.num_nodes
    mesh = comm.Mesh([dev] * shards, ("v",))
    out, ms, sec, launches = {}, {}, {}, {}
    t0 = time.time()
    vsg = V.build_vertex_sharded(g_host, shards)
    sec["t_vsharded_build_s"] = time.time() - t0
    out["footprint"] = {"L": vsg.L, "E_s": vsg.E_s, "cap": vsg.cap,
                        "ghost_total": vsg.ghost_total}
    slabs = {"engine shard 0": (vsg.dst_local[0].clone(),
                                vsg.dst_off[0].clone(), vsg.L)}
    vsg = V.place(vsg, mesh)
    dist, depth = _timed(dev, lambda: V.hop_dist_vsharded(
        vsg, mesh, int(roots[0])), ms, launches, "hop_dist_vsharded")
    out["dist"] = dist.cpu().numpy()
    out["hop_levels"] = depth
    vis, depth = _timed(dev, lambda: V.multi_bfs_vsharded(vsg, mesh, roots),
                        ms, launches, "multi_bfs_vsharded")
    out["reach"] = {b: bit(vis, b) for b in sample(len(roots))}
    out["bit_levels"] = depth
    del vsg, dist, vis
    t0 = time.time()
    sched = LV.build_schedule(g_host, shards)
    sec["t_schedule_build_s"] = time.time() - t0
    slabs["schedule shard 0"] = (sched.dst_lpos[0].clone(),
                                 sched.csc_off[0].clone(), sched.L + 1)
    sched = LV.place_schedule(sched, mesh)
    g = g_host.to(dev)
    hd = _compile(HOP_DIST_GM)
    res = _timed(dev, lambda: LV.run_vertex_sharded(
        hd, g, mesh=mesh, sched=sched, root=int(roots[0])), ms, launches,
        "hop_dist.gm_vsharded")
    out["dist_gm"] = res["dist"][:n].cpu().numpy()
    pr = _compile(PAGERANK_GM)
    res = _timed(dev, lambda: LV.run_vertex_sharded(
        pr, g, mesh=mesh, sched=sched, e=0.0, d=PR_D, max=PR_ITERS), ms,
        launches, "pagerank.gm_vsharded")
    out["rank_gm"] = res["pg_rank"][:n].cpu().numpy()
    return {"out": out, "ms": ms, "sec": sec, "launches": launches,
            "slabs": slabs}


def slab_checks(slabs: Dict, dev) -> Dict[str, Dict]:
    """The segment reduce against its plain version on each slab
    ``name -> (ids, offsets, n_out)``: float add within rtol 1e-5 of the
    float64 sum, int32 min and max exactly, and on the card both versions'
    median ms of float add."""
    from ..ops import kernels as K
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    for name, (ids, off, n_out) in slabs.items():
        ids, off = ids.to(dev), off.to(dev)
        e = ids.numel()
        vals = torch.rand(e, generator=gen, device=dev)
        got = K.segment_reduce_sorted(vals, ids, off, n_out, op="add")
        want = K.segment_reduce_sorted_ref(vals.double(), ids, off, n_out,
                                           "add")
        r = {"slots": e, "rows": off.numel() - 1,
             "empty_rows": int((off.diff() == 0).sum()),
             "add_max_abs_err": float((got.double() - want).abs().max()),
             "add_ok": bool(torch.allclose(got.double(), want, rtol=1e-5,
                                           atol=0.0))}
        del got, want
        ivals = torch.randint(-2**30, 2**30, (e,), generator=gen,
                              device=dev, dtype=torch.int32)
        for op in ("min", "max"):
            r[f"{op}_exact"] = bool(torch.equal(
                K.segment_reduce_sorted(ivals, ids, off, n_out, op=op),
                K.segment_reduce_sorted_ref(ivals, ids, off, n_out, op)))
        if dev.type == "cuda":
            r["ms"] = kernel_ms(lambda: K.segment_reduce_sorted(
                vals, ids, off, n_out, op="add"), 1, 10)[0]
            r["plain_ms"] = kernel_ms(lambda: K.segment_reduce_sorted_ref(
                vals, ids, off, n_out, "add"), 1, 10)[0]
        res[name] = r
    return res


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| / |want| (the probe's measure)."""
    return float((np.abs(got.astype(np.float64) - want)
                  / np.maximum(np.abs(want), 1e-300)).max())


def checks(one: Dict, sh: Dict, orc: Dict, slabs: Dict) -> Dict[str, object]:
    """Every check of the witness by name: True/False, or an error."""
    o, s = one["out"], sh["out"]
    lv = orc["bfs"][0]
    c: Dict[str, object] = {
        "hop_dist_exact": bool(np.array_equal(o["dist"], lv)),
        "hop_dist_vsharded_exact": bool(np.array_equal(s["dist"], lv)),
        "hop_dist_gm_vsharded_exact": bool(np.array_equal(s["dist_gm"], lv)),
    }
    for b, levels in orc["bfs"].items():
        seen = levels < INT32_MAX
        c[f"bit_bfs_reach_b{b}"] = bool(np.array_equal(o["reach"][b], seen))
        c[f"multi_bfs_vsharded_reach_b{b}"] = bool(
            np.array_equal(s["reach"][b], seen))
    c["pagerank_max_rel_err"] = rel_err(o["rank"], orc["rank"])
    c["pagerank_gm_vsharded_max_rel_err"] = rel_err(s["rank_gm"],
                                                    orc["rank"])
    c["pagerank_ok"] = c["pagerank_max_rel_err"] < PR_REL_ERR
    c["pagerank_gm_vsharded_ok"] = \
        c["pagerank_gm_vsharded_max_rel_err"] < PR_REL_ERR
    c["pagerank_gm_sharded_eq_one_device"] = bool(np.allclose(
        s["rank_gm"], o["rank_gm"], rtol=1e-5, atol=0.0))
    for name, r in slabs.items():
        c[f"slab {name}"] = r["add_ok"] and r["min_exact"] and r["max_exact"]
    c["ok"] = all(v for k, v in c.items() if not k.endswith("rel_err"))
    return c


def _log(msg):
    print(f"# scale: {msg}", file=sys.stderr, flush=True)


def run(n: int, e: int, b: int, dev: torch.device,
        g_host=None, times: Optional[Dict] = None,
        keep: Optional[Dict] = None) -> Dict:
    """The whole witness; returns its record (``record["checks"]["ok"]``).
    ``g_host``/``times``: a graph already made by :func:`host_graph`.
    ``keep`` (a dict) receives the bit BFS's host schedule (``"binned"``)
    and the oracle's reached sets of the sampled roots (``"reach"``: root
    -> [N] bool), for a caller that runs on the same graph after."""
    if g_host is None:
        g_host, times = host_graph(n, e)
        _log(f"graph N={n} E={e}: {times}")
    rec = {"n": n, "e": e, "s": SHARDS, "b": b, "device": str(dev),
           **{k: round(v, 1) for k, v in (times or {}).items()}}
    if dev.type == "cuda":
        from ..ops import _build
        _build.lib()                  # the kernels' build is not a run's
        rec["card"] = card(dev)
        torch.cuda.reset_peak_memory_stats()
    roots = probe_roots(g_host, b)
    orc = oracles(g_host, roots)
    _log(f"oracles: BFS {orc['t_bfs_oracle_s']:.1f} s, ranks "
         f"{orc['t_rank_oracle_s']:.1f} s")
    one = one_device(g_host, roots, dev, keep)
    if keep is not None:
        keep["reach"] = {int(roots[b]): lv < INT32_MAX
                         for b, lv in orc["bfs"].items()}
    _log(f"one device: {one['ms']} ms")
    sh = sharded(g_host, roots, dev)
    _log(f"sharded: {sh['ms']} ms")
    for part in (orc, one["sec"], sh["sec"]):
        rec.update({k: round(v, 1) for k, v in part.items()
                    if k.startswith("t_")})
    rec["device_ms"] = {**one["ms"], **sh["ms"]}
    rec["launches"] = {**one["launches"], **sh["launches"]}
    rec["levels"] = {"hop_dist": one["out"]["hop_levels"],
                     "hop_dist_vsharded": sh["out"]["hop_levels"],
                     "bit_bfs": one["out"]["bit_levels"],
                     "multi_bfs_vsharded": sh["out"]["bit_levels"]}
    rec["roots"] = roots.tolist()
    rec["bit_bfs_edges_traversed"] = one["out"]["bit_traversed"]
    rec["footprint"] = sh["out"]["footprint"]
    if dev.type == "cuda":
        rec["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    rec["slabs"] = slab_checks({**one["slabs"], **sh["slabs"]}, dev)
    _log(f"slabs: {rec['slabs']}")
    rec["checks"] = checks(one, sh, orc, rec["slabs"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the probe's reduced sizes: N=2^17, E=1.2M, B=64")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    size = SMOKE if args.smoke else FULL
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probes/scale.py: no CUDA device (use --device cpu "
                         "for the CPU)")
    rec = run(size["n"], size["e"], size["b"], dev)
    print(json.dumps(rec), flush=True)
    return 0 if rec["checks"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
