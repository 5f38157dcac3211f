"""Triangle counting at the LiveJournal scale on one NVIDIA GPU.

    python3 -m green_marl_tpu_torch.probes.triangle
        [--generator numpy|native|lj_undirected] [--nodes N] [--edges E]
        [--seed S] [--paths search,plain,sortmerge,routed]

Builds an RMAT graph, symmetrises it with ``to_undirected(dedup=False)``
(the DAG build deduplicates rows itself), builds the CSR and the
degree-ordered DAG on the host, and counts the triangles on the card by each
path, which must agree: ``search`` (``count_search``, the hand kernel
``kernels.triangle_search`` on the card), ``plain`` (its plain version,
``kernels.triangle_search_ref``, on the card), ``sortmerge`` (the join) and
``routed`` (``count_dag``).  It prints the card's name and power limit, the
seconds of every host phase (the join's layout too), D, the wedge count, and
per path T, the device seconds (CUDA events), Mwedges/s and the device
memory peak.  With ``search`` among the paths it then times the kernel
alone (``utils/timing.py`` ``kernel_ms``, 3 groups of ``CALLS`` calls)
beside its two bounds (``probes/bounds.py`` ``triangle_search``: the DAG
once, each anchor slot's row once) and its shares of them, and the plain
version's time where ``plain`` ran.

With its defaults (the numpy generator, N=4,800,000, E=69,000,000, seed 42)
the graph is bench.py's own (``generate.rmat_edges``, ``bench.py:239``), for
which BASELINE.md records T = 9,346,475; the last line says whether the
count equals it.  ``--generator native`` takes ``native/gm_io.cc``'s RMAT
stream instead: the same sizes in a few seconds, another graph.
``--generator lj_undirected`` draws the benchmark configuration
``gmbench/configs/lj_undirected.json`` (the cell ``lj.triangles``; its
sizes, ``--seed`` its labels) with the checkout's ``gmbench/`` and builds
its CSR and DAG on the card, as the cell's set-up does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..graph import generate, native
from ..graph.csr import to_undirected
from ..models import triangle
from ..ops import kernels
from ..utils.timing import card, kernel_ms, timed
from . import bounds

GOLDEN = (4_800_000, 69_000_000, 42, 9_346_475)   # bench.py's graph, its T
CALLS = 10          # kernel calls a timed group of ``search_bounds``


def count_paths(ctx, paths, log=print):
    """{path: (T, device seconds, peak bytes)} for the DAG ``ctx``; raises
    where two paths disagree."""
    out = {}
    dev = ctx.dag_dst.device
    for path in paths:
        fn = {"sortmerge": triangle.count_sortmerge,
              "search": triangle.count_search,
              "plain": plain_search,
              "routed": triangle.count_dag}[path]
        if path == "sortmerge" or (path == "routed"
                                   and triangle.route(ctx) == "sortmerge"):
            # the join's layout is made once per DAG, as the DAG itself is
            t0 = time.time()
            triangle._sortmerge_prep(ctx)
            log(f"{path}: the join's descending-pair layout and edge keys "
                f"(gm_desc_layout, numpy, upload) {time.time() - t0:.1f} s")
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t, _, ms = timed(lambda: fn(ctx), dev)
        secs = ms / 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        out[path] = (t, secs, peak)
        log(f"{path}: T={t} in {secs:.3f} s (CUDA events), "
            f"{ctx.num_wedges / secs / 1e6:.1f} Mwedges/s, memory peak "
            f"{peak / 1e9:.2f} GB")
    counts = {t for t, _, _ in out.values()}
    if len(counts) != 1:
        raise AssertionError(f"triangle paths disagree: {out}")
    return out


def plain_search(ctx) -> int:
    """The plain search on the DAG's device (``kernels.triangle_search_ref``,
    the kernel's plain version)."""
    return int(kernels.triangle_search_ref(ctx.dag_begin, ctx.dag_dst,
                                           ctx.pair_cum, ctx.num_wedges))


def search_shape(ctx):
    """``(anchor slots, their rows' entries)``: the DAG's slots that anchor
    a wedge, and the entries of each one's row b summed over them (torch on
    the DAG's device; two values read)."""
    D = ctx.num_dag_edges
    anchors = ctx.pair_cum[1:D + 1] > ctx.pair_cum[:D]
    b = ctx.dag_dst[:D][anchors].long()
    rows = ctx.dag_begin[b + 1].long() - ctx.dag_begin[b].long()
    return int(anchors.sum()), int(rows.sum())


def search_bounds(ctx, plain_s=None, log=print) -> dict:
    """The kernel's ms (median, min, max of 3 groups of ``CALLS``) beside
    its two bounds and shares (and the plain version's ms and bisection
    passes a chunk where given), one line logged; returned as a record."""
    dev = ctx.dag_dst.device
    args = (ctx.dag_begin, ctx.dag_dst, ctx.pair_cum, ctx.num_wedges)
    ms = kernel_ms(lambda: kernels.triangle_search(*args), CALLS, 3)
    anchors, entries = search_shape(ctx)
    once, rows = bounds.triangle_search(ctx.dag_begin.numel() - 1,
                                        ctx.num_dag_edges, anchors, entries)
    rec = {"kernel_ms": ms, "dag_once_bytes": once, "rows_b_bytes": rows,
           "dag_once_ms": bounds.bound_ms(once),
           "rows_b_ms": bounds.bound_ms(rows),
           "anchor_slots": anchors, "anchor_row_slots": entries,
           "plain_ms": None if plain_s is None else 1000 * plain_s,
           "plain_steps": kernels.search_steps(ctx.dag_begin),
           "card": card(dev)}
    plain = "" if plain_s is None else \
        f"; plain version {1000 * plain_s:.1f} ms " \
        f"({rec['plain_steps']} bisection passes a chunk)"
    log(f"triangle_search kernel {ms[0]:.3f} ms (min {ms[1]:.3f}, max "
        f"{ms[2]:.3f}; {CALLS} calls x 3 groups); bounds: DAG once "
        f"{rec['dag_once_ms']:.3f} ms ({once:,} B, share "
        f"{100 * rec['dag_once_ms'] / ms[0]:.2f}%), each anchor's row b "
        f"once {rec['rows_b_ms']:.3f} ms ({rows:,} B: {anchors:,} anchor "
        f"slots, {entries:,} row entries; share "
        f"{100 * rec['rows_b_ms'] / ms[0]:.1f}%){plain}")
    return rec


def lj_undirected_dag(seed, device, log=print):
    """The DAG of the benchmark configuration ``lj_undirected`` drawn with
    the run seed ``seed``, built on ``device`` (needs the checkout's
    ``gmbench/``)."""
    from gmbench import spec
    t0 = time.time()
    config = spec.load_json("configs", "lj_undirected")
    edges = spec.load_module("graphs", "rmat_undirected").draw(
        config, seed, device)
    n = edges.num_nodes
    ids = torch.arange(n + 1, dtype=torch.int32, device=device)
    begin = torch.searchsorted(edges.src, ids, out_int32=True)
    ctx = triangle.build_dag_torch(begin, edges.dst, n)
    torch.cuda.synchronize(device)
    log(f"lj_undirected (seed {seed}): {edges.src.numel()} undirected slots "
        f"drawn, CSR and DAG built on the card in {time.time() - t0:.1f} s; "
        f"D={ctx.num_dag_edges} wedges={ctx.num_wedges}")
    return ctx


def undirected_dag(src, dst, n, device, log=print):
    """The DAG context of the edge list made undirected, with the seconds of
    each host phase logged."""
    t0 = time.time()
    s, d = to_undirected(src, dst, dedup=False)
    begin, node_idx = native.build_csr(s, d, n)[:2]
    del s, d
    t1 = time.time()
    host = triangle.build_dag_host(begin, node_idx, n)
    t2 = time.time()
    ctx = triangle.dag_to_device(host, device)
    torch.cuda.synchronize(device)
    log(f"host build: undirected CSR of {node_idx.shape[0]} slots "
        f"{t1 - t0:.1f} s, DAG (gm_build_dag, then the pair prefix in numpy) "
        f"{t2 - t1:.1f} s, upload {time.time() - t2:.1f} s; "
        f"D={ctx.num_dag_edges} wedges={ctx.num_wedges}")
    return ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generator", choices=("numpy", "native",
                                            "lj_undirected"),
                    default="numpy")
    ap.add_argument("--nodes", type=int, default=GOLDEN[0])
    ap.add_argument("--edges", type=int, default=GOLDEN[1])
    ap.add_argument("--seed", type=int, default=GOLDEN[2])
    ap.add_argument("--paths", default="search,plain")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probes.triangle: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    say = lambda m: print(m, flush=True)     # noqa: E731
    say(f"card: {card(dev)}")
    if args.generator == "lj_undirected":
        ctx = lj_undirected_dag(args.seed, dev, log=say)
    else:
        t0 = time.time()
        gen = generate.rmat_edges if args.generator == "numpy" \
            else native.rmat_edges
        src, dst = gen(args.nodes, args.edges, seed=args.seed)
        say(f"{args.generator} RMAT N={args.nodes} E={args.edges} "
            f"seed={args.seed}: {time.time() - t0:.1f} s")
        ctx = undirected_dag(np.asarray(src, np.int32),
                             np.asarray(dst, np.int32), args.nodes, dev,
                             log=say)
        del src, dst
    paths = args.paths.split(",")
    res = count_paths(ctx, paths, log=say)
    t = next(iter(res.values()))[0]
    if "search" in paths:
        search_bounds(ctx, res["plain"][1] if "plain" in res else None,
                      log=say)
    if (args.generator, args.nodes, args.edges, args.seed) == \
            ("numpy",) + GOLDEN[:3]:
        say(f"golden: T={t} {'==' if t == GOLDEN[3] else '!='} "
            f"{GOLDEN[3]} (BASELINE.md)")
    else:
        say(f"T={t} (not bench.py's graph: no golden)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
