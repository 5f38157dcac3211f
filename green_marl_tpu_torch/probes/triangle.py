"""Triangle counting at the LiveJournal scale on one NVIDIA GPU.

    python3 -m green_marl_tpu_torch.probes.triangle [--generator numpy|native]
        [--nodes N] [--edges E] [--seed S] [--paths sortmerge,search]

Builds an RMAT graph, symmetrises it with ``to_undirected(dedup=False)``
(the DAG build deduplicates rows itself), builds the CSR and the
degree-ordered DAG on the host, and counts the triangles on the card by each
path, which must agree.  It prints the card's name and power limit, the
seconds of every host phase (the join's layout too), D, the wedge count, and
per path T, the device seconds (CUDA events), Mwedges/s and the device
memory peak.

With its defaults (the numpy generator, N=4,800,000, E=69,000,000, seed 42)
the graph is bench.py's own (``generate.rmat_edges``, ``bench.py:239``), for
which BASELINE.md records T = 9,346,475; the last line says whether the
count equals it.  ``--generator native`` takes ``native/gm_io.cc``'s RMAT
stream instead: the same sizes in a few seconds, another graph.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..graph import generate, native
from ..graph.csr import to_undirected
from ..models import triangle
from ..utils.timing import card, timed

GOLDEN = (4_800_000, 69_000_000, 42, 9_346_475)   # bench.py's graph, its T


def count_paths(ctx, paths, log=print):
    """{path: (T, device seconds, peak bytes)} for the DAG ``ctx``; raises
    where two paths disagree."""
    out = {}
    dev = ctx.dag_dst.device
    for path in paths:
        fn = {"sortmerge": triangle.count_sortmerge,
              "search": triangle.count_search,
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
    ap.add_argument("--generator", choices=("numpy", "native"),
                    default="numpy")
    ap.add_argument("--nodes", type=int, default=GOLDEN[0])
    ap.add_argument("--edges", type=int, default=GOLDEN[1])
    ap.add_argument("--seed", type=int, default=GOLDEN[2])
    ap.add_argument("--paths", default="sortmerge,search")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probes.triangle: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print("card:", card(dev), flush=True)
    t0 = time.time()
    gen = generate.rmat_edges if args.generator == "numpy" \
        else native.rmat_edges
    src, dst = gen(args.nodes, args.edges, seed=args.seed)
    print(f"{args.generator} RMAT N={args.nodes} E={args.edges} "
          f"seed={args.seed}: {time.time() - t0:.1f} s", flush=True)
    ctx = undirected_dag(np.asarray(src, np.int32), np.asarray(dst, np.int32),
                         args.nodes, dev,
                         log=lambda m: print(m, flush=True))
    del src, dst
    res = count_paths(ctx, args.paths.split(","),
                      log=lambda m: print(m, flush=True))
    t = next(iter(res.values()))[0]
    if (args.generator, args.nodes, args.edges, args.seed) == \
            ("numpy",) + GOLDEN[:3]:
        print(f"golden: T={t} {'==' if t == GOLDEN[3] else '!='} "
              f"{GOLDEN[3]} (BASELINE.md)")
    else:
        print(f"T={t} (not bench.py's graph: no golden)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
