#!/usr/bin/env python3
"""Time the bit BFS's edge map (``ops/binned.py`` ``edge_map``, op
``"bor"``) on an NVIDIA GPU, level by level, at the shapes of the
benchmark's cell ``lj.multi_bfs``.

The graph is the benchmark's configuration ``lj_msbfs`` (soc-LiveJournal1's
sizes), drawn and built on the card by the benchmark's own builders
(``gmbench/configs``, ``gmbench/graphs``, ``gmbench/csr.py``), and the
schedule is the cell's (``models.batched.bits_schedule`` at 4,096 sources,
32 to a lane: 512-byte rows).  From one batch of sources chosen by the
cell's batch rule it runs the BFS level by level, and at each level holds
the kernel (``kernels.edge_map_bor``, one launch) against the plain
gather-and-fold path (``kernels.edge_map_bor_ref``) bit for bit and times
both (``utils.timing.kernel_ms``).  Two bounds a level
(``probes/bounds.py`` ``edge_map_bor``): the table once (the slot ids, the
table and the output once each: what ``edge_map_roofline_pct`` counts) and
the gathered bytes (each slot's row read once besides).  Then the hub
chunks alone and the bins alone at the densest level, and the kernel's
registers (``probes/segment.py`` ``ptxas``).  One JSON record a line; the
last, ``"what": "exit"``, names the last record written before the end
and the exit status, also when a step raises.

Run from the root of a checkout::

    python3 scripts/probe_edge_map.py [--root DIR] [--no-ref]

``--root DIR`` takes the port's package from another checkout (``DIR``
holds ``green_marl_tpu_torch/``), the graph still from this one's
``gmbench/``; ``--no-ref`` times the kernel alone (no plain path, no
check).  Last, the device work of one profiled ``edge_map`` call.
"""

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "lj_msbfs"                  # gmbench/configs/<name>.json
SEED = 20261018                      # the graph's labels and the pivot
CALLS, GROUPS = 3, 3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--no-ref", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_edge_map: needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.append(REPO)                                  # gmbench/
    last = {"what": None}
    try:
        probe(args, torch, last)
    except BaseException as e:
        status = (e.code if isinstance(e, SystemExit)
                  and isinstance(e.code, int) else 1)
        print(json.dumps({"what": "exit", "after": last["what"],
                          "status": status,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        raise
    print(json.dumps({"what": "exit", "after": last["what"], "status": 0}),
          flush=True)


def probe(args, torch, last):
    """The probe's records, in order; ``last["what"]`` names the last one
    written."""
    from gmbench import csr as bench_csr
    from gmbench.queries import multi_bfs as kind
    from green_marl_tpu_torch.models import batched
    from green_marl_tpu_torch.ops import binned
    from green_marl_tpu_torch.ops import kernels as K
    from green_marl_tpu_torch.probes import bounds
    from green_marl_tpu_torch.probes.segment import ptxas
    from green_marl_tpu_torch.utils.timing import card, kernel_ms

    dev = torch.device("cuda")
    smi = card(dev)

    def record(**kw):
        print(json.dumps({"root": args.root, "card": smi, **kw}), flush=True)
        last["what"] = " ".join(str(kw[k]) for k in ("what", "level")
                                if k in kw)

    record(what="ptxas", lines=[line for _, line in ptxas(
        os.path.abspath(args.root), "edge_map.cu")])
    with open(os.path.join(REPO, "gmbench", "configs",
                           f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    gen = __import__(f"gmbench.graphs.{cfg['generator']}", fromlist=["draw"])
    edges = gen.draw(cfg, SEED, dev)
    g, _ = bench_csr.build(edges.src, edges.dst, edges.num_nodes, [])
    del edges
    size, pb = cfg["sources_per_call"], cfg["plane_bits"]
    bp, deg_rows, chunk = batched.bits_schedule(g, size, pb)
    nodes = kind.eligible(g.out_degree()[:g.num_nodes], 1)
    pick = torch.Generator().manual_seed(SEED)
    pivot = int(nodes[int(torch.randint(len(nodes), (1,), generator=pick))])
    roots = kind.batch(nodes, pivot, size)
    slots = bp.slot_src.numel()
    table_bytes, gathered_bytes = bounds.edge_map_bor(slots, bp.n_rows,
                                                      size // 8)
    record(what="schedule", n=g.num_nodes, e=g.num_edges, slots=slots,
           bins=len(bp.bins), widest=max(w for w, *_ in bp.bins),
           hubs=bp.n_hub, hub_chunks=bp.n_hub_chunks,
           table_bound_ms=bounds.bound_ms(table_bytes),
           gathered_bound_ms=bounds.bound_ms(gathered_bytes),
           table_bytes=table_bytes, gathered_bytes=gathered_bytes)

    visited = batched._bits_seed(bp, roots, pb)
    frontier = visited
    zero = torch.zeros((), dtype=visited.dtype, device=dev)
    node_rows = bp.node_rows_mask()
    levels, densest = [], None
    while bool((frontier != 0).any()):
        active = float((frontier != 0).any(1).float().mean())
        hit = K.edge_map_bor(bp, frontier)
        rec = dict(level=len(levels), active_rows=active)
        rec["ms"] = kernel_ms(lambda: K.edge_map_bor(bp, frontier), CALLS,
                              GROUPS)[0]
        if not args.no_ref:
            want = K.edge_map_bor_ref(bp, frontier, slot_chunk=chunk)
            if not torch.equal(hit, want):
                raise SystemExit(f"probe_edge_map: level {len(levels)}: "
                                 "the kernel differs from the plain path")
            del want
            rec["ref_ms"] = kernel_ms(
                lambda: K.edge_map_bor_ref(bp, frontier, slot_chunk=chunk),
                1, GROUPS)[0]
        record(what="level", **rec)
        levels.append(rec)
        if densest is None or active > densest[0]:
            densest = (active, frontier.clone())
        newly = torch.where(node_rows, hit & ~visited, zero)
        visited = visited | newly
        frontier = newly
    del frontier, hit
    parts = {"hub chunks": dataclasses.replace(bp, bins=()),
             "bins": dataclasses.replace(bp, n_hub_chunks=0,
                                         hub_row_off=bp.n_nodes)}
    for name, part in parts.items():
        ms = kernel_ms(lambda: K.edge_map_bor(part, densest[1]), CALLS,
                       GROUPS)[0]
        record(what=f"densest level, {name} alone", active_rows=densest[0],
               ms=ms)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        binned.edge_map(bp, densest[1], "bor", slot_chunk=chunk)
        torch.cuda.synchronize()
    record(what="device work of one edge_map call (the gm:edge_map span)",
           ops={e.key: e.device_time_total for e in prof.key_averages()
                if e.device_time_total > 0})
    total = sum(r["ms"] for r in levels)
    summary = dict(what="call", levels=len(levels), ms=total,
                   table_bound_share=len(levels)
                   * bounds.bound_ms(table_bytes) / total,
                   gathered_bound_share=len(levels)
                   * bounds.bound_ms(gathered_bytes) / total)
    if not args.no_ref:
        summary["ref_ms"] = sum(r["ref_ms"] for r in levels)
    record(**summary)


if __name__ == "__main__":
    sys.exit(main())
