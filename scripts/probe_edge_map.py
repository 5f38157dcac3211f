#!/usr/bin/env python3
"""Time the bit BFS's edge map (``ops/binned.py`` ``edge_map``, op
``"bor"``) on an NVIDIA GPU, level by level, and its final popcount, at the
shapes of the benchmark's cell ``lj.multi_bfs``.

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
the gathered bytes (each slot's row read once besides).  At each level
too the whole level in its two forms: the level kernel
(``kernels.edge_map_bor_level``: the edge map with ``hit & ~visited``, the
OR into ``visited`` and the count of the new frontier's rows in its row
writes; its hub rows updated by a second, small launch) held bit for bit
against the steps the model ran before it (the edge map, ``~``, ``&``,
``where``, ``|``, and the predicate's ``!= 0`` and ``any`` read to the
host), each timed on a fresh copy of ``visited``, with the level's own
bounds (``probes/bounds.py`` ``edge_map_bor_level``: the edge map's, and
the 16-byte pieces of ``visited`` that the level reads, where the OR has a
bit, and writes, where the next frontier has one).  Then the hub chunks alone
and the bins alone at the densest level, and the kernels' registers
(``probes/segment.py`` ``ptxas``).  On the batch's final plane,
the popcount (``kernels.bit_popstats``, ``csrc/popstats.cu``) held against
its plain version (``kernels.bit_popstats_ref``) bit for bit and timed
beside it and its bound (``probes/bounds.py`` ``bit_popstats``), with the
share of the plane's 32-bit words that are 0 or all ones and the share of
a word's 32-row blocks whose nonzero words differ (the blocks the kernel
transposes; read here, not on the main path, where it would cost a sync).
One JSON record a line; the last, ``"what": "exit"``, names the last record
written before the end and the exit status, also when a step raises.

Run from the root of a checkout::

    python3 scripts/probe_edge_map.py [--root DIR] [--no-ref]

``--root DIR`` takes the port's package from another checkout (``DIR``
holds ``green_marl_tpu_torch/``), the graph still from this one's
``gmbench/``; ``--no-ref`` times the kernel alone (no plain path, no
check).  Last, the device work of one profiled ``edge_map`` call, of one
``edge_map_level`` call and of one ``_bit_popstats`` call.
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
    from green_marl_tpu_torch.utils.timing import card, kernel_ms, timed

    dev = torch.device("cuda")
    smi = card(dev)

    def record(**kw):
        print(json.dumps({"root": args.root, "card": smi, **kw}), flush=True)
        last["what"] = " ".join(str(kw[k]) for k in ("what", "level")
                                if k in kw)

    for source in ("edge_map.cu", "popstats.cu"):
        record(what=f"ptxas {source}", lines=[
            f"{kernel}: {line}" for kernel, line in ptxas(
                os.path.abspath(args.root), source)])
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
           table_bytes=table_bytes, gathered_bytes=gathered_bytes,
           hub_epilogue="a second launch, a warp a hub row")

    visited = batched._bits_seed(bp, roots, pb)
    frontier = visited.clone()
    zero = torch.zeros((), dtype=visited.dtype, device=dev)
    node_rows = bp.node_rows_mask()

    def steps(vis):
        """The level as the model ran it before the level kernel; the
        predicate read to the host."""
        hit = K.edge_map_bor(bp, frontier)
        newly = torch.where(node_rows, hit & ~vis, zero)
        return newly, vis | newly, bool((newly != 0).any())

    def pieces(t):
        """Bytes of the node rows' 16-byte pieces (a lane's) of ``t`` that
        have a bit: where the level kernel reads ``visited`` (``t``: the
        OR) or writes it (``t``: the next frontier)."""
        raw = t[:bp.n_nodes].contiguous().view(torch.uint8)
        return 16 * int((raw.reshape(-1, 16) != 0).any(1).sum())

    def level_ms(fn):
        """The median device ms of ``fn(v)`` over GROUPS calls, each on a
        fresh copy ``v`` of ``visited`` (the level rewrites it)."""
        ms = []
        for _ in range(GROUPS + 1):            # the first: a warm-up
            vis = visited.clone()
            ms.append(timed(lambda: fn(vis), dev)[2])
            del vis
        return sorted(ms[1:])[GROUPS // 2]

    levels, densest, rows = [], None, len(roots)
    while rows:
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
        read = pieces(hit)
        del hit
        want, want_vis, _ = steps(visited)
        vis = visited.clone()
        nxt, rows = K.edge_map_bor_level(bp, frontier, vis)
        rows = int(rows)
        if not (torch.equal(nxt, want) and torch.equal(vis, want_vis)
                and rows == int((want != 0).any(1).sum())):
            raise SystemExit(f"probe_edge_map: level {len(levels)}: the "
                             "level kernel differs from the steps")
        del want, want_vis
        rec["level_ms"] = level_ms(
            lambda v: int(K.edge_map_bor_level(bp, frontier, v)[1]))
        rec["steps_ms"] = level_ms(steps)
        rec["new_rows"] = rows
        rec["visited_read_bytes"] = read
        rec["visited_written_bytes"] = pieces(nxt)
        rec["level_table_bound_ms"], rec["level_gathered_bound_ms"] = (
            bounds.bound_ms(b) for b in bounds.edge_map_bor_level(
                slots, bp.n_rows, size // 8, read,
                rec["visited_written_bytes"]))
        record(what="level", **rec)
        levels.append(rec)
        if densest is None or active > densest[0]:
            densest = (active, frontier.clone(), visited.clone())
        visited, frontier = vis, nxt
        del vis, nxt
    del frontier
    popstats(args, torch, K, bounds, kernel_ms, record, visited, deg_rows)
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
    with torch.profiler.profile(activities=acts) as prof:
        binned.edge_map_level(bp, densest[1], densest[2].clone(),
                              slot_chunk=chunk)
        torch.cuda.synchronize()
    record(what="device work of one edge_map_level call (the gm:edge_map "
                "span of a level)",
           ops={e.key: e.device_time_total for e in prof.key_averages()
                if e.device_time_total > 0})
    with torch.profiler.profile(activities=acts) as prof:
        batched._bit_popstats(visited, deg_rows, visited.shape[1], pb)
        torch.cuda.synchronize()
    record(what="device work of one _bit_popstats call (the gm:popstats "
                "span)",
           ops={e.key: e.device_time_total for e in prof.key_averages()
                if e.device_time_total > 0})
    total = sum(r["ms"] for r in levels)
    level_total = sum(r["level_ms"] for r in levels)
    summary = dict(what="call", levels=len(levels), ms=total,
                   table_bound_share=len(levels)
                   * bounds.bound_ms(table_bytes) / total,
                   gathered_bound_share=len(levels)
                   * bounds.bound_ms(gathered_bytes) / total,
                   level_ms=level_total,
                   steps_ms=sum(r["steps_ms"] for r in levels),
                   level_table_bound_share=sum(
                       r["level_table_bound_ms"] for r in levels)
                   / level_total,
                   level_gathered_bound_share=sum(
                       r["level_gathered_bound_ms"] for r in levels)
                   / level_total)
    if not args.no_ref:
        summary["ref_ms"] = sum(r["ref_ms"] for r in levels)
    record(**summary)


def popstats(args, torch, K, bounds, kernel_ms, record, visited, deg_rows):
    """The popcount of the batch's final plane: the kernel against the
    plain version, both timed, the bound, and how uniform the words are."""
    n_rows, lanes = visited.shape
    words = visited.view(torch.int32)            # 32-bit words, [n_rows, W]
    ends = (words == 0) | (words == -1)
    # a lane's block of 32 rows is transposed where its nonzero words differ
    tiles = torch.cat([words, words.new_zeros((-n_rows % 32, words.shape[1]))])
    tiles = tiles.view(-1, 32, words.shape[1])
    nz = tiles != 0
    lo = torch.where(nz, tiles, torch.iinfo(torch.int32).max).amin(1)
    hi = torch.where(nz, tiles, torch.iinfo(torch.int32).min).amax(1)
    transposed = nz.any(1) & (lo != hi)
    nbytes = bounds.bit_popstats(n_rows, lanes, visited.element_size())
    rec = dict(what="popstats", n_rows=n_rows, lanes=lanes, bytes=nbytes,
               bound_ms=bounds.bound_ms(nbytes),
               words_0_or_ones=float(ends.float().mean()),
               blocks_transposed=float(transposed.float().mean()))
    del words, ends, tiles, nz, lo, hi, transposed
    got = K.bit_popstats(visited, deg_rows)
    rec["ms"] = kernel_ms(lambda: K.bit_popstats(visited, deg_rows),
                          CALLS, GROUPS)[0]
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    if not args.no_ref:
        want = K.bit_popstats_ref(visited, deg_rows)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit("probe_edge_map: the popcount kernel differs "
                             "from the plain version")
        del want
        rec["ref_ms"] = kernel_ms(
            lambda: K.bit_popstats_ref(visited, deg_rows), 1, GROUPS)[0]
    record(**rec)


if __name__ == "__main__":
    sys.exit(main())
