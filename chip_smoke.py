#!/usr/bin/env python3
"""Drive green_marl_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  The card's pass/fail: a kernel's time at
these shapes comes from its probe (``probes/segment.py``, ``probes/gather.py``,
``scripts/probe_relax.py``, ``scripts/probe_edge_map.py``), and this script
times only what no probe does.  Phases, each of which raises on failure:

1. the card's name and power limit; build the CUDA kernels and the native
   host library from the checkout's sources;
2. each kernel against its plain PyTorch version on the card, on segment
   layouts and sizes up to the LiveJournal-scale graph's (the prefix sum
   also in its exclusive form and on an unaligned view), then the segment
   reduce and the segmented scan on the layouts that stress kernels whose
   blocks own tiles of edge slots: one segment over all 69M slots,
   segments that end on tile edges, runs of empty segments at slot 0, at a
   tile edge and at the end, ``offsets[0] > 0``, ``n_out > n_seg``, far
   more tiles than the card holds at once, and 20 repeated launches that
   must agree; the segmented scan's only caller is this phase, as in the
   JAX package (its tests);
3. the main path through the CLI entry point on the tracked fixture
   ``data/parity/parity10k.bin`` (pagerank, hop_dist, sssp), checked against
   its goldens;
4. the same three apps through the CLI on a BIN file of an RMAT graph of
   1/16 of bench.py's LiveJournal-scale size (``running time=``, CRCs, the
   in-process output equal to the CLI's), and on the same graph stored with
   8-byte ``edge_t`` (the same lines); then the apps in process on the
   RMAT graph of the full size (N=4.8M, E=69M, seed 42), built in memory
   (its edges are drawn on a host thread while phases 1-3 run) and timed
   over the region the CLI times (a warm-up run, then the host clock from
   the call to the result on the host) beside CUDA events; then BFS from
   the four highest-degree nodes, checked against hop_dist and sssp;
5. one PageRank superstep's pull-sum on that graph, kernel against plain,
   sssp from the first of those roots superstep by superstep with the
   segment reduce's gather form (hop_dist's and sssp's relax step) held
   bit for bit against its plain version at each superstep, with the
   weights and with unit weights, the prefix sum, ``segment_sum_by_offsets``
   (BFS's pull sweep) against its earlier inclusive-scan-and-copy form and
   the segmented scan at that graph's shapes against their plain versions;
6. the batched engine: the ``multi_bfs`` CLI at bench.py's headline
   B=4096, plane_bits=32 on the 1/16-size file, equal to the in-process
   run there; then on the full-size graph, on one binned schedule, the bit
   BFS (instances 0-3 against hop_dist, one ``edge_map_bor_level`` launch
   a level; at level 3 the edge-map kernel against the plain gather and
   fold bit for bit, and faster, and the level kernel against its plain
   version: the next frontier, ``visited`` and the row count), the binned BFS at B=8 (distances equal hop_dist's) and
   the binned PageRank at B=128 (the d=0.85 instance against pagerank),
   with aggregate GTEPS, Gedge/s and the memory peak;
7. triangle counting and the analytics models.  On the full-size directed
   graph: weak_cc (its labels' invariants, two segment-reduce launches a
   superstep), conductance of the four cuts of ``conduct_membership``
   against numpy, avg_teen_cnt (through the prefix-sum kernel) against
   numpy.  The component and path models on the same graph: scc (its
   labels' invariants; the four largest components equal forward-reached
   and reverse-reached from their representatives), bc from each of phase
   4's roots (BC >= 0, sum of BC == sum of hop distances within rtol 1e-5),
   sssp_path (dist and supersteps equal sssp's, each predecessor edge
   tight and its source the smallest that is) and delta_stepping (delta=8,
   dist equal sssp's), each with its CUDA-event time and segment-reduce
   launches; their nine apps through the CLI on parity10k (bc_adj and
   sssp_path_adj from an adjacency list written to a temporary directory)
   against the JAX CLI's goldens; dijkstra_host_exact on parity10k against
   sssp, scc_np, bc_np and get_path on a 3,000-node RMAT.  The sampling
   family on the same graph: the card's threefry against the CPU's over
   2^24 draws, the two node samplings (n=100 and 100,000) and the walk of
   100,000 steps against the host's computation from the same draws (the
   degree sampling up to the nodes within 4 ulps of their probability:
   the card sums 69M degrees in float32), W=4096 walkers of 100 steps
   (each move along an edge or a jump) and the matching (mutual, left to
   right, maximal) with its rounds and launches; pagerank_profiled against
   pagerank; through the CLI the four sampling apps on parity10k, hop_dist
   -GMDumpGraph=1 in six formats and -GMProfile=1 on the 1/16-size file,
   against the JAX CLI's goldens.  Then that graph
   made undirected with every slot kept (138M
   slots; the CSR is merged on the card, and that merge is held against
   ``to_undirected(dedup=False)`` + ``native.build_csr`` at the 1/16 size):
   the host DAG build in seconds, the DAG built on the card
   (``build_dag_torch``) equal to it bit for bit, and ``count_dag`` (the
   search by the router: one ``triangle_search`` launch) equal to the
   plain search and the sort-merge join on the same ``DagContext``, each
   with its device time, Mwedges/s and memory peak, the kernel no slower
   than the plain search.  At the 1/16 size, the DAG of the graph with its
   parallel edges: the search, the plain search and the join agree; then
   symmetrised with ``dedup=True``: ``triangle_count``, the search, the
   plain search, the join and ``triangle_count_literal`` agree with the
   multigraph's count, and all agree with
   ``triangle_count_np`` on a 2,000-node RMAT; ``triangle_counting``
   through the CLI on parity10k against its golden; communities, v_cover,
   potential_friends and adamic_adar_edges against their oracles or the
   plain host computation on small graphs, communities also timed at the
   1/16 size;
8. the gather probes: first both probe kernels against their plain versions
   on the inputs that stress their designs (the row gather at 2^21 ids that
   are duplicate-heavy, clipped on both sides, all equal or sorted; the
   take-along gather's axis0 and composed modes on a 2 MB window and on
   blocks of 1024, 4096 and 16384 rows, plain and split indices, with the
   route each shape takes), then ``python -m
   green_marl_tpu_torch.probes.gather``: each probe kernel against its
   plain version, and their times.

9. compiled ``.gm`` programs through ``green_marl_tpu_torch.lang``: at the
   full size, the inline pagerank and hop_dist of tests/test_lower.py
   against the hand-written models (pagerank e=1e-7 d=0.85 max=100 within
   rtol 1e-4, its iterations counted by its segment-reduce launches;
   hop_dist from phase 4's roots bit for bit), each with its CUDA-event and
   host time beside the model's, and both profiled once more
   (``torch.profiler``, device time by kernel group); on parity10k, a
   CommonNbrs program and
   adamicAdar, an InBFS with a navigator and InReverse, a DFS (on a
   2,000-node RMAT), Uniform()
   draws in a traced While and a ``[ C++ ]`` escape (built by g++ here)
   against the JAX package's goldens, a pop-min Dijkstra (lowered by
   ``try_priority_while``) against ``dijkstra_host_exact``,
   ``doc/examples/local_clustering.gm`` through the CLI (``make_custom``)
   against the JAX CLI's lines, and ``gmc -DS=2 -Dr`` against JAX gmc's
   output.

10. multi-device on one card: 4 shards of one program share the card
   (``GM_TORCH_VIRTUAL_DEVICES=4``, ``parallel.comm``), on the full-size
   graph.  The host partition builds (``build_vertex_sharded``,
   ``build_schedule``: their host seconds and bytes per shard); the
   vertex-sharded engines against the single-device models (pagerank
   within rtol 1e-5 and the same supersteps; hop_dist and sssp from phase
   4's roots bit for bit; the multi-source BFS at B=64, its first 4
   instances' reached sets against hop_dist's); the compiled pagerank,
   hop_dist and avg_teen_cnt programs through ``run_vertex_sharded``
   (distribute) and pagerank and hop_dist through
   ``distribute.run_sharded`` (replicate) against the models or the
   one-device compiled run; each with its CUDA-event time beside the
   single-device run's, its own launches (the engines one segment reduce a
   shard a superstep) and the memory peak; the segment reduce and the
   prefix sum against their plain versions on the shards' own slabs (the
   engine's, the compiled schedule's, and the replicate placement's with
   its clipped offsets), each no slower than its plain version; the
   multi-process path (``parallel.multihost``) on NCCL with one rank of 4
   shards on the card, pagerank_vsharded and hop_dist_vsharded against the
   same runs as threads (two ranks need a second card); then pagerank,
   hop_dist and sssp through the CLI with ``-GMNumChips=4`` under the
   distribute, engine and replicate placements on parity10k, against the
   goldens.

11. graphs past 2^24 nodes (``green_marl_tpu_torch.probes.scale``, the
   port of ``scripts/probe_vsharded_scale.py``): N = 2^25 RMAT nodes and
   120M edges (the probe's 250M cut to keep the run's time), seed 77,
   drawn and frozen on a host thread from the start of the run; on one
   device pagerank, hop_dist, the bit BFS at B=256 and pagerank.gm, then 4
   shards on the card (hop_dist_vsharded, multi_bfs_vsharded, hop_dist.gm
   and pagerank.gm vertex-sharded): BFS levels bit for bit against scipy,
   the reached sets of three roots, ranks within 1e-3 of float64, sharded
   == one device; each run's launches; the segment reduce against its
   plain version on the runs' slabs (the one-device CSC, the engine's and
   the schedule's shard 0); host seconds, device ms and the memory peak;
12. compiled programs in lockstep (``CompiledProc.batch``) on phase 4's
   graph, 16 lanes each: pagerank.gm over damping values in [0.70, 0.92],
   hop_dist.gm and sssp.gm from the 16 highest-out-degree roots, and
   avg_teen_cnt.gm with its band's lower bound as an argument over 16
   bounds; each batched run's launches (the lane-batched kernels' on their
   own), time (and again, warm) beside its 16 single runs and device peak;
   each lane against its single run; pagerank.gm's pulls == its slowest
   lane's iterations; ``torch.profiler`` groups of a batched pagerank.gm
   and hop_dist.gm;
   then the lane-batched segment reduce and prefix sum against their plain
   versions on the [16, E_pad] values the runs gave them, each lane against
   the 1-D kernel, each no slower than its plain version.
13. the harness and the probes of the hot paths, on the card: the placement
   matrix (``harness.matrix_sweep``: pagerank, hop_dist, sssp, conduct,
   avg_teen_cnt and multi_bfs under each placement at 8 shards, the
   compiled ones from the inline ``.gm`` texts of this script) on its own
   400-node graph and at the 1/16 size, every one of the 12 cells against
   the one-device run; the scaling ladder (``harness.scaling``, S = 1, 2,
   4, 8) on phase 4's graph, ranks bit-identical across S, then the segment
   reduce against its plain version on an S=8 shard's slab;
   ``harness.multihost_bench``'s card rows at N=400k, E=4M (threads and one
   NCCL rank of 4 shards, the same checksums; the 2- and 4-rank rows not
   run on one card); the Twitter-class bit BFS at B=1024
   (``probes.twitter_scale``) on phase 11's graph and schedule, fused ==
   paged, one ``edge_map_bor_level`` launch a fused level and one
   ``edge_map_bor`` a paged level, the instances whose roots phase 11 held
   against scipy reaching scipy's sets; ``probes.bfs``'s pull sweep, push tiers and auto BFS on
   phase 4's graph (the BFS's reached set == hop_dist's), then the prefix
   sum against its plain version on the pull sweep's values; and
   ``probes.prep``'s stages at the 1/16 size.

Each path's kernel launches are counted from 0 just before it and read just
after: phase 2's segmented scan, phases 3-4 (the main path), phase 6 (the
full-size bit BFS on its own: one ``edge_map_bor_level`` a level, the
count that the kernels record gives for the level kernel), phase 7 (with
the component and path models and the sampling family counted on their own
too), phase 8, phase 9 (each compiled call on its own), phase 10,
phase 11, phase 12 (each batched and single run on its own) and phase 13
(each harness run and probe on its own; the paged bit BFS's there, the
count that the kernels record gives for the edge map).
Times are CUDA events through ``utils.timing`` (``timed`` around one call,
``kernel_ms`` for a kernel against its plain version).  The last two lines
are a JSON record of the kernels (each with the probe that times it) and
the JSON status line, which names the last phase begun and the exit
status, also when a phase raises.  Exits non-zero, with no result, where
CUDA is unavailable.
"""

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "data", "parity", "parity10k.bin")
LJ_N, LJ_E, LJ_SEED = 4_800_000, 69_000_000, 42   # bench.py:50-52
SMALL_N, SMALL_E = LJ_N // 16, LJ_E // 16         # the CLI round trip's file

# parity10k goldens: JAX CLI on the CPU; hop_dist matches the reference
# binary bit for bit (BASELINE.md:78)
GOLD_HOP_CRC16 = "0x5003"
GOLD_SSSP_CRC16 = "0x8e4e"
GOLD_SSSP_DIST = [0, 141, 114, 170]
GOLD_RANK = [0.000078454, 0.000063880, 0.000108653, 0.000057279]
GOLD_TRIANGLES = 93     # JAX CLI on the CPU; the reference's count too
RANK_RTOL = 1e-4        # device tolerance of scripts/parity.py:85
# the JAX CLI on the CPU (bc_adj and sssp_path_adj on parity10k written as
# an adjacency list): BC[0..3] within rtol 1e-4, else lines printed as they are
GOLD_PATH_APPS = {
    "kosaraju": ["num_membership = 5", "CRC16 mem 0x548e"],
    "tarjan_scc": ["num_membership = 5", "CRC16 mem 0x548e"],
    "bc": [9997.305664062, 9996.0, 9998.295898438, 9998.009765625],
    "bc_random": [1.059930205, 0.111111112, 0.184523821, 1.811904788],
    "bc_adj": [9997.305664062, 9996.0, 9998.295898438, 9998.009765625],
    "sssp_path": ["shortest path from 0 to 1",
                  "0 -> 6375 -> 3953 -> 3521 -> 8551 -> 1"],
    "sssp_path_adj": ["0 -> 1", "    Costs are 141.000000",
                      "    Number of links is 5"],
    "sssp_dijkstra": ["weight  141 ,hops  -1, path=FOUND"],
    "bidir_dijkstra": ["weight  141 ,hops   6, time    0.00 path="
                       "v0=>v6375=>v3953=>v3521=>v8551=>v1=>"],
}

# the JAX CLI on the CPU: the four sampling apps on parity10k (-n=100,
# PRNGKey(0)); the matching with isLeft = even ids from an EBIN property
GOLD_SAMPLING_APPS = {
    "random_node_sampling": ["CRC sampled 0x96dd5f0c",
                             "CRC16 sampled 0x9d72"],
    "random_degree_node_sampling": ["CRC sampled 0xcc996094",
                                    "CRC16 sampled 0x33c2"],
    "random_walk_sampling_with_random_jump": ["CRC sampled 0x489144ab",
                                              "CRC16 sampled 0xdb25"],
    "random_bipartite_matching": ["matched = 1",
                                  "random_bipartite_matching returns: 1"],
}
GOLD_MATCHED_EVEN_LEFT = 4128
# SHA-256 of the file hop_dist -GMDumpGraph=1 writes on parity10k (AVRO with
# its random sync marker zeroed), by the JAX CLI on the CPU
GOLD_DUMP_SHA256 = {
    "BIN": "e187c7eab368e503e13d2d3a57fa8cfd8d7eb3c7f17dc06f3ffe6c6e5a619b88",
    "NULL": "e187c7eab368e503e13d2d3a57fa8cfd8d7eb3c7f17dc06f3ffe6c6e5a619b88",
    "EBIN": "5b0fb30bb09686de3e48ce47bb3144d20df5907a61f5a231ebac05c6d7183861",
    "EDGE": "1b3944e3942fb2286f024679e305fdf47e96dffdec965dfc8fe6295d8ef128d1",
    "NODE_PROP":
        "69ff5bb3942db1b381cc4d2fd8f98bfe0282dadd62a67d2d455e30076735225c",
    "AVRO": "49638c057863817850a0f8f17e9f9d77a22e8f3c2784253e067a74a4bf80cb40",
}
# -GMProfile=1 on the 1/16-size file (SHA-256 below): the JAX CLI's
# superstep lines, and hop_dist's CRC16
GOLD_SMALL_SHA256 = \
    "c3dd2a5b049b5e0afaf1ac5f6491f40cfce87c085dffba13a255a5a75c854c25"
GOLD_PROFILE_STEPS = {"pagerank": 10, "hop_dist": 9}
GOLD_SMALL_HOP_CRC16 = "0x0893"

MULTI_B, PLANE_BITS = 4096, 32     # bench.py:53-54, the headline
EDGE_MAP_LEVEL = 3                 # the bit BFS level phase 6 checks
PR_B, PR_ITERS = 128, 20           # bench.py:55-56

REPLACES = {
    "segment_reduce_sorted": "green_marl_tpu/ops/pallas_kernels.py:54",
    "plain_cumsum": "green_marl_tpu/ops/pallas_kernels.py:224",
    "segmented_scan": "green_marl_tpu/ops/pallas_kernels.py:134",
    "take_along_blocks": "scripts/probe_gather2.py:118",
    "row_gather_checksum": "scripts/probe_gather4.py:36",
}
SOURCES = {
    "segment_reduce_sorted": "green_marl_tpu_torch/csrc/segment_reduce.cu",
    "plain_cumsum": "green_marl_tpu_torch/csrc/cumsum.cu",
    "segmented_scan": "green_marl_tpu_torch/csrc/segmented_scan.cu",
    "take_along_blocks": "green_marl_tpu_torch/csrc/gather_probe.cu",
    "row_gather_checksum": "green_marl_tpu_torch/csrc/gather_probe.cu",
}
# the probe that times each kernel (and its plain version, its bound and
# any PyTorch call of the same function) at these phases' shapes
SEGMENT_PROBE = "python3 green_marl_tpu_torch/probes/segment.py"
TIMED_BY = {
    "segment_reduce_sorted": SEGMENT_PROBE,
    "plain_cumsum": SEGMENT_PROBE,
    "segmented_scan": SEGMENT_PROBE,
    "take_along_blocks": "python3 -m green_marl_tpu_torch.probes.gather",
    "row_gather_checksum": "python3 -m green_marl_tpu_torch.probes.gather",
    "segment_reduce_sorted[lanes]": SEGMENT_PROBE + " --lanes 16",
    "plain_cumsum[lanes]": SEGMENT_PROBE + " --lanes 16",
    "segment_reduce_sorted[gather]": "python3 scripts/probe_relax.py",
    "edge_map_bor": "python3 scripts/probe_edge_map.py",
    "edge_map_bor_level": "python3 scripts/probe_edge_map.py",
    "bit_popstats": "python3 scripts/probe_edge_map.py",
    "triangle_search": "python3 -m green_marl_tpu_torch.probes.triangle "
                       "--generator lj_undirected",
}


T_START = time.time()
PHASE = ["none"]                   # the heading of the phase last begun


def log(msg):
    if msg.startswith("== "):     # a phase's heading: when it began
        PHASE[0] = msg[3:]
        msg += f"  [at {time.time() - T_START:.1f} s]"
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: FAILED: {what}")
    log(f"  ok: {what}")


def mean_ms(fn, calls=10):
    """Mean device ms of ``calls`` back-to-back calls of ``fn`` after one
    warm-up call (``utils.timing.kernel_ms``, one group)."""
    from green_marl_tpu_torch.utils.timing import kernel_ms
    return kernel_ms(fn, calls, 1)[0]


def timed_launches(fn, counts):
    """``(fn(), CUDA-event ms, host ms, launches by name)`` of one call
    (``utils.timing.timed``); ``counts()`` gives the launch counts by
    name."""
    import torch

    from green_marl_tpu_torch.utils.timing import timed
    before = counts()
    out, host, ms = timed(fn, torch.device("cuda"))
    after = counts()
    return out, ms, host, {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}


def run_cli(apps, argv):
    """Run one app through the CLI entry point; returns its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = apps.main(argv)
    out = buf.getvalue()
    log("  | " + out.rstrip().replace("\n", "\n  | "))
    if rc != 0:
        raise AssertionError(f"chip_smoke: CLI {argv} returned {rc}")
    return out


def result_lines(out):
    """A CLI run's lines without its timings."""
    return [ln for ln in out.splitlines() if "time=" not in ln]


def host_graph(native, from_edges, n, e, seed):
    """(edges, frozen graph on the host, seconds of each) of the native
    RMAT stream."""
    t0 = time.time()
    src, dst = native.rmat_edges(n, e, seed=seed)
    t1 = time.time()
    g = from_edges(src, dst, n)[0]
    return src, dst, g, t1 - t0, time.time() - t1


def launched_since(K, before):
    """The kernels launched since ``before = K.launch_counts()``, by name."""
    return {name: n - before[name] for name, n in K.launch_counts().items()
            if n != before[name]}


def popstats_check(torch, K, visited, deg_rows):
    """Phase 6: the popcount of the full-size bit BFS's visited plane, the
    kernel (one launch) against the plain version, its largest difference
    (0 where they agree bit for bit), and both timed."""
    before = K.launch_counts()
    got = K.bit_popstats(visited, deg_rows)
    launched = launched_since(K, before)
    want = K.bit_popstats_ref(visited, deg_rows)
    max_err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    del got, want
    return dict(
        max_err=max_err, launched=launched,
        ms=mean_ms(lambda: K.bit_popstats(visited, deg_rows), 5),
        plain_ms=mean_ms(lambda: K.bit_popstats_ref(visited, deg_rows), 1))


def edge_map_level_check(torch, K, batched, bp, roots, chunk):
    """Phase 6: the bit BFS's edge map at level ``EDGE_MAP_LEVEL`` of the
    full-size run, on its frontier: the kernel (one launch) against the
    plain gather-and-fold path bit for bit, and both timed; then the level
    kernel (one launch) against its plain version on copies of that
    level's ``visited``: the next frontier, ``visited`` and the row count
    equal."""
    visited = batched._bits_seed(bp, roots, PLANE_BITS)
    frontier = visited
    zero = torch.zeros((), dtype=visited.dtype, device=visited.device)
    node_rows = bp.node_rows_mask()
    for _ in range(EDGE_MAP_LEVEL):
        frontier = torch.where(node_rows,
                               K.edge_map_bor(bp, frontier) & ~visited, zero)
        visited |= frontier
    before = K.launch_counts()
    got = K.edge_map_bor(bp, frontier)
    launched = launched_since(K, before)
    same = torch.equal(got, K.edge_map_bor_ref(bp, frontier,
                                               slot_chunk=chunk))
    del got
    before = K.launch_counts()
    vis = visited.clone()
    got, rows = K.edge_map_bor_level(bp, frontier, vis)
    level_launched = launched_since(K, before)
    want_vis = visited.clone()
    want, want_rows = K.edge_map_bor_level_ref(bp, frontier, want_vis,
                                               slot_chunk=chunk)
    level_same = (torch.equal(got, want) and torch.equal(vis, want_vis)
                  and int(rows) == int(want_rows))
    del got, want, vis, want_vis
    return dict(
        same=same, launched=launched, level_same=level_same,
        level_launched=level_launched,
        active=float((frontier != 0).any(1).float().mean()),
        ms=mean_ms(lambda: K.edge_map_bor(bp, frontier), 5),
        plain_ms=mean_ms(lambda: K.edge_map_bor_ref(
            bp, frontier, slot_chunk=chunk), 2))


def relax_form_check(torch, K, g, root, w, sp):
    """Phase 5: sssp from ``root`` superstep by superstep, the segment
    reduce's gather form (the main path's relax step) held bit for bit
    against its plain version at each superstep, with the weights and with
    unit weights (``add=None``); the steps must reach ``sp``, the model's
    own run."""
    src, ids, offs, n_pad = g.r_node_idx, g.r_node_idx_dst, g.r_begin, g.n_pad
    w_csc = w.index_select(0, g.e_rev2idx)
    inf = torch.tensor(torch.iinfo(torch.int32).max, dtype=torch.int32,
                       device=src.device)
    dist = torch.full((n_pad,), int(inf), dtype=torch.int32,
                      device=src.device)
    dist[root] = 0
    upd = torch.zeros(n_pad, dtype=torch.bool, device=src.device)
    upd[root] = True
    shares = []                      # of the slots whose source is set
    equal = {"weights": True, "unit weights": True}
    while bool(upd.any()):
        for what, add in (("weights", w_csc), ("unit weights", None)):
            kw = dict(node_vals=dist, node_mask=upd, add=add)
            got = K.segment_reduce_sorted(src, ids, offs, n_pad, "min", **kw)
            want = K.segment_reduce_sorted_ref(src, ids, offs, n_pad, "min",
                                               **kw)
            equal[what] &= torch.equal(got, want)
            if add is not None:
                best = got
        shares.append(round(float(upd.index_select(0, src[:g.num_edges])
                                  .float().mean()), 4))
        new = torch.minimum(dist, best)
        upd = new < dist
        dist = new
    for what, ok in equal.items():
        check(ok, f"gather form int32 min with {what} on the LJ arrays: "
              f"kernel == plain at each of sssp's {len(shares)} supersteps "
              f"from root {root} (shares of the slots' sources set: "
              f"{shares})")
    check(len(shares) == sp.iterations and torch.equal(dist, sp.dist),
          f"those {len(shares)} supersteps reach sssp's own distances")


def timed_calls(module, name, sink):
    """Wrap ``module.name`` so that each call appends its seconds to
    ``sink``; returns the original, to put back."""
    real = getattr(module, name)

    def wrapper(*args):
        t0 = time.time()
        out = real(*args)
        sink.append(time.time() - t0)
        return out

    setattr(module, name, wrapper)
    return real


def undirected_csr(torch, g):
    """``(begin, dst)`` on ``g``'s device of ``g`` made undirected with every
    slot kept: row v holds v's out- and in-neighbours, sorted.  The CSR of
    ``to_undirected(src, dst, dedup=False)``, merged from the CSR and CSC the
    card already holds by one sort of ``row << 32 | neighbour`` keys."""
    e = g.num_edges
    keys = torch.cat([
        (g.node_idx_src[:e].long() << 32) | g.node_idx[:e].long(),
        (g.r_node_idx_dst[:e].long() << 32) | g.r_node_idx[:e].long()])
    keys = keys.sort().values
    return g.begin + g.r_begin, (keys & 0xFFFFFFFF).to(torch.int32)


def models_phase(torch, K, dev, g, g_host, g16):
    """Phase 7, first part: the models that run on the directed graphs.
    Returns the full-size graph's undirected CSR on the host."""
    from green_marl_tpu_torch.graph import generate
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.models import analytics, cc, communities
    from green_marl_tpu_torch.models import conductance as cond
    from green_marl_tpu_torch.models import v_cover
    from green_marl_tpu_torch.utils.gm_rand import conduct_membership

    n, e = g.num_nodes, g.num_edges

    def timed(fn):
        """(result, CUDA-event ms) of one call."""
        return timed_launches(fn, K.launch_counts)[:2]

    # weak_cc at the full size
    cc.weak_cc(g, max_iter=2)                         # warm-up
    before = K.launch_counts()
    res, ms = timed(lambda: cc.weak_cc(g))
    grown = launched_since(K, before)
    comp = res.comp[:n]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    check(bool((comp <= ids).all()) and bool((comp >= 0).all())
          and torch.equal(comp[g.node_idx_src[:e].long()],
                          comp[g.node_idx[:e].long()])
          and torch.equal(comp[comp.long()], comp),
          f"weak_cc at the full size: comp[v] <= v, equal across every "
          f"edge, comp[comp[v]] == comp[v]; {res.iterations} supersteps, "
          f"{ms:.1f} ms ({ms / res.iterations:.2f} a superstep), "
          f"{int((comp == ids).sum())} components")
    check(grown == {"segment_reduce_sorted": 2 * res.iterations},
          f"weak_cc launched the segment-reduce kernel twice a superstep "
          f"({grown})")

    # conductance of the four cuts against numpy
    begin = g_host.begin.numpy()
    src_h = g_host.node_idx_src.numpy()[:e]
    dst_h = g_host.node_idx.numpy()[:e]
    t0 = time.time()
    member_h = conduct_membership(n)
    member = torch.zeros(g.n_pad, dtype=torch.int32)
    member[:n] = torch.from_numpy(member_h)
    member = member.to(dev)
    deg = np.diff(begin).astype(np.int64)
    got, ms = timed(lambda: [float(cond.conductance(g, member, i))
                             for i in range(4)])
    want = []
    for num in range(4):
        inside = member_h == num
        m = np.float32(min(deg[inside].sum(), deg[~inside].sum()))
        cross = np.float32((inside[src_h] & ~inside[dst_h]).sum())
        want.append(float(cross / m))
    check(got == want and all(0 < c < np.inf for c in got),
          f"conductance of the four cuts of conduct_membership at the full "
          f"size == numpy on the host ({got}; sum {sum(got):f}; "
          f"{ms:.1f} ms for the four, with a host read each; membership "
          f"and numpy {time.time() - t0:.1f} s)")

    # avg_teen_cnt through the prefix-sum kernel
    age_h = np.zeros(g.n_pad, np.int32)
    age_h[:n] = np.random.default_rng(5).integers(0, 60, n)
    age = torch.from_numpy(age_h).to(dev)
    before = K.launch_counts()
    (avg, cnt), ms = timed(lambda: analytics.avg_teen_cnt(g, age, 30))
    grown = launched_since(K, before)
    teen = (age_h >= 10) & (age_h < 20)
    cnt_h = np.bincount(dst_h[teen[src_h]], minlength=n)
    sel = age_h[:n] > 30
    check(np.array_equal(cnt[:n].cpu().numpy(), cnt_h)
          and abs(float(avg) - cnt_h[sel].sum() / sel.sum()) < 1e-5
          and grown == {"plain_cumsum": 1},
          f"avg_teen_cnt at the full size: counts == numpy, avg "
          f"{float(avg):.6f}; {ms:.2f} ms; launches {grown}")
    del age, cnt, member, comp, ids, res

    # communities: against its oracle on a small graph, timed at 1/16
    def small(nn, mm, seed):
        return from_edges(*generate.rmat_edges(nn, mm, seed=seed), nn)[0]

    gs = small(3000, 24_000, 71)
    res = communities.communities(gs.to(dev))
    want = communities.communities_np(gs.begin.numpy(),
                                      gs.node_idx.numpy()[:gs.num_edges])
    check(np.array_equal(res.comm[:3000].cpu().numpy(), want),
          f"communities N=3000 E=24000 == communities_np "
          f"({res.iterations} supersteps, {len(np.unique(want))} labels)")
    before = K.launch_counts()
    res, ms = timed(lambda: communities.communities(g16))
    comm = res.comm[:g16.num_nodes]
    check(bool(((comm >= 0) & (comm < g16.num_nodes)).all()),
          f"communities at the 1/16 size: labels are node ids; "
          f"{res.iterations} supersteps, {ms:.1f} ms "
          f"({ms / res.iterations:.2f} a superstep), launches "
          f"{launched_since(K, before)}")

    # v_cover: one host sync a step, so a graph of a few thousand edges
    gs = small(1000, 4000, 72)
    res, ms = timed(lambda: v_cover.v_cover(gs.to(dev)))
    sel, cnt = v_cover.v_cover_np(gs.begin.numpy(),
                                  gs.node_idx.numpy()[:gs.num_edges])
    check(np.array_equal(res.select[:gs.num_edges].cpu().numpy(), sel)
          and int(res.count) == cnt,
          f"v_cover N=1000 E=4000 == v_cover_np (covered {cnt}, "
          f"{res.iterations} steps, {ms:.1f} ms)")

    # potential_friends and adamic_adar_edges against dense numpy
    gs = small(2000, 16_000, 73)
    ne = gs.num_edges
    s_h, d_h = gs.node_idx_src.numpy()[:ne], gs.node_idx.numpy()[:ne]
    slots = np.zeros((2000, 2000))
    np.add.at(slots, (s_h, d_h), 1.0)                 # with multiplicity
    adj = (slots > 0).astype(np.float64)
    pot = ((adj @ adj) > 0) & (adj == 0)
    np.fill_diagonal(pot, False)
    got = analytics.potential_friends(gs.to(dev))[:2000, :2000].cpu().numpy()
    check(np.array_equal(got, pot),
          f"potential_friends N=2000 == dense numpy ({int(pot.sum())} pairs)")
    # float32 weights as on the card: 1 / log(1.0000001) is 8.4e6 there
    wgt = (1.0 / np.log(np.maximum(np.diff(gs.begin.numpy()).astype(
        np.float32), np.float32(1.0000001)))).astype(np.float64)
    want = ((slots * wgt) @ adj.T)[s_h, d_h]
    got = analytics.adamic_adar_edges(gs.to(dev))
    check(np.allclose(got, want, rtol=1e-5, atol=1e-7) and (want > 0).any(),
          f"adamic_adar_edges N=2000 within rtol 1e-5 of dense numpy "
          f"(max abs err {np.abs(got - want).max():.3g})")

    t0 = time.time()
    u_begin, u_dst = undirected_csr(torch, g)
    u_begin, u_dst = u_begin.cpu().numpy(), u_dst.cpu().numpy()
    log(f"  undirected CSR of the full-size graph merged on the card and "
        f"read back in {time.time() - t0:.1f} s ({u_dst.shape[0]} slots)")
    return u_begin, u_dst


def paths_phase(torch, K, dev, apps, g, w, roots, bfs_res):
    """Phase 7, the component and path models: scc, bc, sssp_path and
    delta_stepping on the full-size graph, each against what it must equal;
    the nine apps through the CLI on parity10k against the JAX CLI's
    goldens; the host oracles on a 3,000-node RMAT."""
    import tempfile

    from green_marl_tpu_torch.graph import binary_io, generate
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.models import bc, bfs, delta_stepping, scc
    from green_marl_tpu_torch.models import sssp as sssp_mod
    from green_marl_tpu_torch.models import sssp_path
    from green_marl_tpu_torch.models.relax import INT32_MAX
    from green_marl_tpu_torch.utils.gm_rand import sssp_edge_lengths

    n, e = g.num_nodes, g.num_edges

    def timed(fn):
        """(result, CUDA-event ms, segment-reduce launches) of one call."""
        out, ms, _, launched = timed_launches(fn, K.launch_counts)
        return out, ms, launched.get("segment_reduce_sorted", 0)

    # scc at the full size; the four largest components against forward and
    # reverse BFS from their representatives
    res, ms, launches = timed(lambda: scc.scc(g))
    comp = res.comp[:n]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    sizes = torch.bincount(comp.long(), minlength=n)
    top = sizes.topk(4)
    check(bool((comp >= 0).all()) and bool((comp <= ids).all())
          and torch.equal(comp[comp.long()], comp),
          f"scc at the full size: comp[v] <= v, comp[comp[v]] == comp[v]; "
          f"{res.rounds} rounds, {int((comp == ids).sum())} components, the "
          f"largest {int(top.values[0])} nodes; {ms:.1f} ms (CUDA events), "
          f"{launches} segment-reduce launches")
    for r, size in zip(top.indices.tolist(), top.values.tolist()):
        fwd = bfs.bfs(g, r).level[:n] >= 0
        rev = bfs.bfs(g, r, reverse=True).level[:n] >= 0
        check(torch.equal(comp == r, fwd & rev),
              f"scc component of {r} ({size} nodes) == forward-reached "
              f"and reverse-reached from {r}")
    del comp, ids, sizes, fwd, rev, res

    # bc seeded at each of phase 4's roots: sum_v BC(v) == sum_t dist(s, t)
    for r in roots:
        res, ms, launches = timed(lambda: bc.bc(g, [r]))
        vals = res.bc[:n]
        level = bfs_res[r].level[:n]
        total = float(vals.double().sum())
        hops = float(level[level > 0].double().sum())
        check(bool((vals >= 0).all()) and bool(torch.isfinite(vals).all())
              and abs(total - hops) <= 1e-5 * hops,
              f"bc seed {r}: BC >= 0, sum BC {total:.6e} == sum of hop "
              f"distances {hops:.6e} within rtol 1e-5 ({abs(total - hops) / hops:.2e}); "
              f"{bfs_res[r].levels_run} levels, {ms:.1f} ms, {launches} "
              f"segment-reduce launches")
    del res, vals, level

    # sssp_path and delta_stepping from the same roots, against sssp
    src64 = g.node_idx_src[:e].long()
    dst64 = g.node_idx[:e].long()
    w64 = w[:e].long()
    for r in roots:
        sp, sp_ms, sp_l = timed(lambda: sssp_mod.sssp(g, r, w))
        res, ms, launches = timed(lambda: sssp_path.sssp_path(g, r, w))
        check(torch.equal(res.dist, sp.dist)
              and res.iterations == sp.iterations,
              f"sssp_path root {r}: dist == sssp's bit for bit, "
              f"{res.iterations} supersteps each; sssp_path {ms:.1f} ms "
              f"({launches} segment-reduce launches), sssp {sp_ms:.1f} ms "
              f"({sp_l})")
        dist = res.dist[:n].long()
        prev = res.prev[:n].long()
        pe = res.prev_edge[:n].long()
        reached = (dist < INT32_MAX) & (torch.arange(n, device=dev) != r)
        v = reached.nonzero().squeeze(1)
        pv, pev = prev[v], pe[v]
        # a superstep keeps, among the sources that lower dist[x] to its
        # final value, the smallest, and the smallest slot of that source's
        # edges; those sources settled one superstep before x, so x's
        # superstep is its depth in the prev tree
        depth = torch.zeros(n, dtype=torch.long, device=dev)
        for _ in range(res.iterations):
            depth = torch.where(reached, depth[prev.clamp(min=0)] + 1, 0)
        du, dv = dist[src64], dist[dst64]
        tight = ((du < INT32_MAX) & (dv < INT32_MAX) & (du + w64 == dv)
                 & (dst64 != r))
        first = tight & (depth[src64] + 1 == depth[dst64])
        least = torch.full((n,), n, dtype=torch.long, device=dev)
        least.scatter_reduce_(0, dst64[first], src64[first], "amin")
        first &= src64 == prev[dst64]
        least_slot = torch.full((n,), e, dtype=torch.long, device=dev)
        least_slot.scatter_reduce_(0, dst64[first], first.nonzero()
                                   .squeeze(1), "amin")
        check(bool((pv >= 0).all()) and torch.equal(src64[pev], pv)
              and torch.equal(dst64[pev], v)
              and torch.equal(dist[pv] + w64[pev], dist[v]),
              f"sssp_path root {r}: for all {v.numel()} reached v != root, "
              f"node_idx_src[prev_edge[v]] == prev[v] and dist[prev[v]] + "
              f"len[prev_edge[v]] == dist[v]")
        check(bool((depth[src64[tight]] + 1 >= depth[dst64[tight]]).all())
              and torch.equal(least[v], pv)
              and torch.equal(least_slot[v], pev),
              f"sssp_path root {r}: prev[v] is the smallest source of the "
              f"tight edges into v from the superstep that settled v, and "
              f"prev_edge[v] that source's smallest such slot ("
              f"{int((tight & (depth[src64] + 1 > depth[dst64])).sum())} "
              f"tight edges settle later; prev tree depth "
              f"{int(depth.max())})")
        del dist, prev, pe, reached, v, pv, pev, du, dv, tight, first
        del depth, least, least_slot
        ds, ms, launches = timed(
            lambda: delta_stepping.delta_stepping(g, r, w, delta=8))
        check(torch.equal(ds.dist, sp.dist),
              f"delta_stepping delta=8 root {r}: dist == sssp's; "
              f"{ds.buckets_processed} buckets, {ds.inner_steps} inner "
              f"steps, {ms:.1f} ms, {launches} segment-reduce launches")
        del sp, res, ds
    del src64, dst64, w64

    # the nine apps through the CLI on parity10k, against the JAX CLI
    raw = binary_io.load_binary(FIXTURE)
    with tempfile.TemporaryDirectory() as tmp:
        adj = os.path.join(tmp, "parity10k.adj")
        with open(adj, "w") as f:
            for u in range(raw.begin.shape[0] - 1):
                f.write(" ".join(map(str, [u, *raw.node_idx[
                    raw.begin[u]:raw.begin[u + 1]]])) + "\n")
        for app, gold in GOLD_PATH_APPS.items():
            t0 = time.time()
            before = K.launch_counts()
            out = run_cli(apps, [app, "-GMDevice=cuda",
                                 adj if app.endswith("_adj") else FIXTURE])
            launched = launched_since(K, before)
            lines = [ln for ln in out.splitlines() if "time=" not in ln]
            if app.startswith("bc"):
                got = [float(field(out, rf"^BC\[{i}\] = (\S+)"))
                       for i in range(4)]
                ok = np.allclose(got, gold, rtol=1e-4, atol=0.0)
            else:
                ok = all(ln in lines for ln in gold)
            check(ok, f"{app} on parity10k through the CLI == the JAX CLI's "
                  f"{gold} ({time.time() - t0:.1f} s; launches {launched})")

    # the host oracles on small graphs
    g10 = raw.freeze()[0].to(dev)
    wf = np.zeros(g10.e_pad, np.int32)
    wf[:g10.num_edges] = sssp_edge_lengths(g10.num_edges)
    wf = torch.from_numpy(wf).to(dev)
    d10 = sssp_mod.sssp(g10, 0, wf).dist.cpu().numpy()
    t0 = time.time()
    for dest in (1, 77, 9999):
        found, _, _, dd = sssp_mod.dijkstra_host_exact(g10, wf, 0, dest)
        check(found and dd == int(d10[dest]),
              f"dijkstra_host_exact on parity10k 0 -> {dest}: {dd} == sssp's "
              f"distance ({time.time() - t0:.1f} s)")
    gs_h = from_edges(*generate.rmat_edges(3000, 24_000, seed=75), 3000)[0]
    gs = gs_h.to(dev)
    b_h, ni_h = gs_h.begin.numpy(), gs_h.node_idx[:gs_h.num_edges].numpy()
    got = scc.scc(gs).comp[:3000].cpu().numpy()
    want = scc.scc_np(b_h, ni_h)
    check(np.array_equal(got, want), f"scc N=3000 == scc_np (Tarjan; "
          f"{len(np.unique(want))} components)")
    seeds = [int(s) for s in np.argsort(np.diff(b_h))[::-1][:4]]
    got = bc.bc(gs, seeds).bc[:3000].cpu().numpy()
    want = bc.bc_np(b_h, ni_h, seeds)
    check(np.allclose(got, want, rtol=1e-4, atol=1e-3) and want.max() > 0,
          f"bc N=3000 seeds {seeds} within rtol 1e-4 of bc_np (float64; max "
          f"abs err {np.abs(got - want).max():.3g})")
    ws = torch.from_numpy(np.random.default_rng(75).integers(
        1, 100, gs.e_pad).astype(np.int32)).to(dev)
    res = sssp_path.sssp_path(gs, seeds[0], ws)
    dist, prev = res.dist.cpu().numpy(), res.prev.cpu().numpy()
    pe, w_h = res.prev_edge.cpu().numpy(), ws.cpu().numpy()
    reached = np.flatnonzero(dist[:3000] < INT32_MAX)
    good = True
    for v in reached:
        path = sssp_path.get_path(prev, seeds[0], int(v))
        good &= (path[0] == seeds[0] and path[-1] == v and int(
            sum(w_h[pe[x]] for x in path[1:])) == dist[v])
    check(good and reached.size > 1,
          f"get_path N=3000 from {seeds[0]}: each of {reached.size} paths "
          f"starts at the root, ends at its target and costs dist[target]")


def sampling_phase(torch, K, dev, apps, g, g_host, small_path):
    """Phase 7, the sampling family, -GMProfile and the output path: the
    card's threefry against the CPU's over 2^24 draws; the two node
    samplings, the walk, the W-walker walks and the matching at the full
    size, each against the host's computation from the same draws or its
    invariants; the four sampling apps, -GMDumpGraph in six formats and
    -GMProfile through the CLI against the JAX CLI's goldens."""
    import hashlib
    import tempfile

    from green_marl_tpu_torch.graph import binary_io
    from green_marl_tpu_torch.models import sampling as S
    from green_marl_tpu_torch.models.pagerank import (pagerank,
                                                      pagerank_profiled)
    from green_marl_tpu_torch.ops.segment import has_edge_to
    from green_marl_tpu_torch.runtime import rng

    n, e = g.num_nodes, g.num_edges

    def timed(fn):
        """(result, CUDA-event ms, segment-reduce launches) of one call."""
        out, ms, _, launched = timed_launches(fn, K.launch_counts)
        return out, ms, launched.get("segment_reduce_sorted", 0)

    # threefry: the card's bits are the CPU's (the CPU's are JAX's: tests)
    key = rng.PRNGKey(LJ_SEED)
    t0 = time.time()
    host = rng.uniform(key, (1 << 24,))
    host_s = time.time() - t0
    got, ms, _ = timed(lambda: rng.uniform(key.to(dev), (1 << 24,)))
    same = torch.equal(got.cpu().view(torch.int32), host.view(torch.int32))
    ints = rng.randint(key.to(dev), (1 << 20,), 0, n)
    check(same and torch.equal(ints.cpu(), rng.randint(key, (1 << 20,), 0, n)),
          f"threefry on the card == on the CPU bit for bit: uniform over "
          f"2^24 draws ({ms:.2f} ms on the card, {host_s:.1f} s on the host), "
          f"randint(0, N) over 2^20")
    del host, got, ints

    # the node samplings at the full size, against the host's computation
    # from the same draws (key 0, as the CLI's)
    key = rng.PRNGKey(0)
    dice = rng.uniform(key, (g.n_pad,)).numpy()[:n]
    deg = np.diff(g_host.begin.numpy()).astype(np.float32)
    for n_s in (100, 100_000):
        got, ms, _ = timed(lambda: S.random_node_sampling(g, key, n_s))
        want = dice < np.float32(1.0) / np.float32(n_s)
        check(np.array_equal(got.cpu().numpy()[:n], want)
              and not bool(got[n:].any()),
              f"random_node_sampling n={n_s}: {int(want.sum())} nodes, == the "
              f"host's set from the same draws; {ms:.2f} ms")
        got, ms, _ = timed(lambda: S.random_degree_node_sampling(g, key, n_s))
        # the card sums E = {e} degrees in float32, exact only below 2^24:
        # nodes whose dice lies within 4 ulps of prob may fall either way
        prob = deg / np.float32(e) * np.float32(n_s)
        near = np.abs(dice - prob) <= 4 * np.spacing(prob)
        got = got.cpu().numpy()[:n]
        want = dice < prob
        off = got != want
        card_sum = float(torch.where(g.node_mask(), g.out_degree().float(),
                                     0.0).sum())
        check(not (off & ~near).any(),
              f"random_degree_node_sampling n={n_s}: {int(got.sum())} nodes, "
              f"== the host's set (exact degree sum) except {int(off.sum())} "
              f"of the {int(near.sum())} nodes within 4 ulps of prob (the "
              f"card's float32 sum {card_sum:.0f}, E = {e}); {ms:.2f} ms")
    del dice, deg, prob, near, got, want, off

    # one walker, 100,000 steps; then W walkers of 100 steps
    steps = 100_000
    t0 = time.time()
    got, ms, _ = timed(lambda: S.random_walk_with_jump(g, key, steps))
    dev_s = time.time() - t0
    t0 = time.time()
    want = S.random_walk_with_jump(g_host, key, steps)
    check(torch.equal(got.cpu(), want),
          f"random_walk_with_jump {steps} steps: {int(want.sum())} nodes "
          f"visited, == the same walk on the host ({ms:.1f} ms by CUDA events,"
          f" {dev_s:.2f} s by the host clock with its key chain; host "
          f"{time.time() - t0:.2f} s)")
    W, steps = 4096, 100
    starts = rng.pick_random_nodes(rng.PRNGKey(1), g, (W,))
    (counts, traj), ms, _ = timed(
        lambda: S.parallel_random_walks(g, key, starts, steps))
    want = S.parallel_random_walks(g_host, key, starts.cpu(), steps)
    draws = S.walk_draws(g, rng.key_chain(key, steps), W, 0.15)
    a, b = traj[:-1].reshape(-1), traj[1:].reshape(-1)
    dead = (g.begin[a.long() + 1] == g.begin[a.long()])
    jumped = draws.jump[:-1].reshape(-1) | dead
    along = has_edge_to(g, a, b)
    check(int(counts.long().sum()) == steps * W
          and bool((along | jumped).all())
          and torch.equal(traj.cpu(), want[1])
          and torch.equal(counts.cpu(), want[0]),
          f"parallel_random_walks W={W} {steps} steps: counts sum to "
          f"{steps * W}; each of {a.numel()} moves goes along an edge "
          f"({int((along & ~jumped).sum())}) or jumps ({int(jumped.sum())}); "
          f"trajectory == the host's; {ms:.1f} ms")
    del counts, traj, want, draws, a, b, dead, jumped, along

    # the matching, with the CLI's default sides: nodes with out-edges left
    left = g.out_degree() > 0
    res, ms, launches = timed(lambda: S.random_bipartite_matching(g, left))
    m = res.match[:n].long()
    ids = torch.arange(n, device=dev)
    paired = m >= 0
    u = ids[paired & left[:n]]
    t = m[u]
    src64, dst64 = g.node_idx_src[:e].long(), g.node_idx[:e].long()
    free = ~paired
    open_edges = (left[src64] & ~left[dst64] & free[src64] & free[dst64])
    check(bool((m[m[paired]] == ids[paired]).all())
          and int(paired.sum()) == 2 * res.count == 2 * u.numel()
          and bool((~left[t]).all()) and bool(has_edge_to(g, u, t).all())
          and not bool(open_edges.any())
          and launches == 2 * res.iterations,
          f"random_bipartite_matching at the full size: {res.count} pairs, "
          f"mutual, each an edge from left to right, maximal (no edge joins "
          f"two unmatched nodes of opposite sides); {res.iterations} rounds, "
          f"{launches} segment-reduce launches, {ms:.1f} ms")
    del m, ids, paired, u, t, src64, dst64, free, open_edges, left

    # -GMProfile in process at the full size: the same result and supersteps
    ref, fused_ms, _ = timed(lambda: pagerank(g))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        prof, prof_ms, _ = timed(lambda: pagerank_profiled(g))
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("superstep[")]
    step_ms = [float(re.search(r"time=(\S+) ms", ln)[1]) for ln in lines]
    check(torch.equal(prof.rank, ref.rank)
          and prof.iterations == ref.iterations == len(lines),
          f"pagerank_profiled at the full size == pagerank bit for bit, "
          f"{len(lines)} superstep lines; a superstep {np.mean(step_ms):.3f} "
          f"ms profiled (min {min(step_ms):.3f}), "
          f"{fused_ms / ref.iterations:.3f} ms in the fused run "
          f"({prof_ms:.1f} ms in all with its warm-up step, {fused_ms:.1f})")

    # the CLI on parity10k and on the 1/16-size file
    for app, gold in GOLD_SAMPLING_APPS.items():
        out = run_cli(apps, [app, "-GMDevice=cuda", FIXTURE])
        check(all(ln in out.splitlines() for ln in gold),
              f"{app} on parity10k through the CLI == the JAX CLI's {gold}")
    raw = binary_io.load_binary(FIXTURE)
    with tempfile.TemporaryDirectory() as tmp:
        ebin = os.path.join(tmp, "left.ebin")
        binary_io.store_binary(ebin, raw.begin, raw.node_idx, node_props=[
            np.arange(raw.num_nodes) % 2 == 0])
        out = run_cli(apps, ["random_bipartite_matching", "-GMDevice=cuda",
                             "-GMInputFormat=EBIN", ebin])
        check(f"matched = {GOLD_MATCHED_EVEN_LEFT}" in out.splitlines(),
              f"random_bipartite_matching with isLeft from an EBIN property "
              f"(even ids): matched = {GOLD_MATCHED_EVEN_LEFT}, the JAX CLI's")
        for fmt, gold in GOLD_DUMP_SHA256.items():
            dump = os.path.join(tmp, f"hop.{fmt}")
            run_cli(apps, ["hop_dist", "-GMDevice=cuda", "-GMDumpGraph=1",
                           f"-GMOutputFormat={fmt}", FIXTURE, dump])
            data = open(dump, "rb").read()
            if fmt == "AVRO":   # its 16-byte sync marker is random
                sync_at = data.index(b"\x00", data.index(b"avro.codec")) + 1
                data = data.replace(data[sync_at:sync_at + 16], bytes(16))
            digest = hashlib.sha256(data).hexdigest()
            check(digest == gold, f"hop_dist -GMDumpGraph=1 "
                  f"-GMOutputFormat={fmt} on parity10k: SHA-256 {digest[:16]}"
                  f"... == the JAX CLI's file")
    digest = hashlib.sha256(open(small_path, "rb").read()).hexdigest()
    check(digest == GOLD_SMALL_SHA256, f"the 1/16-size file is the one the "
          f"goldens were taken on (SHA-256 {digest[:16]}...)")
    for app, n_steps in GOLD_PROFILE_STEPS.items():
        out = run_cli(apps, [app, "-GMDevice=cuda", "-GMProfile=1",
                             small_path])
        ms = [float(x) for x in re.findall(r"^superstep\[\d+\] time=(\S+) ms",
                                           out, re.M)]
        check(len(ms) == n_steps and (app != "hop_dist" or field(
                  out, r"^CRC16 dist (\S+)") == GOLD_SMALL_HOP_CRC16),
              f"{app} -GMProfile=1 at the 1/16 size: {len(ms)} superstep "
              f"lines as the JAX CLI prints"
              + (f", CRC16 dist {GOLD_SMALL_HOP_CRC16}" if app == "hop_dist"
                 else "")
              + f"; {np.mean(ms):.3f} ms a superstep")


def triangle_phase(torch, dev, apps, native, from_edges, u_begin, u_dst,
                   src16, dst16):
    """Phase 7, second part: triangle counting."""
    from green_marl_tpu_torch.graph import generate
    from green_marl_tpu_torch.graph.csr import to_undirected
    from green_marl_tpu_torch.models import triangle
    from green_marl_tpu_torch.ops import kernels as K
    from green_marl_tpu_torch.probes.triangle import count_paths, plain_search

    # the full size: host DAG build against the card's, then the join
    # against the search
    secs = {"build_dag": [], "desc_layout": []}
    real = {k: timed_calls(native, k, v) for k, v in secs.items()}
    t0 = time.time()
    ctx = triangle.dag_to_device(
        triangle.build_dag_host(u_begin, u_dst, LJ_N), dev)
    log(f"  full size, {u_dst.shape[0]} undirected slots: host DAG build "
        f"{time.time() - t0:.1f} s (gm_build_dag, serial, "
        f"{sum(secs['build_dag']):.1f} s; the rest numpy and the upload); "
        f"D={ctx.num_dag_edges} wedges={ctx.num_wedges}")
    t0 = time.time()
    on_card = triangle.build_dag_torch(torch.from_numpy(u_begin).to(dev),
                                       torch.from_numpy(u_dst).to(dev), LJ_N)
    torch.cuda.synchronize(dev)
    secs_card = time.time() - t0
    check(all(torch.equal(getattr(on_card, f), getattr(ctx, f))
              for f in ("dag_begin", "dag_dst", "pair_cum"))
          and on_card[3:] == ctx[3:],
          f"full size: the DAG built on the card ({secs_card:.2f} s, "
          "parallel slots dropped there) == the host build, bit for bit")
    del on_card
    check(triangle.route(ctx) == "search",
          f"{ctx.num_wedges} wedges: count_dag routes to the search (the "
          "join is faster at no size measured)")
    before = K.launch_counts()["triangle_search"]
    res = count_paths(ctx, ["routed"], log=lambda m: log("  " + m))
    launches = K.launch_counts()["triangle_search"] - before
    res.update(count_paths(ctx, ["plain", "sortmerge"],
                           log=lambda m: log("  " + m)))
    record = {"launches": launches,
              "max_abs_err": float(abs(res["routed"][0] - res["plain"][0]))}
    check(res["routed"][0] == res["plain"][0] == res["sortmerge"][0] > 0
          and launches == 1,
          f"full size: count_dag (the search, {launches} triangle_search "
          f"launch) == the plain search == the sort-merge join == "
          f"{res['routed'][0]} triangles (gm_desc_layout, serial, "
          f"{sum(secs['desc_layout']):.1f} s of the join's layout)")
    check(res["routed"][1] <= res["plain"][1],
          f"full size: the search kernel no slower than its plain version "
          f"({1000 * res['routed'][1]:.1f} ms against "
          f"{1000 * res['plain'][1]:.1f} ms, CUDA events, one call each)")
    del ctx, res
    triangle._PREP_CACHE.clear()
    torch.cuda.empty_cache()

    # the 1/16 size: the card's CSR merge against the host's, then a simple
    # graph (dedup=True), where the literal form counts the same triangles
    t0 = time.time()
    g16 = from_edges(src16, dst16, SMALL_N)[0].to(dev)
    m_begin, m_dst = undirected_csr(torch, g16)
    h_begin, h_dst = native.build_csr(
        *to_undirected(src16, dst16, dedup=False), SMALL_N)[:2]
    check(np.array_equal(m_begin.cpu().numpy(), h_begin)
          and np.array_equal(m_dst.cpu().numpy(), h_dst),
          "1/16 size: the CSR merged on the card == native.build_csr of "
          "to_undirected(dedup=False)")
    del g16, m_begin, m_dst
    gu = from_edges(*to_undirected(src16, dst16, dedup=True),
                    SMALL_N)[0].to(dev)
    multi_ctx = triangle.dag_to_device(
        triangle.build_dag_host(h_begin, h_dst, SMALL_N), dev)
    multi = {"search": triangle.count_search(multi_ctx),
             "plain search": plain_search(multi_ctx),
             "sort-merge": triangle.count_sortmerge(multi_ctx)}
    check(len(set(multi.values())) == 1,
          f"1/16 size, parallel edges kept: {multi} agree")
    multi = multi["search"]
    del multi_ctx
    log(f"  1/16 size: simple undirected graph of {gu.num_edges} slots "
        f"({h_dst.shape[0]} with parallel edges) built in "
        f"{time.time() - t0:.1f} s")
    ctx = triangle.build_dag(gu)
    t0 = time.time()
    counts = {"triangle_count": triangle.triangle_count(gu),
              "search": triangle.count_search(ctx),
              "plain search": plain_search(ctx),
              "sort-merge": triangle.count_sortmerge(ctx),
              "literal": triangle.triangle_count_literal(gu),
              "search, parallel edges kept": multi}
    check(len(set(counts.values())) == 1 and multi > 0,
          f"1/16 size, dedup=True: {counts} agree "
          f"({ctx.num_wedges} DAG wedges; {time.time() - t0:.1f} s)")
    del gu, ctx
    triangle._PREP_CACHE.clear()

    src, dst = to_undirected(*generate.rmat_edges(2000, 16_000, seed=74))
    gs = from_edges(src[src != dst], dst[src != dst], 2000)[0]
    want = triangle.triangle_count_np(gs.begin.numpy(),
                                      gs.node_idx.numpy()[:gs.num_edges])
    gs = gs.to(dev)
    ctx = triangle.build_dag(gs)
    counts = {"triangle_count": triangle.triangle_count(gs),
              "search": triangle.count_search(ctx),
              "sort-merge": triangle.count_sortmerge(ctx),
              "literal": triangle.triangle_count_literal(gs)}
    check(set(counts.values()) == {want} and want > 0,
          f"2,000-node RMAT: {counts} == triangle_count_np ({want})")
    triangle._PREP_CACHE.clear()
    for k, fn in real.items():
        setattr(native, k, fn)

    out = run_cli(apps, ["triangle_counting", "-GMDevice=cuda", FIXTURE])
    check(int(field(out, r"^number of triangles: (\d+)")) == GOLD_TRIANGLES
          and field(out, r"^triangle_counting returns: (\d+)")
          == str(GOLD_TRIANGLES),
          f"triangle_counting on parity10k through the CLI: "
          f"{GOLD_TRIANGLES} triangles")
    return record


def field(out, pattern):
    return re.search(pattern, out, re.M).group(1)


def edge_layouts(tile, n_slots, rng):
    """name -> (offsets [n_seg + 1] int64, n_slots): the layouts that stress
    a kernel whose blocks own tiles of ``tile`` consecutive slots."""
    lead, trail = 3 * tile, 77
    short = rng.choice([0, 0, 1, 1, 1, 2, 3, 8, 30], size=400_000)
    fixed = [np.zeros(3000, np.int64),                  # empties at slot 0
             np.full(8, tile), [2 * tile, tile - 1, 1],  # ends on tile edges
             np.zeros(2000, np.int64),                  # empties at an edge
             short]
    used = lead + trail + int(sum(int(np.sum(f)) for f in fixed))
    lens = np.concatenate(fixed + [[n_slots - used],     # a hub of the rest
                                   np.zeros(1500, np.int64)])  # at the end
    off = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return {"tile edges, empty runs, offsets[0] > 0, a hub":
            (off + lead, n_slots),
            "one segment over every slot":
            (np.array([0, n_slots], np.int64), n_slots)}


def check_edge_layouts(torch, K, tile, dev):
    """Phase 2's second part: the segment reduce and the segmented scan
    against their plain versions on ``edge_layouts`` at the LJ edge count,
    in all six op/dtype pairs, and 20 repeated launches."""
    rng = np.random.default_rng(1)
    for name, (off_np, n) in edge_layouts(tile, LJ_E, rng).items():
        offsets = torch.from_numpy(off_np.astype(np.int32)).to(dev)
        n_seg = off_np.size - 1
        n_out = n_seg + 300                           # rows past N: identity
        lens = torch.from_numpy(np.diff(off_np)).to(dev)
        ids = torch.cat([
            torch.full((int(off_np[0]),), -1, dtype=torch.int32, device=dev),
            torch.repeat_interleave(
                torch.arange(n_seg, dtype=torch.int32, device=dev), lens,
                output_size=int(off_np[-1] - off_np[0])),
            torch.full((n - int(off_np[-1]),), n_seg, dtype=torch.int32,
                       device=dev)])
        log(f"  layout: {name}: {n_seg} segments, {n} slots, "
            f"offsets[0]={int(off_np[0])}, longest {int(lens.max())}")
        for dtype in (torch.int32, torch.float32):
            if dtype == torch.int32:
                vals = torch.from_numpy(rng.integers(
                    -(1 << 30), 1 << 30, n).astype(np.int32)).to(dev)
            else:
                vals = torch.from_numpy(rng.random(n, np.float32)).to(dev)
            for op in K.OPS:
                got = K.segment_reduce_sorted(vals, ids, offsets, n_out, op)
                scan = K.segmented_scan(vals, ids, op)
                torch.cuda.synchronize()
                if dtype == torch.float32 and op == "add":
                    want = K.segment_reduce_sorted_ref(
                        vals.double(), ids, offsets, n_out, op)
                    ok = torch.allclose(got.double(), want, rtol=1e-5,
                                        atol=0.0)
                    exact = K.segmented_scan_ref(vals.double(), ids, op)
                    # values >= 0: the exact scan is the scan of |v|
                    ok_scan = bool(((scan.double() - exact).abs()
                                    <= 1e-5 * exact).all())
                    how = "within rtol 1e-5 of float64"
                    del exact
                else:
                    ok = torch.equal(got, K.segment_reduce_sorted_ref(
                        vals, ids, offsets, n_out, op))
                    ok_scan = torch.equal(scan, K.segmented_scan_ref(
                        vals, ids, op))
                    how = "exact"
                check(ok and ok_scan, f"{name}: segment_reduce_sorted and "
                      f"segmented_scan {op} {str(dtype)[6:]} {how}")
                if op != "add":
                    continue
                same = all(torch.equal(K.segment_reduce_sorted(
                    vals, ids, offsets, n_out, op), got) for _ in range(20))
                same_scan = dtype == torch.float32 or all(
                    torch.equal(K.segmented_scan(vals, ids, op), scan)
                    for _ in range(20))
                check(same and same_scan, f"{name}: 20 more launches, "
                      f"add {str(dtype)[6:]}: segment_reduce_sorted gives "
                      f"the same bits" + ("" if dtype == torch.float32 else
                                          ", segmented_scan too"))
            del vals, got, scan
        del ids, offsets, lens


def check_gather_designs(torch, K, dev):
    """Phase 7's first part: the row gather and the take-along gather against
    their plain versions (exact) on the inputs that stress a binned row
    order and column slabs; logs the route each take-along shape takes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    n_rows, n_ids = 1 << 20, 1 << 21

    def ids(lo, hi):
        return torch.randint(lo, hi, (n_ids,), generator=gen, device=dev,
                             dtype=torch.int32)

    table = torch.randint(-(1 << 30), 1 << 30, (n_rows, K.LANES),
                          generator=gen, device=dev, dtype=torch.int32)
    cases = {
        "duplicate-heavy (4096 rows, 512 requests each)": ids(0, 4096) * 251,
        "out of range on both sides (clipped)": ids(-n_rows, 2 * n_rows),
        "all ids equal": ids(77, 78),
        "ids already sorted": ids(0, n_rows).sort().values,
    }
    for name, idx in cases.items():
        for sweeps, k in ((1, 2), (1, 8), (3, 4)):
            got = K.row_gather_checksum(table, idx, sweeps, k)
            want = K.row_gather_checksum_ref(table, idx, sweeps)
            torch.cuda.synchronize()
            check(int(got) == int(want), f"row_gather_checksum 512 B rows, "
                  f"2^21 ids, {name}, sweeps={sweeps} k={k}: == plain "
                  f"({int(got)})")
    del table, cases
    R = 1 << 17
    for th, window in ((4096, True), (1024, False), (4096, False),
                       (16384, False)):
        bh = 256 if window else th
        table = torch.rand((th if window else R, K.LANES), generator=gen,
                           device=dev)
        for split in (False, True):
            lo, hi = (-999, th * K.LANES + 999) if split else (-3, th + 5)
            idx = torch.randint(lo, hi, (R, K.LANES), generator=gen,
                                device=dev, dtype=torch.int32)
            for mode in ("axis0", "composed"):
                got = K.take_along_blocks(table, idx, mode, bh, th, window,
                                          split)
                want = K.take_along_blocks_ref(table, idx, mode, bh, th,
                                               window, split)
                torch.cuda.synchronize()
                route = K.take_along_route(th, mode)
                if route == "slab":
                    route += f" of {K.take_along_slab_cols(th)} columns"
                check(torch.equal(got, want), f"take_along_blocks {mode} "
                      f"{'2 MB window' if window else f'[{th},128] blocks'}"
                      f"{', split indices' if split else ''}, indices past "
                      f"both ends: == plain (route: {route})")
        del table, idx, got, want


# -- phase 9: compiled .gm programs ------------------------------------------
# The inline texts of tests/test_lower.py:27-70
PAGERANK_GM = """
Procedure pagerank(G: Graph, e,d: Double, max: Int;
                   pg_rank: Node_Prop<Double>)
{
    Double diff;
    Int cnt = 0;
    Double N = G.NumNodes();
    G.pg_rank = 1 / N;
    Do {
        diff = 0.0;
        Foreach (t: G.Nodes) {
            Double val = (1-d) / N + d*
                Sum(w: t.InNbrs) { w.pg_rank / w.OutDegree() };
            diff += | val - t.pg_rank |;
            t.pg_rank <= val @ t;
        }
        cnt++;
    } While ((diff > e) && (cnt < max));
}
"""

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

# phase 10: the other programs of the CLI's compiled placements and the
# integer pull-count program (tests/test_torch_lower.py, and the reference's
# avg_teen_cnt.gm)
SSSP_GM = """
Procedure sssp(G:Graph, dist:N_P<Int>, len:E_P<Int>, root: Node)
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
                Edge e = s.ToEdge();
                <s.dist_nxt; s.updated_nxt> min= <n.dist + e.len; True>;
            }
        }
        G.dist = G.dist_nxt;
        G.updated = G.updated_nxt;
        G.updated_nxt = False;
        fin = ! Exist(n: G.Nodes){n.updated};
    }
}
"""

AVG_TEEN_CNT_GM = """
Procedure avg_teen_cnt(G: Graph, age, teen_cnt: N_P<Int>, K: Int) : Float {
    Foreach(n: G.Nodes) {
        n.teen_cnt = Count(t: n.InNbrs)(t.age >= 10 && t.age < 20);
    }
    Float avg = (Float) Avg(n: G.Nodes)(n.age > K){ n.teen_cnt };
    Return avg;
}
"""

# phase 11: the graph of scripts/probe_vsharded_scale.py:50-53, N = 2^25,
# with E cut from 250M to 120M: the serial native generator and CSR build
# take 205 s and 82 s at 250M, more than phases 1-10 together
# (``python -m green_marl_tpu_torch.probes.scale`` runs the full size)
SCALE_N, SCALE_E, SCALE_B = 1 << 25, 120_000_000, 256

# phase 12: compiled programs in lockstep (CompiledProc.batch) at the
# LiveJournal scale, BATCH_B lanes each: pagerank.gm over damping values,
# hop_dist.gm and sssp.gm over roots, and avg_teen_cnt.gm with its band's
# lower bound as an argument, over bounds
BATCH_B = 16
BAND_CNT_GM = """
Procedure band_cnt(G: Graph, age, teen_cnt: N_P<Int>, lo: Int,
                   K: Int) : Float {
    Foreach(n: G.Nodes) {
        n.teen_cnt = Count(t: n.InNbrs)(t.age >= lo && t.age < lo + 10);
    }
    Float avg = (Float) Avg(n: G.Nodes)(n.age > K){ n.teen_cnt };
    Return avg;
}
"""
LANE_KERNELS = ("segment_reduce_sorted", "plain_cumsum")


@contextlib.contextmanager
def first_lane_calls(K):
    """Record the first lane-batched call of each lane kernel's wrapper
    while the block runs: name -> (a clone of its [B, E] values, the other
    arguments, the keywords)."""
    seen = {}
    reals = {name: getattr(K, name) for name in LANE_KERNELS}

    def recorder(name, real):
        def call(vals, *args, **kw):
            if vals.dim() == 2 and name not in seen:
                seen[name] = (vals.clone(), args, kw)
            return real(vals, *args, **kw)
        return call

    for name, real in reals.items():
        setattr(K, name, recorder(name, real))
    try:
        yield seen
    finally:
        for name, real in reals.items():
            setattr(K, name, real)


def lane_kernel_checks(torch, K, inputs, b):
    """Each lane-batched kernel against its plain version on the [B, E]
    values a batched program gave it, every lane against the 1-D kernel on
    its row, and no slower than its plain version.  Returns name -> its
    largest difference from the plain version."""
    errs = {}
    prog, v2, args, kw = inputs["segment_reduce_sorted"]
    ids, offs, n_out = args
    op = kw.get("op", "add")
    got = K.segment_reduce_sorted(v2, ids, offs, n_out, op)
    want = K.segment_reduce_sorted_ref(v2, ids, offs, n_out, op)
    rows_equal = all(torch.equal(got[r], K.segment_reduce_sorted(
        v2[r].contiguous(), ids, offs, n_out, op)) for r in range(b))
    err = float((got - want).abs().max())
    check(rows_equal and torch.allclose(got, want, rtol=1e-5, atol=0.0),
          f"segment_reduce_sorted[lanes] {v2.dtype} {op} on {prog}'s "
          f"{list(v2.shape)} values: each lane the bits of the 1-D kernel "
          f"on its row; within rtol 1e-5 of plain (max abs err {err:.3g})")
    del got, want
    errs["segment_reduce_sorted[lanes]"] = err
    ms = {"segment_reduce_sorted[lanes]": (
        mean_ms(lambda: K.segment_reduce_sorted(v2, ids, offs, n_out, op)),
        mean_ms(lambda: K.segment_reduce_sorted_ref(v2, ids, offs, n_out,
                                                    op), 3))}
    del v2
    prog, v2, args, kw = inputs["plain_cumsum"]
    excl = bool(kw.get("exclusive", False))
    got = K.plain_cumsum(v2, exclusive=excl)
    rows_equal = all(torch.equal(got[r], K.plain_cumsum(
        v2[r].contiguous(), exclusive=excl)) for r in range(b))
    check(rows_equal and torch.equal(got, K.plain_cumsum_ref(
        v2, exclusive=excl)), f"plain_cumsum[lanes] {v2.dtype} "
          f"exclusive={excl} on {prog}'s {list(v2.shape)} values == plain "
          "and each lane == the 1-D kernel, bit for bit")
    del got
    errs["plain_cumsum[lanes]"] = 0.0
    ms["plain_cumsum[lanes]"] = (
        mean_ms(lambda: K.plain_cumsum(v2, exclusive=excl)),
        mean_ms(lambda: K.plain_cumsum_ref(v2, exclusive=excl)))
    del v2
    for name, (kernel, plain) in ms.items():
        check(kernel <= plain, f"{name} at [{b}, E] no slower than its "
              f"plain version ({kernel:.3f} <= {plain:.3f} ms)")
    return errs


def batch_phase(torch, K, dev, g_host, smi):
    """Phase 12: compiled programs in lockstep at the full size, BATCH_B
    lanes each.  Each batched run on its own: its launches (the lane
    kernels' too), time and device peak; each lane against its own single
    run (integers bit for bit, floats within rtol 1e-6, their differing
    values counted); the pulls of pagerank.gm == its slowest lane's
    iterations.  Then each lane kernel against its plain version on the
    values a batched run gave it.  Returns (launches by name, records)."""
    import warnings

    from green_marl_tpu_torch.lang.lower import compile_source
    from green_marl_tpu_torch.utils.gm_rand import sssp_edge_lengths

    def quiet(text):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return compile_source(text)

    def counts():
        return {**K.launch_counts(), **K.lane_launch_counts()}

    def timed(fn):
        """(result, CUDA-event ms, host ms, launches by name)."""
        return timed_launches(fn, counts)

    b = BATCH_B
    g = g_host.to(dev)
    n = g.num_nodes
    deg = np.diff(g_host.begin.numpy()[: n + 1])
    roots = np.argsort(deg)[::-1][:b].astype(np.int32)  # as bench.py:431
    w_np = np.zeros(g.e_pad, np.int32)
    w_np[: g.num_edges] = sssp_edge_lengths(g.num_edges)
    age = torch.from_numpy(np.random.default_rng(LJ_SEED).integers(
        0, 90, g.n_pad).astype(np.int32)).to(dev)
    programs = (
        ("pagerank.gm", PAGERANK_GM, "d",
         np.linspace(0.70, 0.92, b).astype(np.float32),
         dict(e=1e-7, max=100)),
        ("hop_dist.gm", HOP_DIST_GM, "root", roots, {}),
        ("sssp.gm", SSSP_GM, "root", roots,
         {"len": torch.from_numpy(w_np).to(dev)}),
        ("band_cnt.gm", BAND_CNT_GM, "lo",
         np.arange(0, 5 * b, 5, dtype=np.int32), {"age": age, "K": 15}))
    log(f"  {b} lanes; roots (highest out-degree first) {roots.tolist()}")
    total = {k: 0 for k in counts()}
    inputs = {}
    for name, text, arg, vals, fixed in programs:
        cp = quiet(text)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with first_lane_calls(K) as seen:
            out, ms, host, launched = timed(
                lambda: cp.batch(g, over={arg: vals}, **fixed))
        peak = torch.cuda.max_memory_allocated()
        for k, v in launched.items():
            total[k] += v
        for k, v in seen.items():
            inputs.setdefault(k, (name,) + v)
        del seen
        # the same batched run again, warm (the first one takes the
        # allocator's growth and the first launches)
        _, warm_ms, warm_host, _ = timed(
            lambda: cp.batch(g, over={arg: vals}, **fixed))
        one_ms = one_host = 0.0
        iters, ok, differ = [], True, {}
        for i in range(b):
            lane = vals[i].item()
            one, ms_i, host_i, launched_i = timed(
                lambda: cp(g, **{arg: lane}, **fixed))
            one_ms += ms_i
            one_host += host_i
            iters.append(launched_i.get("segment_reduce_sorted", 0))
            for k, v in one.items():
                got = out[k][i]
                ok &= got.shape == v.shape and got.dtype == v.dtype
                if v.dtype.is_floating_point:
                    differ[k] = differ.get(k, 0) + int((got != v).sum())
                    ok &= bool(torch.isfinite(got).all()) and \
                        torch.allclose(got, v, rtol=1e-6, atol=0.0)
                else:
                    ok &= torch.equal(got, v)
            del one
        check(ok and all(v.shape[0] == b for v in out.values()),
              f"{name} batched over {b} values of {arg} at N={n} E="
              f"{g.num_edges}: each lane == its single run (integers bit "
              f"for bit, floats within rtol 1e-6; float values that differ "
              f"in bits: {differ or 'none'}); batched {ms:.1f} ms CUDA "
              f"events, {host:.1f} ms host (again, warm: {warm_ms:.1f} ms, "
              f"{warm_host:.1f} ms host); {b} single runs {one_ms:.1f} "
              f"ms, {one_host:.1f} ms host ({one_ms / warm_ms:.2f}x the "
              f"warm batched run); device "
              f"peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB "
              f"above the {base / 1e9:.2f} GB before); launches {launched} "
              f"(card: {smi})")
        pulls = launched.get("segment_reduce_sorted", 0) + \
            launched.get("segment_reduce_sorted[lanes]", 0)
        if name == "pagerank.gm":
            check(pulls == max(iters) and
                  launched.get("segment_reduce_sorted[lanes]", 0) > 0,
                  f"pagerank.gm batched: {pulls} segment reduces (lanes "
                  f"{launched.get('segment_reduce_sorted[lanes]', 0)}) == "
                  f"its slowest lane's {max(iters)} iterations, not their "
                  f"sum {sum(iters)} (lanes: {iters})")
        elif name == "band_cnt.gm":
            check(launched.get("plain_cumsum[lanes]", 0) == 1,
                  "band_cnt.gm batched: one lane-batched prefix sum for "
                  f"its lane-dependent Count (launches {launched})")
        del out
        if name in ("pagerank.gm", "hop_dist.gm"):
            profile_one(torch, f"{name} batched, {b} lanes", lambda: cp.batch(
                g, over={arg: vals}, **fixed))
    del g
    torch.cuda.empty_cache()
    return total, lane_kernel_checks(torch, K, inputs, b)


SHARDS = 4                # phase 10: shards of one program on the card
MULTI_BFS_B = 64          # phase 10: instances of the sharded bit BFS

# the small programs of phase 9, run on parity10k: name -> (text, kwargs)
# the small programs of phase 9: name -> (text, kwargs, graph), the graph
# parity10k (None) or the RMAT (N, E, seed) of generate.rmat_edges; the DFS
# runs one device round trip a statement, so it takes a small graph
DFS_GRAPH = (2000, 16000, 7)
SMALL_PROGRAMS = {
    # CommonNbrs, the adamicAdar kind (tests/test_lower_maps.py:215)
    "common_nbrs": ("""
Procedure aa(G: Graph; aa: E_P<Double>) {
    Foreach(e: G.Edges) {
        Node from = e.FromNode();
        Node to = e.ToNode();
        e.aa = Sum(n: from.CommonNbrs(to)) { 1.0 };
    }
}""", {}, None),
    "adamic_adar": ("""
Procedure adamicAdar(G: Graph; aa: E_P<Double>) {
    Foreach(e: G.Edges) {
        Node from = e.FromNode();
        Node to = e.ToNode();
        e.aa = Sum(n: from.CommonNbrs(to))(n.NumNbrs() > 1) {
            1 / Log(n.NumNbrs()) };
    }
}""", {}, None),
    # InBFS with a navigator and InReverse, and a DFS: the b2 kind
    "inbfs": ("""
Proc bfsnav(G: Graph, root: Node, ok: N_P<Bool>;
            lev: N_P<Int>, sigma: N_P<Float>, delta: N_P<Float>) {
    G.lev = -1;
    G.sigma = 0;
    root.sigma = 1;
    InBFS(v: G.Nodes From root)[v.ok](v != root) {
        v.sigma = Sum(w: v.UpNbrs){ w.sigma };
        v.lev = Count(w: v.UpNbrs);
    } InReverse(v != root) {
        v.delta = Sum(w: v.DownNbrs){ w.delta + w.sigma };
    }
}""", {"root": 0, "ok": "mod7"}, None),
    "dfs": ("""
Proc dfs(G: Graph, s: Node; A: N_P<Int>, B: N_P<Int>) {
    Int t = 0;
    G.A = -1;
    G.B = -1;
    InDFS(v: G.Nodes From s)[v != s + 7] {
        v.A = t;
        t++;
    } InPost {
        v.B = t;
        t++;
    }
}""", {"s": 0}, DFS_GRAPH),
    # Uniform() draws in a traced While, in both branches of a traced If
    "uniform": ("""
Proc wdraw(G: Graph; P: N_P<Double>) : Double {
    Int i = 0;
    Double acc = 0.0;
    While (i < 5) {
        If (acc < 1.5) { acc += Uniform(); } Else { acc = acc - Uniform(); }
        Foreach(v: G.Nodes) { v.P += Uniform(); }
        i++;
    }
    Return acc + Uniform();
}""", {}, None),
    # one [ C++ ] escape, built by g++ on the card's host
    "foreign": ("""
Procedure Q(G: Graph, A: N_P<Int>; B: N_P<Int>, total: Double) {
    total = 0.0;
    Foreach (t: G.Nodes) {
        [$t.B = $t.A * 2 + 1] ::[t.B];
        [$total += (double)$t.A] ::[total];
    }
}""", {"A": "mod17"}, None),
}

DIJKSTRA_GM = """
Procedure dijk(G: Graph, Len: E_P<Int>, src, dst: Node;
               Parent: N_P<Node>) : Int {
    N_P<Bool> Settled;
    Map<Node, Int> M;
    G.Settled = False;
    G.Parent = NIL;
    Bool failed = False;
    Bool found = False;
    M[src] = 0;
    While (!failed && !found) {
        If (M.Size() == 0) { failed = True; }
        Else {
            Node next = M.GetMinKey();
            If (next == dst) { found = True; }
            Else {
                next.Settled = True;
                Int dist = M[next];
                M.Remove(next);
                For (v: next.Nbrs)(!v.Settled) {
                    Edge e = v.ToEdge();
                    If (!M.HasKey(v)) {
                        M[v] = dist + e.Len;
                        v.Parent = next;
                    } Else If (M[v] > dist + e.Len) {
                        M[v] = dist + e.Len;
                        v.Parent = next;
                    }
                }
            }
        }
    }
    If (found) { Return M[dst]; }
    Return -1;
}
"""

# the JAX package's compile_source on the CPU on each program's graph,
# recorded by small_program_record (sums within rtol 1e-5, the rest exactly)
GOLD_COMPILED = {
    "common_nbrs": {"aa": "0xe8fef3bb"},
    "adamic_adar": {"aa": ["sum", 343.257405847311]},
    "inbfs": {"delta": "0x191dda31", "lev": "0x02ff05c1",
              "sigma": "0x3509a28a"},
    "dfs": {"A": "0x1c19f280", "B": "0x4c8c8aee"},
    "uniform": {"P": "0x3afcf619", "_return": "1.2832911014556885"},
    "foreign": {"B": "0x49c98e49", "total": "79998.0"},
}
# local_clustering.gm through the JAX CLI on parity10k
GOLD_LOCAL_CLUSTERING = ["C[0] = 0.000000000", "C[1] = 0.000000000",
                         "C[2] = 0.000000000", "C[3] = 0.000000000",
                         "CRC C 0x2acd6949", "CRC16 C 0x6a79"]
# SHA-256 of JAX gmc's stdout for HOP_DIST_GM in a file, -DS=2 -Dr
GOLD_GMC_SHA256 = \
    "b5eaae06311b6de16f97c0a38a98e16e7f0f78b4f6f26c77d310271cd7ed6b04"


def small_graph(spec):
    """The RMAT graph ``(N, E, seed)`` of ``generate.rmat_edges`` on the
    host."""
    from green_marl_tpu_torch.graph import generate
    from green_marl_tpu_torch.graph.csr import from_edges
    n, e, seed = spec
    return from_edges(*generate.rmat_edges(n, e, seed=seed), n)[0]


def small_program_args(torch, g, kw):
    """The keyword arguments of a small program on ``g``."""
    out = {}
    for k, v in kw.items():
        if v == "mod7":
            v = torch.arange(g.n_pad, device=g.device) % 7 != 3
        elif v == "mod17":
            v = (torch.arange(g.n_pad, device=g.device) * 5 % 17).to(
                torch.int32)
        out[k] = v
    return out


# outputs whose float sums the card adds in another order than the CPU
SUMMED = {("adamic_adar", "aa")}


def small_program_record(name, out, g):
    """Output name -> the CRC-32 of its first N (or E) values, or
    ``["sum", x]`` for the outputs in ``SUMMED``; a scalar as printed."""
    from green_marl_tpu_torch.utils.crc import array_checksum_hex
    rec = {}
    for k, v in sorted(out.items()):
        a = v.cpu().numpy()
        if a.ndim == 0:
            rec[k] = repr(a.item())
            continue
        a = a[: g.num_edges if a.shape[0] == g.e_pad else g.num_nodes]
        if (name, k) in SUMMED:
            rec[k] = ["sum", float(a.astype(np.float64).sum())]
        else:
            rec[k] = array_checksum_hex(a)
    return rec


def profile_one(torch, label, fn):
    """Device time by kernel group (``probes.profile_apps``) of one run of
    ``fn`` under ``torch.profiler``, beside the host clock of the run (the
    device's idle share: 1 - device / host)."""
    from green_marl_tpu_torch.probes.profile_apps import (
        by_group, device_times, shared_kernel_by_op)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.time() - t0)
    times = device_times(prof)
    groups = by_group(times, shared_kernel_by_op(prof))
    dev_ms = sum(times.values())
    log(f"  {label} under torch.profiler: device {dev_ms:.2f} ms, host "
        f"{host:.2f} ms ({1 - dev_ms / host:.0%} idle); by group (ms) "
        + json.dumps({k: round(v, 3) for k, v in groups.items()}))


def profile_pair(torch, name, model, compiled):
    """``profile_one`` of one run of the hand-written model and one of the
    compiled program, after the timed runs."""
    for label, fn in (("model", model), ("compiled", compiled)):
        profile_one(torch, f"{name} {label}", fn)


def compiled_phase(torch, K, dev, apps, g_host, roots, smi):
    """Phase 9: compiled .gm programs through the port's lowerer.  At the
    full size, the compiled pagerank and hop_dist against the hand-written
    models; on parity10k, the small programs against the JAX package's
    goldens (the DFS on a 2,000-node RMAT), local_clustering.gm through
    the CLI (make_custom), a pop-min Dijkstra against dijkstra_host_exact
    and gmc.  Returns the launches by name."""
    import hashlib
    import tempfile
    import warnings

    from green_marl_tpu_torch.cli import gmc
    from green_marl_tpu_torch.graph import binary_io
    from green_marl_tpu_torch.lang.lower import compile_source
    from green_marl_tpu_torch.models import sssp as sssp_mod
    from green_marl_tpu_torch.models.hop_dist import hop_dist
    from green_marl_tpu_torch.models.pagerank import pagerank
    from green_marl_tpu_torch.utils.gm_rand import sssp_edge_lengths

    def quiet(text):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return compile_source(text)

    def timed(fn):
        """(result, CUDA-event ms, host ms, launches by name)."""
        return timed_launches(fn, K.launch_counts)

    total = {name: 0 for name in K.launch_counts()}

    def add(launched):
        for name, n in launched.items():
            total[name] += n

    g = g_host.to(dev)
    n = g.num_nodes
    pr, hd = quiet(PAGERANK_GM), quiet(HOP_DIST_GM)
    ref, ref_ms, ref_host, _ = timed(lambda: pagerank(
        g, e=1e-7, d=0.85, max_iter=100))
    out, ms, host, launched = timed(lambda: pr(g, e=1e-7, d=0.85,
                                               max=100)["pg_rank"])
    add(launched)
    err = float((out[:n] - ref.rank[:n]).abs().max())
    iters = launched.get("segment_reduce_sorted", 0)
    check(torch.allclose(out[:n], ref.rank[:n], rtol=1e-4, atol=0.0)
          and bool(torch.isfinite(out).all()) and iters > 0,
          f"compiled pagerank e=1e-7 d=0.85 max=100 at N={n} E="
          f"{g.num_edges}: within rtol 1e-4 of pagerank (max abs err "
          f"{err:.3g}); {iters} iterations (one segment-reduce launch "
          f"each; pagerank {ref.iterations}); compiled {ms:.1f} ms CUDA "
          f"events, {host:.1f} ms host; pagerank {ref_ms:.1f} ms, "
          f"{ref_host:.1f} ms host; launches {launched} (card: {smi})")
    del out, ref
    profile_pair(torch, "pagerank", lambda: pagerank(
        g, e=1e-7, d=0.85, max_iter=100), lambda: pr(g, e=1e-7, d=0.85,
                                                     max=100))
    profile_pair(torch, "hop_dist", lambda: hop_dist(g, roots[0]),
                 lambda: hd(g, root=roots[0]))
    for r in roots:
        ref, ref_ms, ref_host, _ = timed(lambda: hop_dist(g, r).dist)
        out, ms, host, launched = timed(lambda: hd(g, root=r)["dist"])
        add(launched)
        check(torch.equal(out[:n], ref[:n]),
              f"compiled hop_dist from root {r} == hop_dist bit for bit; "
              f"compiled {ms:.1f} ms CUDA events, {host:.1f} ms host; "
              f"hop_dist {ref_ms:.1f} ms, {ref_host:.1f} ms host; "
              f"launches {launched}")
    del g, out, ref
    torch.cuda.empty_cache()

    # parity10k: the small programs against the JAX package's goldens
    g10 = binary_io.load_graph(FIXTURE)[0].to(dev)
    for name, (text, kw, graph) in SMALL_PROGRAMS.items():
        cp = quiet(text)
        gp = g10 if graph is None else small_graph(graph).to(dev)
        out, ms, host, launched = timed(
            lambda: cp(gp, **small_program_args(torch, gp, kw)))
        add(launched)
        rec = small_program_record(name, out, gp)
        gold = GOLD_COMPILED[name]
        ok = set(rec) == set(gold)
        for k in gold if ok else ():
            if isinstance(gold[k], list):
                ok &= abs(
                    rec[k][1] - gold[k][1]) <= 1e-5 * abs(gold[k][1])
            else:
                ok &= rec[k] == gold[k]
        where = "parity10k" if graph is None else f"RMAT {graph}"
        check(ok, f"compiled {name} on {where} == the JAX package's "
              f"{gold} (got {rec}; {ms:.1f} ms, launches {launched})")
    w = np.zeros(g10.e_pad, np.int32)
    w[: g10.num_edges] = sssp_edge_lengths(g10.num_edges)
    w = torch.from_numpy(w).to(dev)
    dj = quiet(DIJKSTRA_GM)
    for dest in (1, 77, 9999):
        out, ms, host, launched = timed(
            lambda: dj(g10, Len=w, src=0, dst=dest))
        add(launched)
        found, _, _, dd = sssp_mod.dijkstra_host_exact(g10, w, 0, dest)
        check(found and int(out["_return"]) == dd,
              f"compiled pop-min Dijkstra (try_priority_while) on parity10k "
              f"0 -> {dest}: {int(out['_return'])} == dijkstra_host_exact's "
              f"{dd} ({ms:.1f} ms)")
    gm = os.path.join(ROOT, "doc", "examples", "local_clustering.gm")
    before = K.launch_counts()
    lines = run_cli(apps, [gm, "-GMDevice=cuda", FIXTURE]).splitlines()
    add(launched_since(K, before))
    check(all(ln in lines for ln in GOLD_LOCAL_CLUSTERING),
          f"local_clustering.gm through the CLI (make_custom) on parity10k "
          f"== the JAX CLI's {GOLD_LOCAL_CLUSTERING}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hop_dist.gm")
        with open(path, "w") as f:
            f.write(HOP_DIST_GM)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gmc.main([path, "-DS=2", "-Dr"])
    sha = hashlib.sha256(buf.getvalue().encode()).hexdigest()
    check(rc == 0 and sha == GOLD_GMC_SHA256,
          f"gmc -DS=2 -Dr on hop_dist.gm: rc 0, stdout SHA-256 {sha[:16]}.. "
          "== JAX gmc's")
    return total


def shard_bytes(obj, fields, shards):
    """Bytes one shard holds of ``obj``'s [S, ...] arrays."""
    return sum(getattr(obj, f).numel() // shards
               * getattr(obj, f).element_size() for f in fields)


def check_shard_slabs(torch, K, dev, vsg_h, sched_h, g, age):
    """Each kernel of the sharded path against its plain version on one
    shard's real inputs: the engine's slab (shard 0: ``dst_local``,
    ``dst_off``, out [L]), the compiled schedule's (shard 0: ``dst_lpos``,
    ``csc_off``, out [L+1]) and the replicate placement's (shard 1: the
    padded CSC slab and its clipped ``csc_offsets()``, millions of empty
    rows at slot 0 and at E_s, out [n_pad]); float add within rtol 1e-5 of
    the float64 sum, int32 min and max exactly; the prefix sum on shard 0's
    integer Count input (avg_teen_cnt's in-neighbour filter) exactly.
    """
    from green_marl_tpu_torch.lang.distribute import (_EDGE_FIELDS,
                                                      pad_edges_for)

    gp = pad_edges_for(g, SHARDS)
    e_s = gp.e_pad // SHARDS
    # shard 1's view, as run_sharded gives it to the lowerer
    gl = dataclasses.replace(gp, e_base=e_s, **{
        f: getattr(gp, f)[e_s:2 * e_s] for f in _EDGE_FIELDS})
    slabs = (
        ("engine shard 0", vsg_h.dst_local[0].to(dev),
         vsg_h.dst_off[0].to(dev), vsg_h.L),
        ("schedule shard 0", sched_h.dst_lpos[0].to(dev),
         sched_h.csc_off[0].to(dev), sched_h.L + 1),
        ("replicate shard 1", gl.r_node_idx_dst, gl.csc_offsets(),
         gl.n_pad))
    gen = torch.Generator(device=dev).manual_seed(LJ_SEED)
    for what, ids, off, n_out in slabs:
        e = ids.numel()
        empty = int((off.diff() == 0).sum())
        vals = torch.rand(e, generator=gen, device=dev)
        got = K.segment_reduce_sorted(vals, ids, off, n_out, op="add")
        want = K.segment_reduce_sorted_ref(vals.double(), ids, off, n_out,
                                           "add")
        err = float((got.double() - want).abs().max())
        ok = torch.allclose(got.double(), want, rtol=1e-5, atol=0.0)
        ivals = torch.randint(-2**30, 2**30, (e,), generator=gen,
                              device=dev, dtype=torch.int32)
        for op in ("min", "max"):
            ok = ok and torch.equal(
                K.segment_reduce_sorted(ivals, ids, off, n_out, op=op),
                K.segment_reduce_sorted_ref(ivals, ids, off, n_out, op))
        ms = mean_ms(lambda: K.segment_reduce_sorted(
            vals, ids, off, n_out, op="add"))
        plain = mean_ms(lambda: K.segment_reduce_sorted_ref(
            vals, ids, off, n_out, "add"))
        check(ok and ms <= plain,
              f"segment_reduce_sorted on the {what} slab (E_s={e}, "
              f"{off.numel() - 1} rows, {empty} empty): float32 add within "
              f"rtol 1e-5 of float64 (max abs err {err:.3g}), int32 min "
              f"and max exactly; add: kernel {ms:.3f} ms <= plain "
              f"{plain:.3f} ms")
    t = 0
    a = age.index_select(0, sched_h.src_gid[t].to(dev).long())
    cnt = (sched_h.emask[t].to(dev) & (a >= 10) & (a < 20)).to(torch.int32)
    got = K.plain_cumsum(cnt, exclusive=True)
    want = K.plain_cumsum_ref(cnt, exclusive=True)
    check(torch.equal(got, want),
          f"plain_cumsum exclusive on schedule shard {t}'s integer Count "
          f"input (E_s={cnt.numel()}, {int(want[-1])} ones) == plain "
          f"exactly")


def nccl_one_rank(torch, K, dev, vsg_h, root, threads, sharded, seg):
    """The multi-process path (``parallel.multihost``) on NCCL with one
    rank that runs SHARDS shards on the card: pagerank_vsharded and
    hop_dist_vsharded from ``root`` against the same runs as threads of
    one process (``threads``), integers bit for bit, ranks within rtol
    1e-5; the collectives go through ``torch.distributed``."""
    import socket

    import torch.distributed as dist

    from green_marl_tpu_torch.parallel import comm, multihost as mh
    from green_marl_tpu_torch.parallel import vertex_sharded as V

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mh.init(f"localhost:{port}", 1, 0,
            local_device_ids=[dev.index or 0] * SHARDS)
    try:
        # NCCL sets its communicator up at the first collective: not a run's
        dist.barrier(device_ids=[dev.index or 0])
        mesh = mh.global_mesh()
        vsg = mh.place_multihost(vsg_h, mesh)
        comm.reset_counts()
        (rank, _, it), pr_ms, pr_launched = sharded(
            lambda: V.pagerank_vsharded(vsg, mesh))
        (dist, depth), hd_ms, hd_launched = sharded(
            lambda: V.hop_dist_vsharded(vsg, mesh, root))
        colls = dict(comm.COUNTS)
    finally:
        mh.shutdown()
    err = float((rank - threads["rank"]).abs().max())
    check(it == threads["iterations"]
          and torch.allclose(rank, threads["rank"], rtol=1e-5, atol=0.0)
          and seg(pr_launched) == SHARDS * it,
          f"pagerank_vsharded on NCCL, one rank of {SHARDS} shards: {it} "
          f"supersteps and ranks within rtol 1e-5 of the {SHARDS} threads' "
          f"(max abs err {err:.3g}), {seg(pr_launched)} segment-reduce "
          f"launches; {pr_ms:.1f} ms")
    check(depth == threads["depth"] and torch.equal(dist, threads["dist"])
          and seg(hd_launched) == SHARDS * depth,
          f"hop_dist_vsharded on NCCL root {root}: == the threads' bit for "
          f"bit ({depth} levels, {seg(hd_launched)} segment-reduce "
          f"launches); {hd_ms:.1f} ms")
    check(colls["all_to_all"] == it + depth and colls["psum"] == it + depth,
          f"the NCCL runs' collectives through torch.distributed: {colls}")


def sharded_phase(torch, K, dev, apps, g_host, roots, smi):
    """Phase 10: SHARDS shards of one program on the card.  Returns the
    launches of the sharded runs by name."""
    import tempfile
    import warnings

    from green_marl_tpu_torch.lang import distribute as D
    from green_marl_tpu_torch.lang import lower_vertex as LV
    from green_marl_tpu_torch.lang.lower import compile_source
    from green_marl_tpu_torch.models.hop_dist import hop_dist
    from green_marl_tpu_torch.models.pagerank import pagerank
    from green_marl_tpu_torch.models.relax import INT32_MAX
    from green_marl_tpu_torch.models.sssp import sssp
    from green_marl_tpu_torch.parallel import comm
    from green_marl_tpu_torch.parallel import vertex_sharded as V
    from green_marl_tpu_torch.utils.gm_rand import sssp_edge_lengths

    os.environ[comm.VIRTUAL_ENV] = str(SHARDS)
    mesh = comm.vmesh(SHARDS, kind=dev.type)
    log(f"  mesh: {SHARDS} shards on {sorted({str(d) for d in mesh.devices})}"
        f" (card: {smi})")
    t0 = time.time()
    vsg_h = V.build_vertex_sharded(g_host, SHARDS)
    t1 = time.time()
    sched_h = LV.build_schedule(g_host, SHARDS)
    log(f"  host builds: build_vertex_sharded {t1 - t0:.1f} s "
        f"(L={vsg_h.L} E_s={vsg_h.E_s} cap={vsg_h.cap} ghost ids "
        f"{vsg_h.ghost_total}; {shard_bytes(vsg_h, V._FIELDS + ('dst_off',), SHARDS) / 1e9:.3f} "
        f"GB a shard), build_schedule {time.time() - t1:.1f} s (Lh="
        f"{sched_h.Lh} E_s={sched_h.E_s} cap={sched_h.cap} ghost ids "
        f"{sched_h.ghost_total}; "
        f"{shard_bytes(sched_h, LV._SCHED_FIELDS, SHARDS) / 1e9:.3f} GB a "
        "shard)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = g_host.to(dev)
    n = g.num_nodes
    vsg = V.place(vsg_h, mesh)
    sched = LV.place_schedule(sched_h, mesh)
    w_np = np.zeros(g.e_pad, np.int32)
    w_np[: g.num_edges] = sssp_edge_lengths(g.num_edges)
    w = torch.from_numpy(w_np).to(dev)
    w_slab = comm.place_rows(V.shard_edge_prop(vsg, g_host, w_np), mesh)
    def timed(fn):
        """(result, CUDA-event ms, launches by name)."""
        out, ms, _, launched = timed_launches(fn, K.launch_counts)
        return out, ms, launched

    total = {name: 0 for name in K.launch_counts()}

    def sharded(fn):
        """timed(fn) for a sharded run: only its launches join the
        phase's."""
        out, ms, launched = timed(fn)
        for name, k in launched.items():
            total[name] += k
        return out, ms, launched

    def seg(launched):
        return launched.get("segment_reduce_sorted", 0)

    one, one_ms, _ = timed(lambda: pagerank(g))
    (rank, _, it), ms, launched = sharded(
        lambda: V.pagerank_vsharded(vsg, mesh))
    err = float((rank - one.rank[:n]).abs().max())
    check(it == one.iterations and torch.allclose(rank, one.rank[:n],
                                                  rtol=1e-5, atol=0.0)
          and seg(launched) == SHARDS * it,
          f"pagerank_vsharded S={SHARDS}: {it} supersteps == pagerank's, "
          f"ranks within rtol 1e-5 (max abs err {err:.3g}), "
          f"{seg(launched)} segment-reduce launches (one a shard a "
          f"superstep); {ms:.1f} ms beside pagerank {one_ms:.1f} ms (CUDA "
          f"events)")
    threads = {"rank": rank, "iterations": it}
    del rank, one
    reach = {}
    for r in roots:
        one, one_ms, _ = timed(lambda: hop_dist(g, r))
        (dist, depth), ms, launched = sharded(
            lambda: V.hop_dist_vsharded(vsg, mesh, r))
        if r == roots[0]:
            threads.update(dist=dist, depth=depth)
        reach[r] = one.dist[:n] < INT32_MAX
        check(torch.equal(dist, one.dist[:n])
              and seg(launched) == SHARDS * depth,
              f"hop_dist_vsharded root {r}: == hop_dist bit for bit "
              f"({depth} levels, {seg(launched)} segment-reduce launches); "
              f"{ms:.1f} ms beside hop_dist {one_ms:.1f} ms")
        one, one_ms, _ = timed(lambda: sssp(g, r, w))
        (dist, it), ms, launched = sharded(
            lambda: V.sssp_vsharded(vsg, mesh, w_slab, r))
        check(torch.equal(dist, one.dist[:n])
              and seg(launched) == SHARDS * it,
              f"sssp_vsharded root {r}: == sssp bit for bit ({it} "
              f"supersteps, {seg(launched)} segment-reduce launches); "
              f"{ms:.1f} ms beside sssp {one_ms:.1f} ms")
    del dist, one
    nccl_one_rank(torch, K, dev, vsg_h, roots[0], threads, sharded, seg)
    del threads
    deg = np.diff(g_host.begin.numpy())
    roots_b = np.concatenate([roots, np.argsort(deg)[::-1][
        len(roots):MULTI_BFS_B]]).astype(np.int32)
    (vis, depth), ms, _ = sharded(lambda: V.multi_bfs_vsharded(vsg, mesh,
                                                                roots_b))
    same = all(torch.equal(((vis[:, 0] >> b) & 1).bool(), reach[r])
               for b, r in enumerate(roots))
    check(same and vis.shape == (n, MULTI_BFS_B // 32),
          f"multi_bfs_vsharded B={MULTI_BFS_B}: instances 0-3 reach what "
          f"hop_dist reaches from phase 4's roots ({depth} levels, "
          f"{ms:.1f} ms; its OR reduction is plain PyTorch)")
    del vis

    def quiet(text):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return compile_source(text)

    pr, hd, at = quiet(PAGERANK_GM), quiet(HOP_DIST_GM), \
        quiet(AVG_TEEN_CNT_GM)
    one, one_ms, _ = timed(lambda: pagerank(g, e=1e-7, d=0.85,
                                            max_iter=100))
    for place, run in (("distribute", lambda: LV.run_vertex_sharded(
            pr, g, mesh=mesh, sched=sched, e=1e-7, d=0.85, max=100)),
            ("replicate", lambda: D.run_sharded(
                pr, g, mesh=mesh, e=1e-7, d=0.85, max=100))):
        out, ms, launched = sharded(run)
        out = out["pg_rank"][:n]
        err = float((out - one.rank[:n]).abs().max())
        check(torch.allclose(out, one.rank[:n], rtol=1e-4, atol=0.0)
              and seg(launched) > 0,
              f"compiled pagerank ({place}, S={SHARDS}) e=1e-7: within "
              f"rtol 1e-4 of pagerank (max abs err {err:.3g}), "
              f"{seg(launched)} segment-reduce launches; {ms:.1f} ms beside "
              f"pagerank {one_ms:.1f} ms")
    del one, out
    r = roots[0]
    one, one_ms, _ = timed(lambda: hop_dist(g, r))
    for place, run in (("distribute", lambda: LV.run_vertex_sharded(
            hd, g, mesh=mesh, sched=sched, root=r)),
            ("replicate", lambda: D.run_sharded(hd, g, mesh=mesh, root=r))):
        out, ms, launched = sharded(run)
        # distribute keys its `min= ... @ s` by the slab's sorted
        # destinations (the kernel); replicate scatters, as one device does
        check(torch.equal(out["dist"][:n], one.dist[:n])
              and (seg(launched) > 0) == (place == "distribute"),
              f"compiled hop_dist ({place}, S={SHARDS}) root {r}: == "
              f"hop_dist bit for bit, {seg(launched)} segment-reduce "
              f"launches; {ms:.1f} ms beside hop_dist {one_ms:.1f} ms")
    del one, out
    age = torch.from_numpy(np.random.default_rng(LJ_SEED).integers(
        5, 40, g.n_pad).astype(np.int32)).to(dev)
    one, one_ms, _ = timed(lambda: at(g, age=age, K=15))
    out, ms, launched = sharded(lambda: LV.run_vertex_sharded(
        at, g, mesh=mesh, sched=sched, age=age, K=15))
    cnt = launched.get("plain_cumsum", 0)
    check(torch.equal(out["teen_cnt"], one["teen_cnt"])
          and abs(float(out["_return"]) - float(one["_return"]))
          <= 1e-5 * abs(float(one["_return"])) and cnt == SHARDS,
          f"compiled avg_teen_cnt (distribute, S={SHARDS}): teen counts == "
          f"the one-device compiled run's, avg {float(out['_return']):.6f} "
          f"within rtol 1e-5; the integer Count launches plain_cumsum once "
          f"a shard ({cnt}); {ms:.1f} ms beside {one_ms:.1f} ms")
    del one, out
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del w, w_slab, vsg, sched
    torch.cuda.empty_cache()
    check_shard_slabs(torch, K, dev, vsg_h, sched_h, g, age)
    del g, age, vsg_h, sched_h
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        for name, text in (("pagerank", PAGERANK_GM),
                           ("hop_dist", HOP_DIST_GM), ("sssp", SSSP_GM)):
            with open(os.path.join(d, f"{name}.gm"), "w") as f:
                f.write(text)
        apps.REFERENCE_APPS = d
        for place in ("distribute", "engine", "replicate"):
            argv = [f"-GMDevice={dev.type}", f"-GMNumChips={SHARDS}",
                    f"-GMPlacement={place}", FIXTURE]
            runs = {}
            for app in ("hop_dist", "sssp", "pagerank"):
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    runs[app], _, launched = sharded(
                        lambda: run_cli(apps, [app] + argv))
                # replicate's hop_dist and sssp relax by scatters
                want = place != "replicate" or app == "pagerank"
                check((seg(launched) > 0) == want
                      and ("ghost exchange" in err.getvalue()
                           or place == "replicate"),
                      f"{app} -GMNumChips={SHARDS} -GMPlacement={place}: "
                      f"{seg(launched)} segment-reduce launches"
                      + ("" if place == "replicate" else
                         ", the placement report on stderr"))
            check(field(runs["hop_dist"], r"^CRC16 dist (\S+)")
                  == GOLD_HOP_CRC16,
                  f"hop_dist -GMNumChips={SHARDS} -GMPlacement={place}: "
                  f"CRC16 dist {GOLD_HOP_CRC16}")
            dist = [int(field(runs["sssp"], rf"^dist\[{i}\] = (\S+)"))
                    for i in range(4)]
            check(field(runs["sssp"], r"^CRC16 dist (\S+)")
                  == GOLD_SSSP_CRC16 and dist == GOLD_SSSP_DIST,
                  f"sssp -GMNumChips={SHARDS} -GMPlacement={place}: CRC16 "
                  f"dist {GOLD_SSSP_CRC16}, dist[0..3] = {GOLD_SSSP_DIST}")
            rank = [float(field(runs["pagerank"], rf"^rank\[{i}\] = (\S+)"))
                    for i in range(4)]
            check(np.allclose(rank, GOLD_RANK, rtol=RANK_RTOL, atol=0.0),
                  f"pagerank -GMNumChips={SHARDS} -GMPlacement={place}: "
                  f"rank[0..3] within {RANK_RTOL} of {GOLD_RANK}")
    torch.cuda.synchronize()
    log(f"  device memory peak over the full-size runs {peak:.2f} GB")
    log("  not run on the card: the multi-process path with two ranks "
        "(NCCL takes one rank a card); its gloo form runs on the CPU in "
        "tests/test_torch_distribute.py")
    return total


def scale_phase(torch, K, dev, scale, g_host, times, keep=None):
    """Phase 11: ``probes.scale``'s witness on the graph past 2^24 nodes;
    each of its checks, each run's launches, the segment reduce against
    its plain version on the slabs the runs gave it, its times and the
    device memory peak.  Returns the runs' kernel launches (not the slab
    checks')."""
    K.reset_launch_counts()
    rec = scale.run(SCALE_N, SCALE_E, SCALE_B, dev, g_host=g_host,
                    times=times, keep=keep)
    torch.cuda.synchronize()
    log(f"  footprint of {scale.SHARDS} shards: {rec['footprint']}; levels "
        f"{rec['levels']}; bit BFS edges traversed "
        f"{rec['bit_bfs_edges_traversed']}")
    log("  host seconds: " + ", ".join(
        f"{k[2:-2]} {v}" for k, v in rec.items() if k.startswith("t_")))
    log("  device ms (CUDA events): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rec["device_ms"].items()))
    c = rec["checks"]
    for name in ("hop_dist_exact", "hop_dist_vsharded_exact",
                 "hop_dist_gm_vsharded_exact"):
        check(c[name], f"{name[:-len('_exact')]} from root "
              f"{rec['roots'][0]}: BFS levels == the scipy oracle bit for "
              f"bit ({rec['levels']['hop_dist']} levels)")
    for b in scale.sample(SCALE_B):
        check(c[f"bit_bfs_reach_b{b}"]
              and c[f"multi_bfs_vsharded_reach_b{b}"],
              f"bit BFS and multi_bfs_vsharded B={SCALE_B}, instance {b} "
              f"(root {rec['roots'][b]}): reached set == the scipy oracle's")
    check(c["pagerank_ok"] and c["pagerank_gm_vsharded_ok"],
          f"pagerank and pagerank.gm ({scale.SHARDS} shards), "
          f"{scale.PR_ITERS} supersteps: max relative error "
          f"{c['pagerank_max_rel_err']:.3g} and "
          f"{c['pagerank_gm_vsharded_max_rel_err']:.3g} against float64 "
          f"(< {scale.PR_REL_ERR})")
    check(c["pagerank_gm_sharded_eq_one_device"],
          f"pagerank.gm on {scale.SHARDS} shards within rtol 1e-5 of one "
          "device")
    for name, r in rec["slabs"].items():
        check(c[f"slab {name}"] and r["ms"] <= r["plain_ms"],
              f"segment_reduce_sorted on the {name} slab ({r['slots']} "
              f"slots, {r['rows']} rows, {r['empty_rows']} empty): float32 "
              f"add within rtol 1e-5 of float64 (max abs err "
              f"{r['add_max_abs_err']:.3g}), int32 min and max exactly; "
              f"add: kernel {r['ms']:.3f} ms <= plain {r['plain_ms']:.3f} ms")
    # each run's launches, read around it alone: one segment reduce a
    # superstep (a level), a shard; the one-device bit BFS's OR one
    # edge_map_bor_level a level, the sharded one's plain PyTorch
    levels, S = rec["levels"]["hop_dist"], scale.SHARDS
    want = {"pagerank": scale.PR_ITERS, "hop_dist": levels,
            "pagerank.gm": scale.PR_ITERS, "bit_bfs": 0,
            "hop_dist_vsharded": S * rec["levels"]["hop_dist_vsharded"],
            "multi_bfs_vsharded": 0, "hop_dist.gm_vsharded": S * levels,
            "pagerank.gm_vsharded": S * scale.PR_ITERS}
    for run, k in want.items():
        got = rec["launches"][run]
        expect = {"segment_reduce_sorted": k} if k else {}
        if run == "hop_dist":           # min_relax: the gather form
            expect["segment_reduce_sorted[gather]"] = k
        if run == "bit_bfs":
            expect = {"edge_map_bor_level": rec["levels"]["bit_bfs"],
                      "bit_popstats": 1}
        check(got == expect,
              f"{run}: launches {got}, {k} segment reduces expected")
    check(c["ok"], "every check of the witness")
    launched = {name: sum(r.get(name, 0) for r in rec["launches"].values())
                for name in K.launch_counts()}
    log(f"  device memory peak {rec['max_memory_allocated_gb']:.2f} GB "
        f"(card: {rec['card']})")
    return launched


# phase 13: the harness (green_marl_tpu_torch/harness/) and the probes of
# the hot paths (probes/twitter_scale.py, bfs.py, prep.py).  conduct.gm is
# the inline text of tests/test_torch_distribute.py:49
CONDUCT_GM = """
Procedure conduct(G: Graph, member: N_P<Int>, num: Int) : Float {
    Int Din, Dout, Cross;
    Din = Sum(u: G.Nodes)(u.member == num){ u.Degree() };
    Dout = Sum(u: G.Nodes)(u.member != num){ u.Degree() };
    Cross = Sum(u: G.Nodes)(u.member == num){
        Count(j: u.Nbrs)(j.member != num) };
    Float m = (Din < Dout) ? Din : Dout;
    If (m == 0) Return (Cross == 0) ? 0.0 : +INF;
    Else Return (Cross / m);
}
"""
MH_N, MH_E = 400_000, 4_000_000      # multihost_bench's card rows


def matrix_part(torch, K, dev, add):
    """Phase 13, the placement matrix at 8 shards on the card, on its own
    graph and at the 1/16 size: every cell runs and passes."""
    import tempfile

    from green_marl_tpu_torch.harness import matrix_sweep as M

    with tempfile.TemporaryDirectory() as d:
        for name, text in (("pagerank", PAGERANK_GM),
                           ("hop_dist", HOP_DIST_GM), ("sssp", SSSP_GM),
                           ("conduct", CONDUCT_GM),
                           ("avg_teen_cnt", AVG_TEEN_CNT_GM)):
            with open(os.path.join(d, f"{name}.gm"), "w") as f:
                f.write(text)
        for n, e in (M.DEFAULT_GRAPH, (SMALL_N, SMALL_E)):
            t0 = time.time()
            path = os.path.join(d, f"m{n}.bin")
            M.write_graph(path, n, e)
            t1 = time.time()
            before = K.launch_counts()
            rec = M.sweep(path, dev.type, d, log=lambda m: log("  | " + m))
            launched = add(launched_since(K, before))
            cells = {(c["app"], c["placement"]): c["launches"]
                     for c in rec["cells"]}
            check(rec["ran"] == rec["passed"] == 12 and rec["not_run"] == 0
                  and all(cells[(a, p)] > 0 for a in ("pagerank", "sssp")
                          for p in ("distribute", "engine")),
                  f"matrix sweep N={n} E={e} (graph {t1 - t0:.1f} s): 12 of "
                  f"12 cells at {M.SHARDS} shards on the card agree with one "
                  f"device in {time.time() - t1:.1f} s; launches {launched}; "
                  f"segment reduces a cell {cells}")
            os.remove(path)


def scaling_part(torch, K, dev, g_host, add):
    """Phase 13, the scaling ladder on phase 4's graph; then the segment
    reduce against its plain version on one S=8 shard's slab."""
    from green_marl_tpu_torch.harness import scaling as SC

    before = K.launch_counts()
    rows, keep = SC.ladder(g_host, dev, log=lambda m: log("  " + m))
    launched = add(launched_since(K, before))
    log("  " + SC.table(rows, g_host.num_nodes, g_host.num_edges)
        .replace("\n", "\n  "))
    check(all(r["ranks_equal"] for r in rows)
          and all(r["segment_reduce_launches"] == r["S"] * SC.ITERS
                  for r in rows),
          f"scaling ladder S={SC.LADDER}: ranks bit-identical across S, "
          f"one segment reduce a shard a superstep; launches {launched}")
    ids, off, n_out = (x.to(dev) if torch.is_tensor(x) else x
                       for x in keep["slab"])
    gen = torch.Generator(device=dev).manual_seed(LJ_SEED)
    vals = torch.rand(ids.numel(), generator=gen, device=dev)
    got = K.segment_reduce_sorted(vals, ids, off, n_out, op="add")
    want = K.segment_reduce_sorted_ref(vals.double(), ids, off, n_out, "add")
    err = float((got.double() - want).abs().max())
    ivals = torch.randint(-2**30, 2**30, (ids.numel(),), generator=gen,
                          device=dev, dtype=torch.int32)
    exact = all(torch.equal(
        K.segment_reduce_sorted(ivals, ids, off, n_out, op=op),
        K.segment_reduce_sorted_ref(ivals, ids, off, n_out, op))
        for op in ("min", "max"))
    check(torch.allclose(got.double(), want, rtol=1e-5, atol=0.0) and exact,
          f"segment_reduce_sorted on S={SC.LADDER[-1]} shard 0's slab "
          f"({ids.numel()} slots, {n_out} rows): float32 add within rtol "
          f"1e-5 of float64 (max abs err {err:.3g}), int32 min and max "
          "exactly")


def multihost_part(torch, K, dev, add):
    """Phase 13, multihost_bench's card rows: threads against one NCCL
    rank of 4 shards; the 2- and 4-rank rows not run on one card."""
    from green_marl_tpu_torch.harness import multihost_bench as MB

    before = K.launch_counts()
    row = MB.bench(MH_N, MH_E, dev, log=lambda m: log("  " + m))
    launched = add(launched_since(K, before))
    arr = {a["arrangement"]: a for a in row["arrangements"]}
    ran = [a for a in arr.values() if a["status"] == "ran"]
    check(row["ok"] and len(ran) == 2
          and all(a["segment_reduce_launches"] == 2 * MB.SHARDS * a["iters"]
                  for a in ran)
          and all(a["status"] == "not run" for name, a in arr.items()
                  if name.startswith(("2 ", "4 "))),
          f"multihost_bench N={MH_N} E={MH_E}: threads and one NCCL rank of "
          f"4 shards give {ran[0]['iters']} iterations and the same "
          f"checksums shard for shard (wsum {ran[0]['wsum']!r}); "
          + "; ".join(f"{n}: {a['time_s'] * 1000:.1f} ms" for n, a in
                      arr.items() if a["status"] == "ran")
          + f"; launches {launched}")


def twitter_part(torch, K, dev, g_scale, scale_keep, add):
    """Phase 13, the Twitter-class bit BFS at B=1024 on phase 11's graph
    and schedule, fused and paged: equal, one ``edge_map_bor_level`` launch
    a fused level and one ``edge_map_bor`` a paged level, and the instances
    whose roots phase 11 held against scipy reach what scipy reached.
    Keeps the paged runs' ``edge_map_bor`` launches in
    ``scale_keep["edge_map_bor"]``."""
    from green_marl_tpu_torch.probes import twitter_scale as TW

    bp = scale_keep["binned"]
    out_deg = np.diff(g_scale.begin.numpy()).astype(np.int64)
    roots = TW.top_roots(out_deg)
    planes = {}
    torch.cuda.empty_cache()
    before = K.launch_counts()
    res = TW.run(bp, TW.degree_rows(bp, out_deg), roots, dev, keep=planes)
    launched = add(launched_since(K, before))
    # each variant runs once from the roots and once from each of their
    # rolls: the same set of sources, so as many levels each time
    runs = {name: 1 + len(res[name]["run_times_ms"]) for name in TW.VARIANTS}
    want = {"edge_map_bor_level": runs["fused"] * res["fused"]["levels"],
            "edge_map_bor": runs["paged"] * res["paged"]["levels"]}
    got = {name: launched.get(name, 0) for name in want}
    check(got == want,
          f"bit BFS B={TW.B}: {runs['fused']} fused runs of "
          f"{res['fused']['levels']} levels, one edge_map_bor_level launch "
          f"a level; {runs['paged']} paged runs of {res['paged']['levels']} "
          f"levels, one edge_map_bor launch a level ({got})")
    scale_keep["edge_map_bor"] = got["edge_map_bor"]
    for name in TW.VARIANTS:
        r = res[name]
        log(f"  {name}: B={TW.B} levels={r['levels']} traversed="
            f"{r['traversed']}: {r['time_ms']:.1f} ms (host clock, median "
            f"of {r['run_times_ms']}), {r['device_ms']:.1f} ms (CUDA "
            f"events), {r['agg_gteps']:.2f} GTEPS aggregate; peak "
            f"{r['peak_gb']:.2f} GB")
    visited = planes["fused"][3]
    inv = bp.inv_perm.numpy()
    same = []
    for r, seen in scale_keep["reach"].items():
        for i in np.flatnonzero(roots == r):
            lane = visited[:, i // TW.PLANE_BITS].numpy()[inv]
            same.append(np.array_equal(
                (lane >> (i % TW.PLANE_BITS)) & 1 == 1, seen))
    check(res["equal"] and same and all(same),
          f"bit BFS B={TW.B} plane_bits={TW.PLANE_BITS} at N={SCALE_N} "
          f"E={SCALE_E}: fused == paged (levels, traversed and reached of "
          f"each instance, the planes); {len(same)} instance(s) whose root "
          f"phase 11 held against scipy reach its reached set")


def bfs_part(torch, K, dev, g_host, add):
    """Phase 13, probes/bfs.py's three measurements on phase 4's graph;
    the prefix sum against its plain version on the pull sweep's
    values."""
    from green_marl_tpu_torch.models.hop_dist import hop_dist
    from green_marl_tpu_torch.models.relax import INT32_MAX
    from green_marl_tpu_torch.probes import bfs as PB

    out_deg = np.diff(g_host.begin.numpy())
    before = K.launch_counts()
    rec = PB.measure(g_host, out_deg, dev, log=lambda m: log("  " + m))
    launched = add(launched_since(K, before))
    g = g_host.to(dev)
    r0 = rec["bfs"]["roots"][0]
    reached = int((hop_dist(g, r0).dist[:g.num_nodes] < INT32_MAX).sum())
    check(rec["pull"]["plain_cumsum_launches"] == 1
          and min(rec["bfs"]["plain_cumsum_launches"]) > 0
          and rec["bfs"]["reached"] == reached,
          f"probes/bfs.py: pull sweep {rec['pull']['ms']:.3f} ms, push "
          + ", ".join(f"cap {c} {rec[f'push_{c}']['ms']:.3f} ms"
                      for c in PB.PUSH_CAPS)
          + f", auto bfs {rec['bfs']['ms']:.1f} ms (CUDA events); root "
          f"{r0}: {rec['bfs']['levels']} levels, reached {reached} == "
          f"hop_dist's; launches {launched}")
    vals = PB.pull_values(g, PB.pull_frontier(g).to(dev))
    got = K.plain_cumsum(vals, exclusive=True)
    check(torch.equal(got, K.plain_cumsum_ref(vals, exclusive=True)),
          f"plain_cumsum exclusive on the pull sweep's values "
          f"({vals.numel()} slots, {int(got[-1])} ones) == plain exactly")


def prep_part(torch, K, native, dev, add):
    """Phase 13, probes/prep.py's stages at the 1/16 size."""
    from green_marl_tpu_torch.probes import prep as PP

    src, dst = native.rmat_edges(SMALL_N, SMALL_E, seed=LJ_SEED)
    before = K.launch_counts()
    rec = PP.stages(src, dst, SMALL_N, dev, log=lambda m: log("  " + m))
    add(launched_since(K, before))
    deg = torch.from_numpy(np.bincount(src, minlength=SMALL_N)
                           .astype(np.int32))
    check(torch.equal(rec["deg_binned"].cpu(), deg[rec["perm"].long()]),
          f"probes/prep.py at N={SMALL_N} E={SMALL_E}: every stage ran; "
          "to_binned(deg) on the card == the host's deg[perm]")


def harness_phase(torch, K, dev, native, g_host, g_scale, scale_keep):
    """Phase 13: the harness and the hot-path probes on the card.  Returns
    the launches of their runs by name (not the checks')."""
    total = {name: 0 for name in K.launch_counts()}

    def add(launched):
        for name, k in launched.items():
            total[name] += k
        return launched

    for what, part in (
            ("placement matrix", lambda: matrix_part(torch, K, dev, add)),
            ("scaling ladder", lambda: scaling_part(torch, K, dev, g_host,
                                                     add)),
            ("multihost_bench", lambda: multihost_part(torch, K, dev, add)),
            ("Twitter-class bit BFS", lambda: twitter_part(
                torch, K, dev, g_scale, scale_keep, add)),
            ("BFS phases", lambda: bfs_part(torch, K, dev, g_host, add)),
            ("preprocessing stages", lambda: prep_part(torch, K, native, dev,
                                                       add))):
        log(f"  -- {what}")
        t0 = time.time()
        torch.cuda.empty_cache()
        part()
        log(f"  {what} {time.time() - t0:.1f} s")
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "green_marl_tpu_torch")):
        raise SystemExit("chip_smoke: green_marl_tpu_torch/ not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    from green_marl_tpu_torch.cli import apps
    from green_marl_tpu_torch.graph import binary_io, native
    from green_marl_tpu_torch.graph.csr import from_edges
    from green_marl_tpu_torch.models import batched
    from green_marl_tpu_torch.models.bfs import bfs
    from green_marl_tpu_torch.models.hop_dist import hop_dist
    from green_marl_tpu_torch.models.pagerank import pagerank
    from green_marl_tpu_torch.models.relax import INT32_MAX
    from green_marl_tpu_torch.models.sssp import sssp
    from green_marl_tpu_torch.ops import (_build, binned, kernels as K,
                                          scan_reduce, segment)
    from green_marl_tpu_torch.probes import gather as probes
    from green_marl_tpu_torch.probes import scale
    from green_marl_tpu_torch.utils.crc import array_checksum_hex
    from green_marl_tpu_torch.utils.gm_rand import sssp_edge_lengths
    from green_marl_tpu_torch.utils.timing import card, timed

    dev = torch.device("cuda")
    t_all = time.time()

    # -- 1. card and build ------------------------------------------------
    log("== 1. card and build")
    smi = card(dev)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.time()
    native.lib()       # raises if native/gm_io.cc does not build
    log(f"native host library build: {time.time() - t0:.2f} s")
    # phase 4's graph: drawn and frozen by the serial host library on a
    # thread of its own (the calls release the interpreter) while phases
    # 1-3 keep the card busy
    pool = concurrent.futures.ThreadPoolExecutor(2)
    lj_host = pool.submit(host_graph, native, from_edges, LJ_N, LJ_E, LJ_SEED)
    # phase 11's graph past 2^24 nodes, drawn and frozen beside phases 2-10
    scale_host = pool.submit(scale.host_graph, SCALE_N, SCALE_E)
    pool.shutdown(wait=False)
    t0 = time.time()
    so = _build.build()
    _build.lib()
    log(f"kernel build: {time.time() - t0:.2f} s -> "
        f"{os.path.relpath(so, ROOT)}")

    # -- 2. kernels against their plain versions ---------------------------
    log("== 2. kernels against plain PyTorch, on the card")
    rng = np.random.default_rng(0)
    n_seg = LJ_N
    lens = rng.choice([0, 0, 1, 1, 1, 2, 3, 8, 30], size=n_seg)
    hub = n_seg // 3
    lens[hub] = 1 << 20                       # one 1M-slot hub segment
    off_np = np.zeros(n_seg + 1, np.int64)
    np.cumsum(lens, out=off_np[1:])
    e_tot = int(off_np[-1]) + 77              # not a multiple of 128
    offsets = torch.from_numpy(off_np.astype(np.int32)).to(dev)
    n_out = n_seg + 300                       # rows past N: identity
    hub_sl = slice(int(off_np[hub]), int(off_np[hub + 1]))
    vals_i = rng.integers(-(1 << 30), 1 << 30, e_tot).astype(np.int32)
    vals_f = rng.random(e_tot).astype(np.float32)
    # integer-valued floats in the hub: its sum is exact in any order
    vals_f[hub_sl] = rng.integers(0, 16, hub_sl.stop - hub_sl.start)
    log(f"  segments={n_seg} slots={e_tot} n_out={n_out} "
        f"empty={int((lens == 0).sum())} len1={int((lens == 1).sum())} "
        f"hub={lens[hub]}")
    for dtype, host in ((torch.int32, vals_i), (torch.float32, vals_f)):
        vals = torch.from_numpy(host).to(dev)
        for op in K.OPS:
            got = K.segment_reduce_sorted(vals, vals, offsets, n_out, op)
            want = K.segment_reduce_sorted_ref(vals, vals, offsets, n_out,
                                               op)
            torch.cuda.synchronize()
            if dtype == torch.float32 and op == "add":
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
                      f"segment_reduce_sorted {op} float32 within rtol 1e-5 "
                      f"(max abs err {err:.3g})")
            else:
                check(torch.equal(got, want),
                      f"segment_reduce_sorted {op} {str(dtype)[6:]} exact")
        del vals
    del offsets

    v = torch.from_numpy(
        rng.integers(0, 1 << 30, LJ_E).astype(np.int32)).to(dev)
    got = K.plain_cumsum(v)
    want = K.plain_cumsum_ref(v)
    torch.cuda.synchronize()
    check(int(got[-1]) != int(v.sum()),
          "int32 test input wraps (its sum exceeds 2^31)")
    check(torch.equal(got, want), f"plain_cumsum int32 n={LJ_E} exact "
          "mod 2^32")
    got = K.plain_cumsum(v, exclusive=True)
    check(torch.equal(got, K.plain_cumsum_ref(v, exclusive=True)),
          f"plain_cumsum exclusive int32 n={LJ_E}: {LJ_E + 1} values, exact "
          "mod 2^32")
    view = v[1:]                              # 4 bytes into the allocation
    check(view.data_ptr() % 16 != 0
          and torch.equal(K.plain_cumsum(view), K.plain_cumsum_ref(view)),
          f"plain_cumsum int32 on an unaligned view (v[1:], n={LJ_E - 1}) "
          "exact")
    del view
    v = torch.from_numpy(
        rng.standard_normal(LJ_E).astype(np.float32)).to(dev)
    got = K.plain_cumsum(v)
    want = K.plain_cumsum_ref(v)
    bound = 1e-6 * torch.cumsum(v.double().abs(), 0)
    cumsum_err = float((got.double() - want.double()).abs().max())
    check(bool(((got.double() - want.double()).abs() <= bound).all()),
          f"plain_cumsum float32 n={LJ_E} |err| <= 1e-6*cumsum(|v|) "
          f"(max abs err {cumsum_err:.3g})")
    del v, got, want, bound

    # the segmented scan at the LJ edge count: sorted ids with the LJ-scale
    # segment layout above (runs of 0..30 slots and one 1M-slot hub)
    seg_ids = torch.repeat_interleave(
        torch.arange(n_seg, dtype=torch.int32, device=dev),
        torch.from_numpy(lens).to(dev), output_size=int(off_np[-1]))
    seg_ids = torch.cat([seg_ids, torch.full((77,), n_seg, dtype=torch.int32,
                                             device=dev)])
    K.reset_launch_counts()
    for dtype, host in ((torch.int32, vals_i), (torch.float32, vals_f)):
        vals = torch.from_numpy(host).to(dev)
        for op in K.OPS:
            got = K.segmented_scan(vals, seg_ids, op)
            torch.cuda.synchronize()
            want = K.segmented_scan_ref(vals, seg_ids, op)
            if dtype == torch.float32 and op == "add":
                exact = K.segmented_scan_ref(vals.double(), seg_ids, op)
                bound = 1e-5 * K.segmented_scan_ref(vals.double().abs(),
                                                    seg_ids, op)
                scan_err = float((got - want).abs().max())
                check(bool(((got.double() - exact).abs() <= bound).all()),
                      f"segmented_scan {op} float32 n={e_tot} |err| <= "
                      f"1e-5*segment-cumsum(|v|) (max abs err vs plain "
                      f"{scan_err:.3g})")
                del exact, bound
            else:
                check(torch.equal(got, want), f"segmented_scan {op} "
                      f"{str(dtype)[6:]} n={e_tot} exact")
        del vals, got, want
    scan_launches = K.launch_counts()["segmented_scan"]
    del seg_ids
    lib = _build.lib()
    check_edge_layouts(torch, K, max(lib.gm_segment_reduce_tile_size(),
                                     lib.gm_segmented_scan_tile_size()), dev)

    # -- 3 + 4. the main path, counted ------------------------------------
    log("== 3. parity10k through the CLI (-GMDevice=cuda)")
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_main = time.time()
    out = run_cli(apps, ["hop_dist", "-GMDevice=cuda", FIXTURE])
    check(field(out, r"^CRC16 dist (\S+)") == GOLD_HOP_CRC16,
          f"hop_dist CRC16 dist {GOLD_HOP_CRC16}")
    out = run_cli(apps, ["sssp", "-GMDevice=cuda", FIXTURE])
    check(field(out, r"^CRC16 dist (\S+)") == GOLD_SSSP_CRC16,
          f"sssp CRC16 dist {GOLD_SSSP_CRC16}")
    dist = [int(field(out, rf"^dist\[{i}\] = (\S+)")) for i in range(4)]
    check(dist == GOLD_SSSP_DIST, f"sssp dist[0..3] = {GOLD_SSSP_DIST}")
    out = run_cli(apps, ["pagerank", "-GMDevice=cuda", FIXTURE])
    rank = [float(field(out, rf"^rank\[{i}\] = (\S+)")) for i in range(4)]
    check(np.allclose(rank, GOLD_RANK, rtol=RANK_RTOL, atol=0.0),
          f"pagerank rank[0..3] {rank} within {RANK_RTOL} of {GOLD_RANK}")

    log(f"== 4. RMAT graphs: the CLI round trip at N={SMALL_N} E={SMALL_E}, "
        f"then N={LJ_N} E={LJ_E} in process (seed {LJ_SEED})")
    log("  edges from native/gm_io.cc's RMAT: the same sizes and "
        "parameters as bench.py, not bench.py's numpy edge stream")
    t0 = time.time()
    src16, dst16, g16_host, _, _ = host_graph(native, from_edges, SMALL_N,
                                              SMALL_E, LJ_SEED)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"rmat_small_seed{LJ_SEED}.bin")
    binary_io.store_binary(
        path, g16_host.begin.numpy(),
        g16_host.node_idx.numpy()[:SMALL_E])
    g16 = g16_host.to(dev)
    log(f"  generated, froze and wrote {os.path.relpath(path, ROOT)} "
        f"({os.path.getsize(path) / 1e6:.0f} MB) in {time.time() - t0:.1f} s")

    def edge_weights(g):
        w = np.zeros(g.e_pad, np.int32)
        w[:g.num_edges] = sssp_edge_lengths(g.num_edges)
        return torch.from_numpy(w).to(dev)

    w16 = edge_weights(g16)
    cli_lines = {}
    for app, name, fn in (
            ("pagerank", "rank", lambda: pagerank(g16).rank),
            ("hop_dist", "dist", lambda: hop_dist(g16, 0).dist),
            ("sssp", "dist", lambda: sssp(g16, 0, w16).dist)):
        t0 = time.time()
        out = run_cli(apps, [app, "-GMMeasureTime=1", "-GMDevice=cuda",
                             path])
        cli_lines[app] = result_lines(out)
        crc = field(out, rf"^CRC {name} (\S+)")
        cli_ms = float(field(out, r"^running time=(\S+)"))
        check(array_checksum_hex(fn()[:SMALL_N].cpu().numpy()) == crc,
              f"{app} at the 1/16 size: in-process output == CLI output (CRC "
              f"{crc}); CLI running time {cli_ms:.1f} ms, whole CLI call "
              f"{time.time() - t0:.1f} s")
    del w16
    # the same graph stored with 8-byte edge_t (the reference's EDGE_SIZE=64
    # build): the device arrays are int32 again, and the lines the same
    path8 = path[:-len(".bin")] + "_edge8.bin"
    binary_io.store_binary(path8, g16_host.begin.numpy(),
                           g16_host.node_idx.numpy()[:SMALL_E],
                           edge_bytes=8)
    for app in cli_lines:
        out = run_cli(apps, [app, "-GMMeasureTime=1", "-GMDevice=cuda",
                             path8])
        check(result_lines(out) == cli_lines[app],
              f"{app} on the 1/16-size graph stored with 8-byte edge_t: the "
              f"lines of the 4-byte file")
    os.remove(path8)

    t0 = time.time()
    src, dst, g_host, gen_s, freeze_s = lj_host.result()
    waited = time.time() - t0
    begin = g_host.begin.numpy()
    t0 = time.time()
    g = g_host.to(dev)
    del src, dst
    log(f"  full size: edges drawn in {gen_s:.1f} s and frozen in "
        f"{freeze_s:.1f} s on the host thread (waited {waited:.1f} s for "
        f"it), on the card in {time.time() - t0:.1f} s "
        f"(n_pad={g.n_pad} e_pad={g.e_pad})")
    w = edge_weights(g)
    # the region the CLI times with -GMMeasureTime: a warm-up run, then the
    # host clock from the call to the result on the host
    app_ms = {}
    for app, fn in (("pagerank", lambda: pagerank(g)),
                    ("hop_dist", lambda: hop_dist(g, 0)),
                    ("sssp", lambda: sssp(g, 0, w))):
        fn()
        torch.cuda.synchronize()
        before = K.launch_counts()
        t0 = time.time()
        res, _, ms = timed(fn, dev)
        arr = (res.rank if app == "pagerank" else res.dist).cpu().numpy()
        app_ms[app] = 1000 * (time.time() - t0)
        arr = torch.from_numpy(arr[:LJ_N])
        log(f"  {app} at the full size: {app_ms[app]:.1f} ms by the host "
            f"clock (the call to the result on the host), "
            f"{ms:.1f} ms by CUDA events; "
            f"{res.iterations} supersteps; kernel launches in this run "
            f"{launched_since(K, before)}")
        if app == "pagerank":
            check(bool(torch.isfinite(arr).all()) and bool((arr >= 0).all())
                  and float(arr.double().sum()) <= 1.0 + 1e-4,
                  f"pagerank ranks finite, >= 0, summing to "
                  f"{float(arr.double().sum()):.6f} <= 1")
    roots = [int(r) for r in np.argsort(np.diff(begin))[::-1][:4]]
    bfs_res = {}
    for r in roots:
        before = K.launch_counts()
        res, _, ms = timed(lambda: bfs(g, r), dev)
        bfs_res[r] = res
        log(f"  bfs root={r}: levels={res.levels_run} "
            f"reached={res.reached} {ms:.1f} ms; kernel "
            f"launches in this run {launched_since(K, before)}")
    hd_dist = {}
    for r in roots:
        hd, _, ms = timed(lambda: hop_dist(g, r), dev)
        hd_dist[r] = hd.dist
        lv = bfs_res[r].level
        same = torch.equal(torch.where(lv >= 0, lv, INT32_MAX), hd.dist)
        check(same, f"root {r}: bfs levels == hop_dist distances "
              f"(hop_dist {hd.iterations} supersteps, {ms:.1f} ms)")
    before = K.launch_counts()
    sp, _, sp_ms = timed(lambda: sssp(g, roots[0], w), dev)
    sp_launches = launched_since(K, before)
    before = K.launch_counts()
    hd = hop_dist(g, roots[0])
    hd_launches = launched_since(K, before)
    # min_relax's step: one launch of the segment reduce's gather form
    for name, res, got in (("sssp", sp, sp_launches),
                           ("hop_dist", hd, hd_launches)):
        check(got.get("segment_reduce_sorted[gather]") == res.iterations
              == got.get("segment_reduce_sorted"),
              f"root {roots[0]}: {name} launched the gather form once a "
              f"superstep ({res.iterations} supersteps; {got})")
    check(bool((sp.dist >= hd.dist).all()),
          f"root {roots[0]}: sssp >= hop_dist everywhere "
          f"(sssp {sp.iterations} supersteps, {sp_ms:.1f} ms)")
    check(torch.equal(sp.dist < INT32_MAX, hd.dist < INT32_MAX),
          f"root {roots[0]}: sssp and hop_dist reach the same nodes")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  main path {time.time() - t_main:.1f} s; launches {counts}; "
        f"device memory peak {peak_gb:.2f} GB")
    for name in ("segment_reduce_sorted", "segment_reduce_sorted[gather]",
                 "plain_cumsum"):
        check(counts[name] > 0, f"{name} launched on the main path "
              f"({counts[name]} times)")
    counts["segmented_scan"] = scan_launches
    check(scan_launches > 0, f"segmented_scan launched in its phase "
          f"({scan_launches} times)")

    # -- 5. LJ shapes: kernel against plain ------------------------------
    log("== 5. kernels at the LiveJournal-scale graph's shapes")
    out_deg = g.out_degree().float()
    contrib = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1), 0.0) \
        / g.num_nodes
    s_kernel = segment.in_nbr_sum(g, contrib)
    pulled = segment.pull_edge_values(g, contrib)
    s_ref = K.segment_reduce_sorted_ref(pulled, g.r_node_idx_dst, g.r_begin,
                                        g.n_pad, "add")
    s_ref64 = K.segment_reduce_sorted_ref(pulled.double(), g.r_node_idx_dst,
                                          g.r_begin, g.n_pad, "add")
    seg_err = float((s_kernel - s_ref).abs().max())
    check(torch.allclose(s_kernel.double(), s_ref64, rtol=1e-5, atol=0.0),
          "PageRank pull-sum on the LJ arrays: kernel within rtol 1e-5 of "
          f"the plain version in float64 (max abs err vs plain float32 "
          f"{seg_err:.3g})")
    ids, offs, n_pad = g.r_node_idx_dst, g.r_begin, g.n_pad
    n_lj = g.num_nodes
    cand = torch.where(g.node_mask(), torch.arange(
        n_pad, dtype=torch.int32, device=dev), INT32_MAX) \
        .index_select(0, g.r_node_idx)
    check(torch.equal(K.segment_reduce_sorted(cand, ids, offs, n_pad, "min"),
                      K.segment_reduce_sorted_ref(cand, ids, offs, n_pad,
                                                  "min")),
          "relax-style int32 min on the LJ arrays: kernel == plain")
    relax_form_check(torch, K, g, roots[0], w, sp)
    bits = (torch.arange(g.e_pad, device=dev) % 3 == 0).to(torch.int32)
    cs_err = int((K.plain_cumsum(bits) - K.plain_cumsum_ref(bits))
                 .abs().max())
    check(cs_err == 0, "BFS-sweep-style 0/1 int32 cumsum on e_pad: "
          "kernel == plain")

    def sum_by_offsets_cat():
        """segment_sum_by_offsets as it was before the exclusive scan: the
        inclusive scan, then a copy of the prefix behind a 0."""
        ex = torch.cat([bits.new_zeros(1), K.plain_cumsum(bits)])
        return ex.index_select(0, offs[1:]) - ex.index_select(0, offs[:-1])

    sums = scan_reduce.segment_sum_by_offsets(bits, offs, n_pad)
    check(torch.equal(sums[:n_lj], sum_by_offsets_cat()[:n_lj])
          and torch.equal(sums[:n_lj], K.segment_reduce_sorted_ref(
              bits, ids, offs, n_pad, "add")[:n_lj]),
          "segment_sum_by_offsets on the LJ pull shape (exclusive scan) == "
          "the inclusive scan + copy form == plain segment sum")
    del sums
    # the segmented scan at the LJ CSC shape: its segment tails are the
    # pull-sum and the relax min above (the TPU's use of the scan)
    tails = (g.r_begin[1:] - 1).clamp(min=0).long()
    nonempty = (g.r_begin[1:] > g.r_begin[:-1])
    scan = K.segmented_scan(pulled, ids)
    scan_err = max(scan_err,
                   float((scan - K.segmented_scan_ref(pulled, ids)).abs()
                         .max()))
    check(torch.allclose(scan[tails][nonempty], s_kernel[:n_lj][nonempty],
                         rtol=1e-5, atol=0.0),
          f"segmented_scan float32 add on the LJ CSC (n={g.e_pad}): segment "
          f"tails within rtol 1e-5 of the pull-sum (max abs err vs plain "
          f"{scan_err:.3g})")
    scan = K.segmented_scan(cand, ids, "min")
    check(torch.equal(scan[tails][nonempty],
                      K.segment_reduce_sorted(cand, ids, offs, n_pad,
                                              "min")[:n_lj][nonempty]),
          "segmented_scan int32 min on the LJ CSC: segment tails == the "
          "segment-reduce kernel's min")
    del scan, tails, nonempty
    log(f"  LJ app running times (in process, host clock, ms): {app_ms}")
    del pulled, cand, bits, s_kernel, s_ref, s_ref64, contrib, out_deg

    # -- 6. the batched engine --------------------------------------------
    log(f"== 6. batched engine (card: {smi})")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9

    def engine_inputs(graph):
        """The binned schedule on the card, out-degrees by row, and the
        nodes by descending out-degree (the CLI's roots)."""
        bp = binned.binned_in(graph).to(dev, with_edges=False)
        out_deg = graph.out_degree().cpu().numpy()[:bp.n_nodes]
        rows = np.zeros(bp.n_rows, np.int32)
        rows[:bp.n_nodes] = out_deg[bp.perm.cpu().numpy()]
        return (bp, torch.from_numpy(rows).to(dev), out_deg,
                np.argsort(out_deg)[::-1])

    chunk = binned.slot_chunk_for(MULTI_B // 8)
    t0 = time.time()
    out = run_cli(apps, ["multi_bfs", "-GMDevice=cuda",
                         f"-num_roots={MULTI_B}", f"-plane_bits={PLANE_BITS}",
                         path])
    m = re.search(r"^batched bfs: B=(\d+) levels=(\d+) traversed=(\d+) "
                  r"aggregate=(\S+) GTEPS", out, re.M)
    bp, deg_rows, _, order = engine_inputs(g16)
    res = batched.multi_source_bfs_bits(bp, order[:MULTI_B], deg_rows,
                                        plane_bits=PLANE_BITS,
                                        slot_chunk=chunk)
    check(int(m[1]) == MULTI_B and int(m[3]) > 0
          and int(res.traversed.sum()) == int(m[3])
          and res.levels_run == int(m[2]),
          f"multi_bfs CLI B={MULTI_B} plane_bits={PLANE_BITS} at the 1/16 "
          f"size: {m[2]} levels and traversed={m[3]} equal the in-process "
          f"run's; {m[4]} GTEPS by the CLI's host clock, whole CLI call "
          f"{time.time() - t0:.1f} s")
    del bp, deg_rows, res

    t0 = time.time()
    bp, deg_rows, out_deg_np, order = engine_inputs(g)
    n = bp.n_nodes
    log(f"  full size: binned schedule built and moved in "
        f"{time.time() - t0:.1f} s: "
        f"{len(bp.bins)} bins, {bp.slot_src.numel()} slots "
        f"({bp.slot_src.numel() / g.num_edges:.3f} x E), {bp.n_hub} hubs "
        f"in {bp.n_hub_chunks} chunks")
    check([int(r) for r in order[:4]] == roots,
          "the engine's four highest-degree roots are phase 4's")
    t0 = time.time()
    K.reset_launch_counts()
    res, _, bits_ms = timed(lambda: batched.multi_source_bfs_bits(
        bp, order[:MULTI_B], deg_rows, plane_bits=PLANE_BITS,
        slot_chunk=chunk), dev)
    trav = res.traversed.cpu().numpy()      # where the CLI's clock stops
    host_s = time.time() - t0
    bits_launched = {name: n for name, n in K.launch_counts().items() if n}
    bits_launches = K.launch_counts()["edge_map_bor_level"]
    pop_launches = K.launch_counts()["bit_popstats"]
    reached = res.reached.cpu().numpy()
    gteps = float(trav.sum()) / bits_ms / 1e6
    check(int(trav.sum()) > 0,
          f"multi_source_bfs_bits B={MULTI_B} at the full size: traversed "
          f"{int(trav.sum())} in {res.levels_run} levels; {bits_ms:.1f} ms "
          f"(CUDA events), {gteps:.2f} GTEPS aggregate "
          f"({float(trav.sum()) / host_s / 1e9:.2f} by the host clock over "
          f"the region the CLI times); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(bits_launched == {"edge_map_bor_level": res.levels_run,
                            "bit_popstats": 1}
          and bits_launches == res.levels_run,
          f"multi_source_bfs_bits at the full size: one edge_map_bor_level "
          f"launch a level and one bit_popstats launch ({res.levels_run} "
          f"levels; {bits_launched})")
    for b, r in enumerate(roots):
        seen = (hd_dist[r][:n] < INT32_MAX).cpu().numpy()
        check(int(reached[b]) == int(seen.sum())
              and int(trav[b]) == int(out_deg_np[seen].astype(np.int64)
                                      .sum()),
              f"bit BFS instance {b} (root {r}): reached {int(reached[b])} "
              f"and traversed {int(trav[b])} equal hop_dist's reached set "
              f"and its out-degree sum")
    pop = popstats_check(torch, K, res.visited, deg_rows)
    check(pop["max_err"] == 0 and pop["launched"] == {"bit_popstats": 1}
          and pop["ms"] <= pop["plain_ms"],
          f"bit_popstats on the full-size bit BFS's visited plane "
          f"({tuple(res.visited.shape)}): equal to the plain version bit "
          f"for bit, one launch, no slower (kernel {pop['ms']:.2f} ms, "
          f"plain {pop['plain_ms']:.2f} ms)")
    del res
    em = edge_map_level_check(torch, K, batched, bp, order[:MULTI_B], chunk)
    check(em["same"] and em["launched"] == {"edge_map_bor": 1}
          and em["ms"] < em["plain_ms"],
          f"edge_map_bor at level {EDGE_MAP_LEVEL} of the full-size bit "
          f"BFS ({em['active']:.3f} of the rows' frontier words set): equal "
          f"to the plain gather and fold bit for bit, one launch, faster "
          f"(kernel {em['ms']:.2f} ms, plain {em['plain_ms']:.2f} ms)")
    check(em["level_same"]
          and em["level_launched"] == {"edge_map_bor_level": 1},
          f"edge_map_bor_level at level {EDGE_MAP_LEVEL} of the full-size "
          f"bit BFS: the next frontier, visited and the row count equal "
          f"the plain version's, one launch")

    roots8 = [int(r) for r in order[:8]]
    for r in roots8[4:]:
        hd_dist[r] = hop_dist(g, r).dist
    res, _, ms = timed(lambda: batched.multi_source_bfs_binned(
        bp, roots8, slot_chunk=chunk), dev)
    dist = bp.from_binned(res.dist[:n])
    check(all(torch.equal(dist[:, b], hd_dist[r][:n])
              for b, r in enumerate(roots8)),
          f"multi_source_bfs_binned B=8: distances equal hop_dist's "
          f"exactly ({res.levels_run} levels, {ms:.1f} ms)")
    del res, dist, hd_dist

    damp = 0.85 + 0.0005 * np.arange(PR_B, dtype=np.float32)
    res, _, pr_ms = timed(lambda: batched.multi_pagerank_binned(
        bp, deg_rows[:n], damp, e=0.0, max_iter=PR_ITERS, slot_chunk=chunk),
        dev)
    gedges = g.num_edges * PR_B * PR_ITERS / pr_ms / 1e6
    rank0 = bp.from_binned(res.rank[:n])[:, 0]
    single = pagerank(g, e=0.0, max_iter=PR_ITERS)
    rank_err = float((rank0 - single.rank[:n]).abs().max())
    check(res.iterations == PR_ITERS == single.iterations
          and bool(torch.isfinite(res.rank).all())
          and torch.allclose(rank0, single.rank[:n], rtol=1e-4, atol=0.0),
          f"multi_pagerank_binned B={PR_B} e=0 {PR_ITERS} iterations: the "
          f"d=0.85 instance within rtol 1e-4 of pagerank (max abs err "
          f"{rank_err:.3g}); {pr_ms:.1f} ms (CUDA events), {gedges:.2f} "
          f"Gedge/s")
    del res, rank0, single
    engine_peak = torch.cuda.max_memory_allocated() / 1e9
    counts_engine = K.launch_counts()
    log(f"  engine: bit BFS {gteps:.2f} GTEPS, PageRank {gedges:.2f} "
        f"Gedge/s; device memory peak {engine_peak:.2f} GB "
        f"(graph and phase-4 leftovers {base_gb:.2f} GB); launches "
        f"{counts_engine} since the full-size bit BFS (its edge maps, "
        f"level {EDGE_MAP_LEVEL}'s replay and check, the rest by the "
        f"hop_dist and pagerank references: the float edge maps are plain "
        f"PyTorch)")
    del bp, deg_rows

    # -- 7. triangle counting and the analytics models ----------------------
    log(f"== 7. triangle counting and the analytics models (card: {smi})")
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    u_begin, u_dst = models_phase(torch, K, dev, g, g_host, g16)
    counts_models = K.launch_counts()
    log("  -- the component and path models (scc, bc, sssp_path, "
        "delta_stepping, the host Dijkstra) and their nine apps")
    t0 = time.time()
    K.reset_launch_counts()
    paths_phase(torch, K, dev, apps, g, w, roots, bfs_res)
    counts_paths = K.launch_counts()
    log(f"  component and path models {time.time() - t0:.1f} s; launches "
        f"{counts_paths}")
    for name in ("segment_reduce_sorted", "plain_cumsum"):
        check(counts_paths[name] > 0, f"{name} launched by the component "
              f"and path models ({counts_paths[name]} times)")
    log("  -- the sampling family, -GMProfile and the output path")
    t0 = time.time()
    K.reset_launch_counts()
    sampling_phase(torch, K, dev, apps, g, g_host, path)
    counts_sampling = K.launch_counts()
    os.remove(path)
    log(f"  sampling, -GMProfile and the output path {time.time() - t0:.1f} "
        f"s; launches {counts_sampling}")
    check(counts_sampling["segment_reduce_sorted"] > 0,
          f"segment_reduce_sorted launched by the matching and the profiled "
          f"runs ({counts_sampling['segment_reduce_sorted']} times)")
    del g, g16, w, bfs_res      # phase 9 moves g_host to the card again
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    tri = triangle_phase(torch, dev, apps, native, from_edges, u_begin,
                         u_dst, src16, dst16)
    del u_begin, u_dst, src16, dst16
    counts_models = {name: counts_models[name] + counts_paths[name]
                     + counts_sampling[name] + n
                     for name, n in K.launch_counts().items()}
    log(f"  phase 7 launches {counts_models}")
    check(counts_models["triangle_search"] > 0, f"triangle_search launched "
          f"by this phase ({counts_models['triangle_search']} times)")
    for name in ("segment_reduce_sorted", "plain_cumsum"):
        check(counts_models[name] > 0, f"{name} launched by this phase "
              f"({counts_models[name]} times)")
        counts[name] += counts_models[name]

    # -- 8. the gather probes ----------------------------------------------
    log("== 8. gather probes (kernel == plain checked before each time)")
    torch.cuda.empty_cache()
    t0 = time.time()
    check_gather_designs(torch, K, dev)
    log(f"  design checks {time.time() - t0:.1f} s")
    K.reset_launch_counts()
    recs = probes.run(dev, log=lambda line: log("  " + line))
    torch.cuda.synchronize()
    counts_probe = K.launch_counts()
    log(f"  probe launches {counts_probe}")
    probe_errs = {}
    for name in ("take_along_blocks", "row_gather_checksum"):
        check(counts_probe[name] > 0, f"{name} launched by the probe "
              f"({counts_probe[name]} times)")
        counts[name] = counts_probe[name]
        probe_errs[name] = max(r["max_abs_err"] for r in recs
                               if r["probe"] == name)

    # -- 9. compiled .gm programs --------------------------------------------
    log(f"== 9. compiled .gm programs through the lowerer (card: {smi})")
    torch.cuda.empty_cache()
    t0 = time.time()
    counts_compiled = compiled_phase(torch, K, dev, apps, g_host, roots, smi)
    log(f"  compiled programs {time.time() - t0:.1f} s; launches "
        f"{counts_compiled}")
    check(counts_compiled["segment_reduce_sorted"] > 0,
          f"segment_reduce_sorted launched by the compiled programs "
          f"({counts_compiled['segment_reduce_sorted']} times)")
    for name, n in counts_compiled.items():
        counts[name] += n

    # -- 10. multi-device on one card -------------------------------------
    log(f"== 10. multi-device on one card: {SHARDS} shards (card: {smi})")
    torch.cuda.empty_cache()
    t0 = time.time()
    counts_sharded = sharded_phase(torch, K, dev, apps, g_host, roots, smi)
    log(f"  multi-device {time.time() - t0:.1f} s; launches "
        f"{counts_sharded}")
    for name in ("segment_reduce_sorted", "plain_cumsum"):
        check(counts_sharded[name] > 0, f"{name} launched by the sharded "
              f"runs ({counts_sharded[name]} times)")
    for name, n in counts_sharded.items():
        counts[name] += n

    # -- 11. graphs past 2^24 nodes ----------------------------------------
    log(f"== 11. graphs past 2^24 nodes: N={SCALE_N} E={SCALE_E} RMAT seed "
        f"{scale.SEED}, one device and {scale.SHARDS} shards (card: {smi})")
    torch.cuda.empty_cache()
    t0 = time.time()
    g_scale, scale_times = scale_host.result()
    log(f"  edges drawn in {scale_times['t_gen_s']:.1f} s and frozen in "
        f"{scale_times['t_freeze_s']:.1f} s on the host thread (waited "
        f"{time.time() - t0:.1f} s for it)")
    scale_keep = {}                 # phase 13 runs on the same graph
    counts_scale = scale_phase(torch, K, dev, scale, g_scale, scale_times,
                               scale_keep)
    log(f"  graphs past 2^24 nodes {time.time() - t0:.1f} s; launches "
        f"{counts_scale}")
    check(counts_scale["segment_reduce_sorted"] > 0,
          f"segment_reduce_sorted launched by the runs past 2^24 nodes "
          f"({counts_scale['segment_reduce_sorted']} times)")
    for name, n in counts_scale.items():
        counts[name] += n

    # -- 12. compiled programs in lockstep ---------------------------------
    log(f"== 12. compiled programs in lockstep (CompiledProc.batch): "
        f"{BATCH_B} lanes at N={LJ_N} E={LJ_E} (card: {smi})")
    torch.cuda.empty_cache()
    t0 = time.time()
    counts_batch, lane_errs = batch_phase(torch, K, dev, g_host, smi)
    log(f"  lockstep programs {time.time() - t0:.1f} s; launches "
        f"{counts_batch}")
    for name in LANE_KERNELS:
        check(counts_batch[f"{name}[lanes]"] > 0,
              f"{name}[lanes] launched by the batched runs "
              f"({counts_batch[name + '[lanes]']} times)")
    for name in counts:
        counts[name] += counts_batch[name]

    # -- 13. the harness and the hot-path probes ---------------------------
    log(f"== 13. the harness and the hot-path probes: the placement matrix, "
        f"the scaling ladder, multihost_bench, the Twitter-class bit BFS, "
        f"the BFS phases and the preprocessing stages (card: {smi})")
    torch.cuda.empty_cache()
    t0 = time.time()
    counts_harness = harness_phase(torch, K, dev, native, g_host, g_scale,
                                   scale_keep)
    paged_launches = scale_keep["edge_map_bor"]
    del g_host, g_scale, scale_keep
    log(f"  harness and probes {time.time() - t0:.1f} s; launches "
        f"{counts_harness}")
    for name in ("segment_reduce_sorted", "plain_cumsum"):
        check(counts_harness[name] > 0, f"{name} launched by the harness "
              f"and the probes ({counts_harness[name]} times)")
    for name, n in counts_harness.items():
        counts[name] += n
    log(f"total {time.time() - t_all:.1f} s")

    errs = {"segment_reduce_sorted": seg_err, "plain_cumsum": float(cs_err),
            "segmented_scan": scan_err, **probe_errs}
    records = [
        {"name": name, "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": counts[name], "max_abs_err": errs[name]}
        for name in SOURCES] + [
        {"name": f"{name}[lanes]", "source": SOURCES[name],
         "replaces": REPLACES[name] + " (under jax.vmap)",
         "launches": counts_batch[f"{name}[lanes]"],
         "max_abs_err": lane_errs[f"{name}[lanes]"]}
        for name in LANE_KERNELS] + [
        {"name": "segment_reduce_sorted[gather]",
         "source": SOURCES["segment_reduce_sorted"],
         "replaces": "green_marl_tpu/models/relax.py:58 (the step's "
                     "gathers, add and mask, then the segment min)",
         "launches": counts["segment_reduce_sorted[gather]"],
         "max_abs_err": 0.0},
        {"name": "edge_map_bor",
         "source": "green_marl_tpu_torch/csrc/edge_map.cu",
         "replaces": "none: green_marl_tpu/ops/binned.py edge_map leaves "
                     "the row gather and the OR to XLA",
         "launches": paged_launches, "max_abs_err": 0.0},
        {"name": "edge_map_bor_level",
         "source": "green_marl_tpu_torch/csrc/edge_map.cu",
         "replaces": "none: green_marl_tpu/models/batched.py:370 "
                     "multi_source_bfs_bits leaves a level's edge map and "
                     "its update to XLA",
         "launches": bits_launches, "max_abs_err": 0.0},
        {"name": "bit_popstats",
         "source": "green_marl_tpu_torch/csrc/popstats.cu",
         "replaces": "none: green_marl_tpu/models/batched.py:340 "
                     "_bit_popstats leaves the bit expansion and the sums "
                     "to XLA",
         "launches": pop_launches, "max_abs_err": float(pop["max_err"])},
        {"name": "triangle_search",
         "source": "green_marl_tpu_torch/csrc/triangle.cu",
         "replaces": "none: green_marl_tpu/models/triangle.py:764 "
                     "_count_wedges (and :505 _count_wedges_shift) leave "
                     "the wedge search to XLA",
         **tri}]
    print(json.dumps({"kernels": [
        {**r, "route": "cuda", "timed_by": TIMED_BY[r["name"]]}
        for r in records]}))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


if __name__ == "__main__":
    try:
        device = main()
    except BaseException as e:
        status = (e.code if isinstance(e, SystemExit)
                  and isinstance(e.code, int) else 1)
        print(json.dumps({"ok": False, "phase": PHASE[0], "exit": status,
                          "error": f"{type(e).__name__}: {e}"[:500]}),
              flush=True)
        raise
    print(json.dumps({"ok": True, "phase": PHASE[0], "exit": 0,
                      "device": device}), flush=True)
