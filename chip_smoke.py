#!/usr/bin/env python3
"""Drive green_marl_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

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
   in-process output equal to the CLI's); then the apps in process on the
   RMAT graph of the full size (N=4.8M, E=69M, seed 42), built in memory
   (its edges are drawn on a host thread while phases 1-3 run) and timed
   over the region the CLI times (a warm-up run, then the host clock from
   the call to the result on the host) beside CUDA events; then BFS from
   the four highest-degree nodes, checked against hop_dist and sssp;
5. one PageRank superstep's pull-sum on that graph, kernel against plain,
   the graph's in-degree picture, and each kernel's time at that graph's
   shapes beside its plain version, its bound (the bytes it must move over
   the card's 3.35 TB/s) and, where one PyTorch call computes the same
   function, that call's time (``torch.segment_reduce``, ``torch.cumsum``:
   yardsticks that the port never calls), with ``segment_sum_by_offsets``
   (BFS's pull sweep) timed beside its earlier inclusive-scan-and-copy
   form;
6. the batched engine: the ``multi_bfs`` CLI at bench.py's headline
   B=4096, plane_bits=32 on the 1/16-size file, equal to the in-process
   run there; then on the full-size graph, on one binned schedule, the bit
   BFS (instances 0-3 against hop_dist), the binned BFS at B=8 (distances
   equal hop_dist's) and the binned PageRank at B=128 (the d=0.85 instance
   against pagerank), with aggregate GTEPS, Gedge/s and the memory peak;
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
   the host DAG build in seconds, and ``count_dag`` (the sort-merge join,
   by the threshold) equal to the search path on the same ``DagContext``,
   each with its device time, Mwedges/s and memory peak.  At the 1/16 size,
   symmetrised with ``dedup=True``: ``triangle_count``, the search, the
   join and ``triangle_count_literal`` agree, and all four agree with
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

Each path's kernel launches are counted from 0 just before it and read just
after: phase 2's segmented scan, phases 3-4 (the main path), phase 6 (no
kernel of the port: the engine's edge map is plain PyTorch), phase 7 (with
the component and path models and the sampling family counted on their own
too) and phase 8.
The last two lines are a JSON record of the kernels and the JSON status
line.  Exits non-zero, with no result, where CUDA is unavailable.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import re
import subprocess
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

HBM_BYTES_PER_MS = 3.35e9          # H100 SXM data sheet: 3.35 TB/s
MULTI_B, PLANE_BITS = 4096, 32     # bench.py:53-54, the headline
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
# the probe lines whose times stand in the kernels record
PROBE_TIMED = {"take_along_blocks": "axis0 [1024,128]",
               "row_gather_checksum": "rowB=512 K=8"}


T_START = time.time()


def log(msg):
    if msg.startswith("== "):     # a phase's heading: when it began
        msg += f"  [at {time.time() - T_START:.1f} s]"
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: FAILED: {what}")
    log(f"  ok: {what}")


def cuda_ms(torch, fn, reps=10):
    """Mean device time of ``fn`` in ms over ``reps`` launches (CUDA
    events), after one warm-up launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        torch.cuda.synchronize()
        ev0.record()
        out = fn()
        ev1.record()
        ev1.synchronize()
        return out, ev0.elapsed_time(ev1)

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
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        """(result, CUDA-event ms, segment-reduce launches) of one call."""
        before = K.launch_counts()["segment_reduce_sorted"]
        torch.cuda.synchronize()
        ev0.record()
        out = fn()
        ev1.record()
        ev1.synchronize()
        return (out, ev0.elapsed_time(ev1),
                K.launch_counts()["segment_reduce_sorted"] - before)

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
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    def timed(fn):
        """(result, CUDA-event ms, segment-reduce launches) of one call."""
        before = K.launch_counts()["segment_reduce_sorted"]
        torch.cuda.synchronize()
        ev0.record()
        out = fn()
        ev1.record()
        ev1.synchronize()
        return (out, ev0.elapsed_time(ev1),
                K.launch_counts()["segment_reduce_sorted"] - before)

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
    from green_marl_tpu_torch.probes.triangle import count_paths

    # the full size: host DAG build, then the join against the search
    secs = {"build_dag": [], "desc_layout": []}
    real = {k: timed_calls(native, k, v) for k, v in secs.items()}
    t0 = time.time()
    ctx = triangle.dag_to_device(
        triangle.build_dag_host(u_begin, u_dst, LJ_N), dev)
    log(f"  full size, {u_dst.shape[0]} undirected slots: host DAG build "
        f"{time.time() - t0:.1f} s (gm_build_dag, serial, "
        f"{sum(secs['build_dag']):.1f} s; the rest numpy and the upload); "
        f"D={ctx.num_dag_edges} wedges={ctx.num_wedges}")
    check(ctx.num_wedges >= triangle._HASH_MIN_W,
          f"{ctx.num_wedges} wedges >= 2^26: count_dag routes to the "
          "sort-merge join")
    res = count_paths(ctx, ["routed", "search"],
                      log=lambda m: log("  " + m))
    check(res["routed"][0] == res["search"][0] > 0,
          f"full size: count_dag (sort-merge join) == search path == "
          f"{res['routed'][0]} triangles (gm_desc_layout, serial, "
          f"{sum(secs['desc_layout']):.1f} s of the join's time)")
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
    multi = triangle.count_search(triangle.dag_to_device(
        triangle.build_dag_host(h_begin, h_dst, SMALL_N), dev))
    log(f"  1/16 size: simple undirected graph of {gu.num_edges} slots "
        f"({h_dst.shape[0]} with parallel edges) built in "
        f"{time.time() - t0:.1f} s")
    ctx = triangle.build_dag(gu)
    t0 = time.time()
    counts = {"triangle_count": triangle.triangle_count(gu),
              "search": triangle.count_search(ctx),
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
    from green_marl_tpu_torch.utils.crc import array_checksum_hex
    from green_marl_tpu_torch.utils.gm_rand import sssp_edge_lengths

    dev = torch.device("cuda")
    t_all = time.time()

    # -- 1. card and build ------------------------------------------------
    log("== 1. card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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
    pool = concurrent.futures.ThreadPoolExecutor(1)
    lj_host = pool.submit(host_graph, native, from_edges, LJ_N, LJ_E, LJ_SEED)
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
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    def edge_weights(g):
        w = np.zeros(g.e_pad, np.int32)
        w[:g.num_edges] = sssp_edge_lengths(g.num_edges)
        return torch.from_numpy(w).to(dev)

    w16 = edge_weights(g16)
    for app, name, fn in (
            ("pagerank", "rank", lambda: pagerank(g16).rank),
            ("hop_dist", "dist", lambda: hop_dist(g16, 0).dist),
            ("sssp", "dist", lambda: sssp(g16, 0, w16).dist)):
        t0 = time.time()
        out = run_cli(apps, [app, "-GMMeasureTime=1", "-GMDevice=cuda",
                             path])
        crc = field(out, rf"^CRC {name} (\S+)")
        cli_ms = float(field(out, r"^running time=(\S+)"))
        check(array_checksum_hex(fn()[:SMALL_N].cpu().numpy()) == crc,
              f"{app} at the 1/16 size: in-process output == CLI output (CRC "
              f"{crc}); CLI running time {cli_ms:.1f} ms, whole CLI call "
              f"{time.time() - t0:.1f} s")
    del w16

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
        ev0.record()
        res = fn()
        ev1.record()
        arr = (res.rank if app == "pagerank" else res.dist).cpu().numpy()
        app_ms[app] = 1000 * (time.time() - t0)
        arr = torch.from_numpy(arr[:LJ_N])
        log(f"  {app} at the full size: {app_ms[app]:.1f} ms by the host "
            f"clock (the call to the result on the host), "
            f"{ev0.elapsed_time(ev1):.1f} ms by CUDA events; "
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
        ev0.record()
        res = bfs(g, r)
        ev1.record()
        ev1.synchronize()
        bfs_res[r] = res
        log(f"  bfs root={r}: levels={res.levels_run} "
            f"reached={res.reached} {ev0.elapsed_time(ev1):.1f} ms; kernel "
            f"launches in this run {launched_since(K, before)}")
    hd_dist = {}
    for r in roots:
        ev0.record()
        hd = hop_dist(g, r)
        ev1.record()
        ev1.synchronize()
        hd_dist[r] = hd.dist
        lv = bfs_res[r].level
        same = torch.equal(torch.where(lv >= 0, lv, INT32_MAX), hd.dist)
        check(same, f"root {r}: bfs levels == hop_dist distances "
              f"(hop_dist {hd.iterations} supersteps, "
              f"{ev0.elapsed_time(ev1):.1f} ms)")
    ev0.record()
    sp = sssp(g, roots[0], w)
    ev1.record()
    ev1.synchronize()
    hd = hop_dist(g, roots[0])
    check(bool((sp.dist >= hd.dist).all()),
          f"root {roots[0]}: sssp >= hop_dist everywhere "
          f"(sssp {sp.iterations} supersteps, "
          f"{ev0.elapsed_time(ev1):.1f} ms)")
    check(torch.equal(sp.dist < INT32_MAX, hd.dist < INT32_MAX),
          f"root {roots[0]}: sssp and hop_dist reach the same nodes")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  main path {time.time() - t_main:.1f} s; launches {counts}; "
        f"device memory peak {peak_gb:.2f} GB")
    for name in ("segment_reduce_sorted", "plain_cumsum"):
        check(counts[name] > 0, f"{name} launched on the main path "
              f"({counts[name]} times)")
    counts["segmented_scan"] = scan_launches
    check(scan_launches > 0, f"segmented_scan launched in its phase "
          f"({scan_launches} times)")

    # -- 5. LJ shapes: kernel against plain, and times ---------------------
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
    times = {
        "segmented_scan": (
            cuda_ms(torch, lambda: K.segmented_scan(pulled, ids)),
            cuda_ms(torch, lambda: K.segmented_scan_ref(pulled, ids))),
        "segment_reduce_sorted": (
            cuda_ms(torch, lambda: K.segment_reduce_sorted(
                pulled, ids, offs, n_pad, "add")),
            cuda_ms(torch, lambda: K.segment_reduce_sorted_ref(
                pulled, ids, offs, n_pad, "add"))),
        "plain_cumsum": (
            cuda_ms(torch, lambda: K.plain_cumsum(bits)),
            cuda_ms(torch, lambda: K.plain_cumsum_ref(bits))),
    }
    min_ms = (cuda_ms(torch, lambda: K.segment_reduce_sorted(
                  cand, ids, offs, n_pad, "min")),
              cuda_ms(torch, lambda: K.segment_reduce_sorted_ref(
                  cand, ids, offs, n_pad, "min")))
    sbo_ms = (cuda_ms(torch, lambda: scan_reduce.segment_sum_by_offsets(
                  bits, offs, n_pad)),
              cuda_ms(torch, sum_by_offsets_cat))
    excl_ms = (cuda_ms(torch, lambda: K.plain_cumsum(bits, exclusive=True)),
               cuda_ms(torch, lambda: K.plain_cumsum_ref(bits,
                                                         exclusive=True)))
    # one PyTorch call that computes the same function, where there is one:
    # timed here as a yardstick, called nowhere in the port
    offs64 = offs.long()
    library_ms = {
        "segment_reduce_sorted": cuda_ms(torch, lambda: torch.segment_reduce(
            pulled, "sum", offsets=offs64)),
        "plain_cumsum": cuda_ms(torch, lambda: torch.cumsum(
            bits, 0, dtype=torch.int32)),
        "segmented_scan": None,
    }
    # the least the card could take: every input read once and every output
    # written once at the memory's rate (these kernels do no arithmetic to
    # speak of, so bytes bound them all)
    in_range = int(offs[-1]) - int(offs[0])     # slots that belong to a row
    bound_bytes = {
        "segment_reduce_sorted": 4 * in_range + 4 * offs.numel() + 4 * n_pad,
        "plain_cumsum": 8 * g.e_pad,
        "segmented_scan": 12 * g.e_pad,
    }
    in_deg = g.r_begin.diff()
    log(f"  LJ CSC in-degrees: max {int(in_deg.max())}, mean "
        f"{float(in_deg.float().mean()):.2f}, empty "
        f"{float((in_deg == 0).float().mean()):.3f}, under 8 slots "
        f"{float((in_deg < 8).float().mean()):.3f}, under 32 slots "
        f"{float((in_deg < 32).float().mean()):.3f} of {in_deg.numel()} "
        "segments")
    for name in bound_bytes:
        lib_ms = library_ms[name]
        log(f"  {name}: bound {bound_bytes[name] / 1e6:.1f} MB = "
            f"{bound_bytes[name] / HBM_BYTES_PER_MS:.3f} ms at 3.35 TB/s; "
            f"kernel {times[name][0]:.3f} ms; one PyTorch call "
            + ("none" if lib_ms is None else f"{lib_ms:.3f} ms"))
    del offs64, in_deg
    log(f"  card: {smi}")
    log(f"  segment_reduce_sorted float32 add, e_pad={g.e_pad} "
        f"n_out={n_pad}: kernel {times['segment_reduce_sorted'][0]:.3f} ms, "
        f"plain {times['segment_reduce_sorted'][1]:.3f} ms")
    log(f"  segment_reduce_sorted int32 min, same shape: kernel "
        f"{min_ms[0]:.3f} ms, plain {min_ms[1]:.3f} ms")
    log(f"  plain_cumsum int32 n={g.e_pad}: kernel "
        f"{times['plain_cumsum'][0]:.3f} ms, plain "
        f"{times['plain_cumsum'][1]:.3f} ms")
    log(f"  plain_cumsum exclusive int32, same n: kernel {excl_ms[0]:.3f} "
        f"ms, plain (torch.cumsum + cat) {excl_ms[1]:.3f} ms")
    log(f"  segment_sum_by_offsets int32 0/1, e_pad={g.e_pad} n_out={n_pad}"
        f": {sbo_ms[0]:.3f} ms (exclusive scan); {sbo_ms[1]:.3f} ms "
        "(inclusive scan + torch.cat copy, the form before)")
    log(f"  segmented_scan float32 add, n={g.e_pad} CSC ids: kernel "
        f"{times['segmented_scan'][0]:.3f} ms, plain "
        f"{times['segmented_scan'][1]:.3f} ms")
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
    ev0.record()
    res = batched.multi_source_bfs_bits(bp, order[:MULTI_B], deg_rows,
                                        plane_bits=PLANE_BITS,
                                        slot_chunk=chunk)
    ev1.record()
    trav = res.traversed.cpu().numpy()      # where the CLI's clock stops
    host_s = time.time() - t0
    bits_ms = ev0.elapsed_time(ev1)
    reached = res.reached.cpu().numpy()
    gteps = float(trav.sum()) / bits_ms / 1e6
    check(int(trav.sum()) > 0,
          f"multi_source_bfs_bits B={MULTI_B} at the full size: traversed "
          f"{int(trav.sum())} in {res.levels_run} levels; {bits_ms:.1f} ms "
          f"(CUDA events), {gteps:.2f} GTEPS aggregate "
          f"({float(trav.sum()) / host_s / 1e9:.2f} by the host clock over "
          f"the region the CLI times); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for b, r in enumerate(roots):
        seen = (hd_dist[r][:n] < INT32_MAX).cpu().numpy()
        check(int(reached[b]) == int(seen.sum())
              and int(trav[b]) == int(out_deg_np[seen].astype(np.int64)
                                      .sum()),
              f"bit BFS instance {b} (root {r}): reached {int(reached[b])} "
              f"and traversed {int(trav[b])} equal hop_dist's reached set "
              f"and its out-degree sum")
    del res

    roots8 = [int(r) for r in order[:8]]
    for r in roots8[4:]:
        hd_dist[r] = hop_dist(g, r).dist
    ev0.record()
    res = batched.multi_source_bfs_binned(bp, roots8, slot_chunk=chunk)
    ev1.record()
    ev1.synchronize()
    dist = bp.from_binned(res.dist[:n])
    check(all(torch.equal(dist[:, b], hd_dist[r][:n])
              for b, r in enumerate(roots8)),
          f"multi_source_bfs_binned B=8: distances equal hop_dist's "
          f"exactly ({res.levels_run} levels, {ev0.elapsed_time(ev1):.1f} "
          f"ms)")
    del res, dist, hd_dist

    damp = 0.85 + 0.0005 * np.arange(PR_B, dtype=np.float32)
    ev0.record()
    res = batched.multi_pagerank_binned(bp, deg_rows[:n], damp, e=0.0,
                                        max_iter=PR_ITERS, slot_chunk=chunk)
    ev1.record()
    ev1.synchronize()
    pr_ms = ev0.elapsed_time(ev1)
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
        f"{counts_engine} (all by the hop_dist and pagerank references: "
        f"the edge map is plain PyTorch)")
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
    del g, g_host, g16, w, bfs_res
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    triangle_phase(torch, dev, apps, native, from_edges, u_begin, u_dst,
                   src16, dst16)
    del u_begin, u_dst, src16, dst16
    counts_models = {name: counts_models[name] + counts_paths[name]
                     + counts_sampling[name] + n
                     for name, n in K.launch_counts().items()}
    log(f"  phase 7 launches {counts_models}")
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
        rec = next(r for r in recs if r["probe"] == name
                   and r["name"] == PROBE_TIMED[name])
        times[name] = (rec["ms"], rec["plain_ms"])
        bound_bytes[name] = rec["bound_bytes"]
        library_ms[name] = rec["library_ms"]
        probe_errs[name] = max(r["max_abs_err"] for r in recs
                               if r["probe"] == name)
    row = next(r for r in recs if r["name"] == "row-broadcast [1024,128]")
    log(f"  take_along_blocks row-broadcast [1024,128] (warp per row): "
        f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, max abs "
        f"err {row['max_abs_err']}")
    log(f"total {time.time() - t_all:.1f} s")

    errs = {"segment_reduce_sorted": seg_err, "plain_cumsum": float(cs_err),
            "segmented_scan": scan_err, **probe_errs}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1],
         "bound_ms": bound_bytes[name] / HBM_BYTES_PER_MS,
         "bound_by": "bytes", "library_ms": library_ms[name]}
        for name in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
