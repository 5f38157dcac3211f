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
4. the same three apps on an RMAT graph of bench.py's LiveJournal-scale
   size (N=4.8M, E=69M, seed 42) written to a BIN file, then BFS from the
   four highest-degree nodes, checked against hop_dist and sssp;
5. one PageRank superstep's pull-sum on that graph, kernel against plain,
   the graph's in-degree picture, and each kernel's time at that graph's
   shapes beside its plain version, its bound (the bytes it must move over
   the card's 3.35 TB/s) and, where one PyTorch call computes the same
   function, that call's time (``torch.segment_reduce``, ``torch.cumsum``:
   yardsticks that the port never calls), with ``segment_sum_by_offsets``
   (BFS's pull sweep) timed beside its earlier inclusive-scan-and-copy
   form;
6. the batched engine on that graph: the ``multi_bfs`` CLI at bench.py's
   headline B=4096, plane_bits=32; then, on one binned schedule, the bit
   BFS (instances 0-3 against hop_dist), the binned BFS at B=8 (distances
   equal hop_dist's) and the binned PageRank at B=128 (the d=0.85 instance
   against pagerank), with aggregate GTEPS, Gedge/s and the memory peak;
7. the gather probes (``python -m green_marl_tpu_torch.probes.gather``):
   each probe kernel against its plain version, and their times.

Each path's kernel launches are counted from 0 just before it and read just
after: phase 2's segmented scan, phases 3-4 (the main path), phase 6 (no
kernel of the port: the engine's edge map is plain PyTorch) and phase 7.
The last two lines are a JSON record of the kernels and the JSON status
line.  Exits non-zero, with no result, where CUDA is unavailable.
"""

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

# parity10k goldens: JAX CLI on the CPU; hop_dist matches the reference
# binary bit for bit (BASELINE.md:78)
GOLD_HOP_CRC16 = "0x5003"
GOLD_SSSP_CRC16 = "0x8e4e"
GOLD_SSSP_DIST = [0, 141, 114, 170]
GOLD_RANK = [0.000078454, 0.000063880, 0.000108653, 0.000057279]
RANK_RTOL = 1e-4        # device tolerance of scripts/parity.py:85

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


def log(msg):
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


def launched_since(K, before):
    """The kernels launched since ``before = K.launch_counts()``, by name."""
    return {name: n - before[name] for name, n in K.launch_counts().items()
            if n != before[name]}


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
    so = _build.build()
    _build.lib()
    log(f"kernel build: {time.time() - t0:.2f} s -> "
        f"{os.path.relpath(so, ROOT)}")
    t0 = time.time()
    native.lib()       # raises if native/gm_io.cc does not build
    log(f"native host library build: {time.time() - t0:.2f} s")

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

    log(f"== 4. LiveJournal-scale RMAT N={LJ_N} E={LJ_E} seed={LJ_SEED}")
    log("  edges from native/gm_io.cc's RMAT: the same sizes and "
        "parameters as bench.py, not bench.py's numpy edge stream")
    t0 = time.time()
    src, dst = native.rmat_edges(LJ_N, LJ_E, seed=LJ_SEED)
    begin, csr_dst = native.build_csr(src, dst, LJ_N)[:2]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"rmat_lj_seed{LJ_SEED}.bin")
    binary_io.store_binary(path, begin, csr_dst)
    del csr_dst
    log(f"  generated and wrote {os.path.relpath(path, ROOT)} "
        f"({os.path.getsize(path) / 1e6:.0f} MB) in {time.time() - t0:.1f} s")
    app_ms, app_crc = {}, {}
    for app, name in (("pagerank", "rank"), ("hop_dist", "dist"),
                      ("sssp", "dist")):
        t0 = time.time()
        out = run_cli(apps, [app, "-GMMeasureTime=1", "-GMDevice=cuda",
                             path])
        app_ms[app] = float(field(out, r"^running time=(\S+)"))
        app_crc[app] = field(out, rf"^CRC {name} (\S+)")
        log(f"  {app}: running time {app_ms[app]:.1f} ms, whole CLI call "
            f"{time.time() - t0:.1f} s")

    t0 = time.time()
    g, _ = from_edges(src, dst, LJ_N)
    g = g.to(dev)
    del src, dst
    log(f"  graph on the card in {time.time() - t0:.1f} s "
        f"(n_pad={g.n_pad} e_pad={g.e_pad})")
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    w = np.zeros(g.e_pad, np.int32)
    w[:g.num_edges] = sssp_edge_lengths(g.num_edges)
    w = torch.from_numpy(w).to(dev)
    # the CLI's outputs are the library's: the checks below hold for them
    for app, fn in (("pagerank", lambda: pagerank(g)),
                    ("hop_dist", lambda: hop_dist(g, 0)),
                    ("sssp", lambda: sssp(g, 0, w))):
        before = K.launch_counts()
        ev0.record()
        res = fn()
        ev1.record()
        ev1.synchronize()
        arr = (res.rank if app == "pagerank" else res.dist)[:LJ_N].cpu()
        check(array_checksum_hex(arr.numpy()) == app_crc[app],
              f"{app} in-process output == CLI output (CRC "
              f"{app_crc[app]}; {res.iterations} supersteps, "
              f"{ev0.elapsed_time(ev1):.1f} ms; kernel launches in this "
              f"run {launched_since(K, before)})")
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
    log(f"  LJ app running times (CLI, host clock, ms): {app_ms}")
    del pulled, cand, bits, s_kernel, s_ref, s_ref64, contrib, out_deg

    # -- 6. the batched engine --------------------------------------------
    log(f"== 6. batched engine on the LJ-scale graph (card: {smi})")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.time()
    out = run_cli(apps, ["multi_bfs", "-GMDevice=cuda",
                         f"-num_roots={MULTI_B}", f"-plane_bits={PLANE_BITS}",
                         path])
    m = re.search(r"^batched bfs: B=(\d+) levels=(\d+) traversed=(\d+) "
                  r"aggregate=(\S+) GTEPS", out, re.M)
    cli_levels, cli_trav, cli_gteps = int(m[2]), int(m[3]), float(m[4])
    check(int(m[1]) == MULTI_B and cli_trav > 0,
          f"multi_bfs CLI B={MULTI_B} plane_bits={PLANE_BITS}: "
          f"{cli_levels} levels, traversed={cli_trav}, {cli_gteps} GTEPS "
          f"(host clock), whole CLI call {time.time() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    os.remove(path)

    t0 = time.time()
    bp = binned.binned_in(g).to(dev, with_edges=False)
    n = bp.n_nodes
    out_deg_np = g.out_degree().cpu().numpy()[:n]
    deg_rows_np = np.zeros(bp.n_rows, np.int32)
    deg_rows_np[:n] = out_deg_np[bp.perm.cpu().numpy()]
    deg_rows = torch.from_numpy(deg_rows_np).to(dev)
    order = np.argsort(out_deg_np)[::-1]
    log(f"  binned schedule built and moved in {time.time() - t0:.1f} s: "
        f"{len(bp.bins)} bins, {bp.slot_src.numel()} slots "
        f"({bp.slot_src.numel() / g.num_edges:.3f} x E), {bp.n_hub} hubs "
        f"in {bp.n_hub_chunks} chunks")
    check([int(r) for r in order[:4]] == roots,
          "the engine's four highest-degree roots are phase 4's")
    chunk = binned.slot_chunk_for(MULTI_B // 8)
    ev0.record()
    res = batched.multi_source_bfs_bits(bp, order[:MULTI_B], deg_rows,
                                        plane_bits=PLANE_BITS,
                                        slot_chunk=chunk)
    ev1.record()
    ev1.synchronize()
    bits_ms = ev0.elapsed_time(ev1)
    trav = res.traversed.cpu().numpy()
    reached = res.reached.cpu().numpy()
    gteps = float(trav.sum()) / bits_ms / 1e6
    check(int(trav.sum()) == cli_trav and res.levels_run == cli_levels,
          f"multi_source_bfs_bits B={MULTI_B}: traversed {int(trav.sum())} "
          f"and {res.levels_run} levels equal the CLI's; {bits_ms:.1f} ms "
          f"(CUDA events), {gteps:.2f} GTEPS aggregate")
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
    del bp, deg_rows, g

    # -- 7. the gather probes ----------------------------------------------
    log("== 7. gather probes (kernel == plain checked before each time)")
    torch.cuda.empty_cache()
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
