"""Multi-process scaling curve: the port of ``scripts/multihost_bench.py``.

    python -m green_marl_tpu_torch.harness.multihost_bench [quick | lj]
        [--device cuda|cpu] [--iters K] [--sizes N:E,...]
    python -m green_marl_tpu_torch.harness.multihost_bench worker
        PID NPROCS PORT N E ITERS DEVICE

Times vertex-sharded PageRank (``parallel.vertex_sharded.pagerank_vsharded``,
``ITERS = 40`` supersteps, ``multihost_bench.py:34``) over four shards on
graphs of :data:`SIZES` (``multihost_bench.py:35-37``; ``quick``: the
largest only; ``lj``: N=4.8M, E=69M), arranged as

* 1 process x 4 shards: threads of ``parallel.comm``, no process group;
* 2 processes x 2 shards and 4 processes x 1 shard: ``parallel.multihost``
  workers, every collective through ``torch.distributed``.

``eff_N = t_1proc / t_Nproc`` isolates the cost of the process boundary.
On the CPU (``--device cpu``) the workers join over gloo.  On the card the
threads row runs, then a row of one NCCL rank of 4 shards
(``multihost.init(addr, 1, 0, local_device_ids=[0] * 4)``); a row of k
NCCL ranks needs k cards, one a rank, and where the machine has fewer it is
printed as ``not run`` and reported as such, never as a time.

Each run prints its iterations and, for each shard it owns, an
order-independent checksum of the shard's rows: ``fold``, the sum mod 2^64
of ``bits(rank[v]) * (2v + 1)``, and ``wsum``, the float64 sum of
``rank[v] * (v % 1024 + 1)``.  Every arrangement must give the same
iterations and the same checksums, shard for shard (the ranks are bit for
bit the same however the shards are spread); the run exits 1 otherwise.

Graphs: ``generate.rmat_edges(n, e, seed=13)`` (numpy); ``lj`` reads
``data/rmat_lj.npz`` (bench.py's cache) where it exists, else draws
bench.py's stream ``generate.rmat_edges(4_800_000, 69_000_000, seed=42)``
(``bench.py:239``) and saves it there.  It never takes another graph.
Times: the host clock around the second of two runs (the first is a warm
run, ``multihost_bench.py:58-66``), with a synchronize on the card, and
CUDA events beside it there.  Prints the card's name and power limit first
and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

ITERS = 40
SIZES = [(100_000, 1_000_000), (400_000, 4_000_000),
         (1_000_000, 10_000_000), (2_000_000, 20_000_000)]
LJ_SIZE = (4_800_000, 69_000_000)
SHARDS = 4
SEED, LJ_SEED = 13, 42
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LJ_EDGES = os.path.join(REPO, "data", "rmat_lj.npz")
WORKER_TIMEOUT = 1800
LINE_RE = re.compile(r"^MHBENCH (.*)$")


def edges(n: int, e: int):
    """The bench's edge list of size (n, e)."""
    from ..graph import generate as gen
    if (n, e) != LJ_SIZE:
        return gen.rmat_edges(n, e, seed=SEED)
    if os.path.exists(LJ_EDGES):
        z = np.load(LJ_EDGES)
        return z["src"], z["dst"]
    src, dst = gen.rmat_edges(n, e, seed=LJ_SEED)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    os.makedirs(os.path.dirname(LJ_EDGES), exist_ok=True)
    np.savez(LJ_EDGES, src=src, dst=dst)
    return src, dst


def build(n: int, e: int):
    """The host partition of the bench's graph into 4 vertex shards."""
    from ..graph.csr import from_edges
    from ..parallel import vertex_sharded as V
    src, dst = edges(n, e)
    g, _ = from_edges(src, dst, n)
    return V.build_vertex_sharded(g, SHARDS)


def checksums(rank: torch.Tensor, first_shard: int, count: int, L: int,
              n: int) -> List[Dict]:
    """Per shard of ``count`` consecutive ones from ``first_shard`` (``rank``
    holds their rows, L a shard, cut at N): ``{"shard", "fold", "wsum"}``
    over the shard's rows below N."""
    r = rank.detach().cpu().numpy().astype(np.float32)
    out = []
    for k in range(count):
        t = first_shard + k
        vals = r[k * L:(k + 1) * L]
        gid = t * L + np.arange(len(vals), dtype=np.int64)
        own = gid < n
        vals, gid = vals[own], gid[own]
        fold = int((vals.view(np.uint32).astype(np.uint64)
                    * (2 * gid + 1).astype(np.uint64)).sum(dtype=np.uint64))
        wsum = float(np.sum(vals.astype(np.float64)
                            * (gid % 1024 + 1).astype(np.float64)))
        out.append({"shard": t, "fold": f"{fold:016x}", "wsum": wsum})
    return out


def time_pagerank(vsg, mesh, dev: torch.device, iters: int):
    """A warm run (e=0), then the timed one (e=1e-30,
    ``multihost_bench.py:58-66``): ``(rank, iterations, host s, device ms)``
    of the timed run."""
    from ..parallel import vertex_sharded as V
    from ..utils.timing import timed
    V.pagerank_vsharded(vsg, mesh, e=0.0, d=0.85, max_iter=iters)
    (rank, _, it), host_ms, dev_ms = timed(
        lambda: V.pagerank_vsharded(vsg, mesh, e=1e-30, d=0.85,
                                    max_iter=iters), dev)
    return rank, int(it), host_ms / 1000, dev_ms


def _record(nprocs, pid, it, dt, dev_ms, shards, launches) -> Dict:
    return {"pid": pid, "nprocs": nprocs, "iters": it, "time_s": dt,
            "device_ms": dev_ms, "shards": shards,
            "segment_reduce_launches": launches}


def threads_row(vsg_h, dev: torch.device, iters: int) -> Dict:
    """1 process x 4 shards as threads of ``parallel.comm``."""
    from ..ops import kernels as K
    from ..parallel import comm
    from ..parallel import vertex_sharded as V
    mesh = comm.Mesh([dev] * SHARDS, ("v",))
    vsg = V.place(vsg_h, mesh)
    before = K.launch_counts()["segment_reduce_sorted"]
    rank, it, dt, dev_ms = time_pagerank(vsg, mesh, dev, iters)
    launches = K.launch_counts()["segment_reduce_sorted"] - before
    return _record(1, 0, it, dt, dev_ms,
                   checksums(rank, 0, SHARDS, vsg.L, vsg.num_nodes), launches)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_run(vsg_h, pid: int, nprocs: int, port: int, dev: torch.device,
             iters: int) -> Dict:
    """This process's part of a ``torch.distributed`` run of ``nprocs``
    processes with ``4 // nprocs`` shards each: gloo on the CPU, NCCL on
    the card ``pid`` (all of this rank's shards on it)."""
    from ..ops import kernels as K
    from ..parallel import multihost as mh
    local = SHARDS // nprocs
    if dev.type == "cuda":
        mh.init(f"127.0.0.1:{port}", nprocs, pid,
                local_device_ids=[pid] * local)
    else:
        mh.init(f"127.0.0.1:{port}", nprocs, pid, local_cpu_devices=local)
    try:
        import torch.distributed as dist
        if dev.type == "cuda":
            # NCCL sets its communicator up at the first collective
            dist.barrier(device_ids=[pid])
        mesh = mh.global_mesh()
        vsg = mh.place_multihost(vsg_h, mesh)
        before = K.launch_counts()["segment_reduce_sorted"]
        rank, it, dt, dev_ms = time_pagerank(vsg, mesh, dev, iters)
        launches = K.launch_counts()["segment_reduce_sorted"] - before
        first = mesh.local_positions[0]
        sums = checksums(rank, first, local, vsg.L, vsg.num_nodes)
    finally:
        mh.shutdown()
    return _record(nprocs, pid, it, dt, dev_ms, sums, launches)


def worker(pid: int, nprocs: int, port: int, n: int, e: int, iters: int,
           device: str) -> None:
    """One process of a multi-process row: prints its ``MHBENCH`` line."""
    rec = dist_run(build(n, e), pid, nprocs, port, torch.device(device),
                   iters)
    print("MHBENCH " + json.dumps(rec), flush=True)


def multi_process(nprocs: int, n: int, e: int, iters: int,
                  device: str) -> List[Dict]:
    """``nprocs`` worker processes; their records by pid."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "green_marl_tpu_torch.harness.multihost_bench",
         "worker", str(pid), str(nprocs), str(port), str(n), str(e),
         str(iters), device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for pid in range(nprocs)]
    recs, fails = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            lines = [LINE_RE.match(ln) for ln in out.splitlines()]
            got = [json.loads(m.group(1)) for m in lines if m]
            if p.returncode != 0 or not got:
                fails.append(out[-3000:])
            recs += got
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if fails:
        raise RuntimeError(f"{nprocs}-process run failed:\n" + fails[0])
    return sorted(recs, key=lambda r: r["pid"])


def combine(name: str, recs: List[Dict]) -> Dict:
    """One arrangement's row from its processes' records: the slowest
    process's time, the iterations and the shards' checksums in order."""
    its = {r["iters"] for r in recs}
    shards = sorted((s for r in recs for s in r["shards"]),
                    key=lambda s: s["shard"])
    dev_ms = [r["device_ms"] for r in recs if r["device_ms"] is not None]
    return {"arrangement": name, "status": "ran",
            "iters": its.pop() if len(its) == 1 else sorted(its),
            "time_s": max(r["time_s"] for r in recs),
            "device_ms": max(dev_ms) if dev_ms else None,
            "segment_reduce_launches": sum(r["segment_reduce_launches"]
                                           for r in recs),
            "shards": shards,
            "wsum": float(sum(s["wsum"] for s in shards))}


def bench(n: int, e: int, dev: torch.device, iters: int = ITERS,
          log=print) -> Dict:
    """Every arrangement at one size; ``row["ok"]`` when each that ran
    gives the threads' iterations and checksums."""
    t0 = time.time()
    vsg_h = build(n, e)
    log(f"# N={n} E={e}: graph and partition {time.time() - t0:.1f} s")
    arr = [combine("1 process x 4 shards (threads)",
                   [threads_row(vsg_h, dev, iters)])]
    if dev.type == "cuda":
        arr.append(combine(
            "1 NCCL rank x 4 shards",
            [dist_run(vsg_h, 0, 1, _free_port(), dev, iters)]))
    del vsg_h
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    for k in (2, 4):
        name = f"{k} processes x {SHARDS // k} shards"
        if dev.type == "cuda" and cards < k:
            why = f"{k} NCCL ranks need {k} cards, {cards} present"
            log(f"  {name}: not run: {why}")
            arr.append({"arrangement": name, "status": "not run",
                        "why": why})
            continue
        arr.append(combine(name, multi_process(k, n, e, iters, dev.type)))
    ref = arr[0]
    row = {"n": n, "e": e, "arrangements": arr, "ok": True}
    for a in arr:
        if a["status"] != "ran":
            continue
        a["same_as_threads"] = (a["iters"] == ref["iters"]
                                and a["shards"] == ref["shards"])
        a["eff"] = ref["time_s"] / a["time_s"]
        row["ok"] &= a["same_as_threads"]
        log(f"  {a['arrangement']}: {a['time_s']:.3f} s"
            + (f" (device {a['device_ms']:.1f} ms)"
               if a["device_ms"] is not None else "")
            + f", iters {a['iters']}, eff {a['eff']:.3f}, wsum "
            f"{a['wsum']!r}, segment-reduce launches "
            f"{a['segment_reduce_launches']}, iterations and checksums "
            f"== the threads': {a['same_as_threads']}")
    return row


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "worker":
        pid, nprocs, port, n, e, iters = (int(x) for x in argv[1:7])
        worker(pid, nprocs, port, n, e, iters, argv[7])
        return 0
    from ..utils.timing import card, entry_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", choices=("full", "quick", "lj"),
                    default="full")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--sizes", help="N:E,... in place of the mode's sizes")
    args = ap.parse_args(argv)
    dev = entry_device("multihost_bench", args.device)
    smi = card(dev)
    print(f"# card: {smi}", flush=True)
    if args.sizes:
        sizes = [tuple(int(x) for x in s.split(":"))
                 for s in args.sizes.split(",")]
    else:
        sizes = {"full": SIZES, "quick": SIZES[-1:], "lj": [LJ_SIZE]}[
            args.mode]
    rows = [bench(n, e, dev, args.iters,
                  log=lambda m: print(m, flush=True)) for n, e in sizes]
    ok = all(r["ok"] for r in rows)
    print(json.dumps({"metric": "multiproc_scaling_efficiency_curve",
                      "device": str(dev), "card": smi, "iters": args.iters,
                      "devices": SHARDS, "rows": rows, "target": 0.8,
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
