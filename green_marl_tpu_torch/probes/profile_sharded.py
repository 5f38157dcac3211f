"""Where the time of S shards of one program on one card goes.

Runs, on the RMAT graph of bench.py's LiveJournal-scale sizes (N=4.8M,
E=69M, seed 42, edges from ``native/gm_io.cc``, as ``chip_smoke.py``), each
single-device model beside its sharded run on S shards that share the card
(``GM_TORCH_VIRTUAL_DEVICES=S``): pagerank and ``pagerank_vsharded``,
hop_dist and ``hop_dist_vsharded`` from the node of highest out-degree,
``multi_bfs_vsharded`` at B=64, and the compiled pagerank.gm on one device,
vertex-sharded (``run_vertex_sharded``) and edge-sharded
(``distribute.run_sharded``).  Each run once more after a warm-up, under
``torch.profiler``; one JSON object per run: its host time (clock around
the call, ending in a synchronize), the device time of all its kernels and
that time by kernel group (``probes.profile_apps``), the device's idle
share of the host time, the kernel launches and the collectives a shard
called (``parallel.comm.COUNTS``).  The host partition builds are timed
first.

Run on a machine with an NVIDIA GPU::

    python -m green_marl_tpu_torch.probes.profile_sharded [--shards S]

Without a GPU the probe exits with an error: it measures the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import torch

from .profile_apps import (LJ_E, LJ_N, LJ_SEED, SHARED, by_group,
                           device_times, shared_kernel_by_op)

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probes.profile_sharded: needs an NVIDIA GPU")
    from ..graph import native
    from ..graph.csr import from_edges
    from ..lang import distribute as D
    from ..lang import lower_vertex as LV
    from ..lang.lower import compile_source
    from ..models.hop_dist import hop_dist
    from ..models.pagerank import pagerank
    from ..ops import kernels as K
    from ..parallel import comm
    from ..parallel import vertex_sharded as V
    from ..utils.timing import card as card_of

    S = args.shards
    os.environ[comm.VIRTUAL_ENV] = str(S)
    dev = torch.device("cuda")
    card = card_of(dev)
    src, dst = native.rmat_edges(LJ_N, LJ_E, seed=LJ_SEED)
    g_host, _ = from_edges(src, dst, LJ_N)
    del src, dst
    t0 = time.perf_counter()
    vsg = V.build_vertex_sharded(g_host, S)
    t1 = time.perf_counter()
    sched = LV.build_schedule(g_host, S)
    t2 = time.perf_counter()
    print(json.dumps({"card": card, "shards": S,
                      "build_vertex_sharded_s": t1 - t0,
                      "build_schedule_s": t2 - t1, "E_s": sched.E_s,
                      "cap": sched.cap, "L": sched.L}), flush=True)
    mesh = comm.vmesh(S)
    vsg = V.place(vsg, mesh)
    sched = LV.place_schedule(sched, mesh)
    g = g_host.to(dev)
    root = int(torch.argmax(g.out_degree()[:LJ_N]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pr = compile_source(PAGERANK_GM)
    roots = torch.argsort(g.out_degree()[:LJ_N], descending=True)[:64]
    kw = dict(e=1e-7, d=0.85, max=100)
    runs = (
        ("pagerank", lambda: pagerank(g)),
        ("pagerank_vsharded", lambda: V.pagerank_vsharded(vsg, mesh)),
        ("hop_dist", lambda: hop_dist(g, root)),
        ("hop_dist_vsharded", lambda: V.hop_dist_vsharded(vsg, mesh, root)),
        ("multi_bfs_vsharded B=64", lambda: V.multi_bfs_vsharded(
            vsg, mesh, roots.cpu().numpy())),
        ("pagerank.gm one device", lambda: pr(g, **kw)),
        ("pagerank.gm distribute", lambda: LV.run_vertex_sharded(
            pr, g, mesh=mesh, sched=sched, **kw)),
        ("pagerank.gm replicate", lambda: D.run_sharded(pr, g, mesh=mesh,
                                                        **kw)))
    for name, fn in runs:
        fn()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        K.reset_launch_counts()
        comm.reset_counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        times = device_times(prof)
        device_ms = sum(times.values())
        # the shared gather/scatter kernel is split by the operators that
        # launched it only where the profile saw all of them (the shards'
        # threads may go unrecorded on the host side)
        shared = shared_kernel_by_op(prof)
        shared_ms = sum(ms for k, ms in times.items()
                        if SHARED in k.lower())
        if sum(shared.values()) < 0.99 * shared_ms:
            shared = None
        print(json.dumps({
            "run": name, "card": card, "host_ms": plain_ms,
            "host_ms_under_profiler": host_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / host_ms,
            "launches": K.launch_counts(),
            "collectives_a_shard": dict(comm.COUNTS),
            "by_group_ms": by_group(times, shared)}),
            flush=True)


if __name__ == "__main__":
    main()
