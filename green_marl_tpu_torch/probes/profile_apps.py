"""Where the single-instance apps' device time goes, on the card.

Runs pagerank, hop_dist, sssp and BFS once each under ``torch.profiler``
(after a warm-up run) on the RMAT graph of bench.py's LiveJournal-scale
sizes (N=4.8M, E=69M, seed 42, edges from ``native/gm_io.cc``) and prints,
per app, its supersteps, its host time (clock around a run of its own,
ending in a synchronize, and around the profiled run), the device time of
all its kernels, and that time by group: the segment-reduce kernel, the
prefix sum, ``index_select`` gathers, scatters, elementwise passes,
reductions, copies.  PyTorch runs ``index_select``, ``gather`` and the
``scatter`` family through one device kernel
(``_scatter_gather_elementwise_kernel``), so that kernel's time is split by
the operator that launched each instance and each record lists the split.
hop_dist and sssp start at node 0, as the CLI does by default; BFS at the
node of highest out-degree.  One JSON object per line; the last lists, per
app, the five kernels that took the most time.

Run on a machine with an NVIDIA GPU::

    python -m green_marl_tpu_torch.probes.profile_apps

Without a GPU the probe exits with an error: it measures the card.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

LJ_N, LJ_E, LJ_SEED = 4_800_000, 69_000_000, 42   # bench.py:50-52

GATHERS, SCATTERS = "gathers (index_select)", "scatters"
SHARED = "scatter_gather"     # in the name of torch's kernel for both kinds
UNSPLIT = "gathers or scatters (one torch kernel)"
GATHER_KEYS = ("indexselect", "index_select", "gather", "take")
SCATTER_KEYS = ("scatter", "index_put", "indexput", "index_copy",
                "index_add", "indexfuncsmall", "indexfunclarge")

# (group, substrings of the kernel's name, lower case); the first match wins
GROUPS = (
    ("segment reduce", ("segment_reduce_kernel", "segment_reduce_lanes_kernel",
                        "tile_rows_kernel")),
    ("prefix sum", ("scan_kernel",)),
    ("copies and memsets", ("memcpy", "memset")),
    (GATHERS, GATHER_KEYS),
    (SCATTERS, SCATTER_KEYS),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "fill", "arange",
                     "where")),
)


def group_of(kernel_name: str, op_name: str = "") -> str:
    """The group a device kernel's name belongs to (``other`` if none).
    The kernel that torch shares between gathers and scatters goes by
    ``op_name``, the operator that launched it; without one it stays
    unsplit."""
    low = kernel_name.lower()
    if SHARED in low:
        op = op_name.lower()
        if any(k in op for k in SCATTER_KEYS):
            return SCATTERS
        if any(k in op for k in GATHER_KEYS):
            return GATHERS
        return UNSPLIT
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_times(prof) -> Dict[str, float]:
    """Kernel name -> device self time in ms, from a finished profile."""
    out: Dict[str, float] = {}
    cuda = torch.autograd.DeviceType.CUDA
    for k in prof.key_averages():
        if getattr(k, "device_type", cuda) != cuda:
            continue
        us = getattr(k, "self_device_time_total", None)
        if us is None:
            us = getattr(k, "self_cuda_time_total", 0.0)
        if us > 0:
            out[k.key] = out.get(k.key, 0.0) + us / 1e3
    return out


def shared_kernel_by_op(prof) -> Dict[str, float]:
    """Operator name -> device ms of the instances of torch's shared
    gather/scatter kernel that the operator launched."""
    out: Dict[str, float] = {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if SHARED in k.name.lower():
                out[e.name] = out.get(e.name, 0.0) + k.duration / 1e3
    return out


def by_group(times: Dict[str, float],
             shared_by_op: Dict[str, float] = None) -> Dict[str, float]:
    """Group -> device ms.  Where ``shared_by_op`` accounts for the shared
    gather/scatter kernel, its split replaces the kernel's own entry."""
    groups: Dict[str, float] = {}
    for name, ms in times.items():
        if shared_by_op and SHARED in name.lower():
            continue
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms
    for op, ms in (shared_by_op or {}).items():
        g = group_of(SHARED, op)
        groups[g] = groups.get(g, 0.0) + ms
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> None:
    if argv:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("probes.profile_apps: needs an NVIDIA GPU")
    from ..graph import native
    from ..graph.csr import from_edges
    from ..models.bfs import bfs
    from ..models.hop_dist import hop_dist
    from ..models.pagerank import pagerank
    from ..models.sssp import sssp
    from ..ops import kernels as K
    from ..utils.gm_rand import sssp_edge_lengths
    from ..utils.timing import card as card_of

    dev = torch.device("cuda")
    card = card_of(dev)
    src, dst = native.rmat_edges(LJ_N, LJ_E, seed=LJ_SEED)
    g, _ = from_edges(src, dst, LJ_N)
    del src, dst
    g = g.to(dev)
    root = int(torch.argmax(g.out_degree()[:LJ_N]))
    w = np.zeros(g.e_pad, np.int32)
    w[:g.num_edges] = sssp_edge_lengths(g.num_edges)
    w = torch.from_numpy(w).to(dev)

    apps = (("pagerank", lambda: pagerank(g), "iterations"),
            ("hop_dist", lambda: hop_dist(g, 0), "iterations"),
            ("sssp", lambda: sssp(g, 0, w), "iterations"),
            ("bfs", lambda: bfs(g, root), "levels_run"))
    top: Dict[str, List] = {}
    for name, fn, steps in apps:
        fn()                                   # warm-up: builds, allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        K.reset_launch_counts()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        times = device_times(prof)
        shared = shared_kernel_by_op(prof)
        top[name] = sorted(((round(ms, 3), k[:90]) for k, ms in
                            times.items()), reverse=True)[:5]
        print(json.dumps({
            "app": name, "card": card,
            "root": root if name == "bfs" else 0,
            "supersteps": int(getattr(res, steps)),
            "host_ms": plain_ms, "host_ms_under_profiler": host_ms,
            "device_ms": sum(times.values()),
            "launches": K.launch_counts(),
            "shared_gather_scatter_kernel_by_op_ms": shared,
            "by_group_ms": by_group(times, shared)}), flush=True)
    print(json.dumps({"top_kernels": top}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
