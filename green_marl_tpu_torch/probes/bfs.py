"""The single-source BFS phase by phase: the port of ``scripts/probe_bfs.py``.

    python -m green_marl_tpu_torch.probes.bfs [--device cuda|cpu]
        [--generator native|numpy] [--nodes N --edges E]

On the LiveJournal-scale RMAT (N=4.8M, E=69M, seed 42; by default the
stream of ``native/gm_io.cc``, as ``chip_smoke.py`` and
``probes/profile_apps.py`` draw it, ``--generator numpy`` bench.py's own
``generate.rmat_edges`` stream; JAX's probe reads a cache of bench.py that
no one can rebuild here), three measurements:

1. one pull sweep over a half-full random frontier (``default_rng(0)``,
   ``probe_bfs.py:56-70``): a gather of the frontier along the CSC and
   ``ops.scan_reduce.segment_sum_by_offsets`` (the prefix-sum kernel);
2. ``models.bfs._push_expand`` at caps 4096, 65536 and 2^20, each on a
   frontier of cap/32 low-degree nodes (``:72-89``);
3. the full auto ``bfs`` from the 4 nodes of highest out-degree: the first
   gives the levels and the reached count, the other three the time
   (``:91-106``).

Each is timed as JAX times it, the fastest of 3 runs after a warm one;
the JAX probe XORs a salt into the frontier to defeat the TPU link's
memoization, which the port does not have.  Per phase: device ms (CUDA
events; the host clock on the CPU under ``host_ms``), the prefix-sum
launches of one run, and BFS's levels and reached count.  Prints the
card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

LJ_N, LJ_E, LJ_SEED = 4_800_000, 69_000_000, 42    # bench.py:50-52
PUSH_CAPS = (4096, 65536, 1 << 20)                 # probe_bfs.py:74


def rmat(n: int = LJ_N, e: int = LJ_E, generator: str = "native",
         seed: int = LJ_SEED):
    """The RMAT edges ``(src, dst)`` of ``generator``: ``native``
    (``native/gm_io.cc``) or ``numpy`` (``graph.generate``, bench.py's)."""
    from ..graph import generate, native
    gen = native.rmat_edges if generator == "native" else \
        generate.rmat_edges
    return gen(n, e, seed=seed)


def host_graph(n: int = LJ_N, e: int = LJ_E, generator: str = "native",
               seed: int = LJ_SEED):
    """``(Graph on the host, out-degrees [N], seconds)`` of :func:`rmat`."""
    from ..graph.csr import from_edges
    t0 = time.time()
    src, dst = rmat(n, e, generator, seed)
    g = from_edges(src, dst, n)[0]
    return g, np.diff(g.begin.numpy()), time.time() - t0


def pull_frontier(g) -> torch.Tensor:
    """The half-full random frontier of ``probe_bfs.py:56-57`` ([n_pad]
    bool on the host)."""
    return torch.from_numpy(np.random.default_rng(0).random(g.n_pad) < 0.5)


def pull_values(g, fr: torch.Tensor) -> torch.Tensor:
    """The pull sweep's int32 values: the frontier gathered along the CSC
    (``probe_bfs.py:65``)."""
    return fr.index_select(0, g.r_node_idx).to(torch.int32)


def pull(g, fr: torch.Tensor) -> torch.Tensor:
    """One pull sweep (``probe_bfs.py:63-67``): [n_pad] bool."""
    from ..ops import scan_reduce
    return scan_reduce.segment_sum_by_offsets(pull_values(g, fr), g.r_begin,
                                              g.n_pad) > 0


def push_frontier(g, out_deg: np.ndarray, cap: int) -> torch.Tensor:
    """cap/32 low-degree nodes, every fourth of the lowest degrees
    (``probe_bfs.py:75-79``): [n_pad] bool on the host."""
    nsel = max(1, cap // 32)
    ids = np.argsort(out_deg)[: nsel * 4: 4][:nsel]
    fr = np.zeros(g.n_pad, bool)
    fr[ids] = True
    return torch.from_numpy(fr)


def bfs_roots(out_deg: np.ndarray) -> np.ndarray:
    """The 4 nodes of highest out-degree (``probe_bfs.py:92``)."""
    return np.argsort(out_deg)[::-1][:4].astype(np.int32)


def _best(fn, dev, reps: int = 3) -> Dict:
    """``fn()`` warm, then ``reps`` runs: the fastest one's ms and the
    prefix-sum launches of one run."""
    from ..ops import kernels as K
    from ..utils.timing import timed
    fn()
    best = None
    for _ in range(reps):
        before = K.launch_counts()["plain_cumsum"]
        _, host_ms, dev_ms = timed(fn, dev)
        launches = K.launch_counts()["plain_cumsum"] - before
        if best is None or host_ms < best[0]:
            best = (host_ms, dev_ms)
    return {"host_ms": best[0], "ms": best[1],
            "plain_cumsum_launches": launches}


def measure(g_host, out_deg: np.ndarray, dev: torch.device,
            log=print) -> Dict:
    """The three measurements on ``g_host`` moved to ``dev``."""
    from ..models import bfs as B
    from ..ops import kernels as K
    from ..utils.timing import timed
    g = g_host.to(dev)
    rec = {}
    fr = pull_frontier(g).to(dev)
    rec["pull"] = _best(lambda: pull(g, fr), dev)
    log(f"pull sweep (int32 gather + segment sum): {rec['pull']}")
    del fr
    for cap in PUSH_CAPS:
        fr = push_frontier(g, out_deg, cap).to(dev)
        rec[f"push_{cap}"] = _best(lambda: B._push_expand(
            g, fr, g.begin, g.node_idx, cap), dev)
        log(f"push tier cap={cap}: {rec[f'push_{cap}']}")
    roots = bfs_roots(out_deg)
    res = B.bfs(g, int(roots[0]))
    rec["bfs"] = {"roots": roots.tolist(), "levels": res.levels_run,
                  "reached": res.reached}
    times = []
    for r in roots[1:]:
        before = K.launch_counts()["plain_cumsum"]
        out, host_ms, dev_ms = timed(lambda: B.bfs(g, int(r)), dev)
        times.append((host_ms, dev_ms, K.launch_counts()["plain_cumsum"]
                      - before, out.levels_run, out.reached))
    best = min(times, key=lambda t: t[0])
    rec["bfs"].update(host_ms=best[0], ms=best[1],
                      plain_cumsum_launches=[t[2] for t in times],
                      timed_levels=[t[3] for t in times],
                      timed_reached=[t[4] for t in times])
    log(f"bfs from root {roots[0]}: levels={res.levels_run} reached="
        f"{res.reached}; auto bfs (fastest of roots {roots[1:].tolist()}): "
        f"{best[0]:.1f} ms host" + (f", {best[1]:.1f} ms device"
                                    if best[1] is not None else ""))
    return rec


def main(argv=None) -> int:
    from ..utils.timing import card, entry_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--generator", choices=("native", "numpy"),
                    default="native")
    ap.add_argument("--nodes", type=int, default=LJ_N)
    ap.add_argument("--edges", type=int, default=LJ_E)
    args = ap.parse_args(argv)
    dev = entry_device("probes/bfs.py", args.device)
    smi = card(dev)
    print(f"# card: {smi}", flush=True)
    g, out_deg, gen_s = host_graph(args.nodes, args.edges, args.generator)
    print(f"# graph N={args.nodes} E={g.num_edges} ({args.generator}, "
          f"{gen_s:.1f} s)", flush=True)
    if dev.type == "cuda":
        from ..ops import _build
        _build.lib()                # the kernels' build is not a run's
    rec = measure(g, out_deg, dev, log=lambda m: print(m, flush=True))
    print(json.dumps({"metric": "bfs_phases", "device": str(dev),
                      "card": smi, "n": args.nodes, "e": g.num_edges,
                      "generator": args.generator, "graph_s": gen_s, **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
