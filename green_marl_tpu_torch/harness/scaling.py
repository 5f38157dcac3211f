"""The vertex-sharded scaling ladder: the port of ``scripts/scaling.py``.

    python -m green_marl_tpu_torch.harness.scaling [--device cuda|cpu]
        [--nodes N --edges E]

``parallel.vertex_sharded.pagerank_vsharded`` at S = 1, 2, 4, 8 shards on
one RMAT graph, ``generate.rmat_edges(400_000, 4_000_000, seed=13)`` by
default (``scaling.py:35``), with ``e=0.0, max_iter=20``: one warm run,
then the fastest of 3 (``scaling.py:43-58``).  The S shards share the one
device (threads of ``parallel.comm``), so the ladder shows that per-shard
owned state and ghost traffic shrink as O(N/S) and O(cut) while the ranks
stay bit-identical across S (asserted as at ``scaling.py:64``), not a
speed-up.

Per S: ms (the host clock around a run that ends in a synchronize, and
CUDA events on the card), ``t1/tS``, owned state a shard (``L * 4``
bytes), the ghost buffer a shard (``S * cap * 4``), ``ghost_total``, the
host seconds of the partition build and the segment-reduce launches of
each run.  Prints a markdown table and one JSON line; it writes no file
(JAX's script rewrites ``BASELINE.md``, ``scaling.py:75-96``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import torch

LADDER = (1, 2, 4, 8)
DEFAULT_SIZE = (400_000, 4_000_000)          # scaling.py:35
SEED = 13
ITERS, REPS = 20, 3                          # scaling.py:45-52


def ladder(g_host, dev: torch.device, shards=LADDER, iters: int = ITERS,
           reps: int = REPS, log=print) -> Tuple[List[Dict], Dict]:
    """The ladder on ``g_host`` (a ``Graph`` on the host).  Returns the
    rows (one per S, ``ranks_equal`` against S=1) and, for the largest S,
    shard 0's slab of the segment reduce (``(ids, offsets, n_out)`` on the
    host) and the ranks of the first S on the host, as ``{"slab",
    "rank"}``."""
    from ..ops import kernels as K
    from ..parallel import comm
    from ..parallel import vertex_sharded as V
    from ..utils.timing import timed
    rows, ref, base = [], None, None
    keep = {}
    for S in shards:
        mesh = comm.Mesh([dev] * S, ("v",))
        t0 = time.time()
        vsg_h = V.build_vertex_sharded(g_host, S)
        build_s = time.time() - t0
        vsg = V.place(vsg_h, mesh)
        run = lambda: V.pagerank_vsharded(vsg, mesh, e=0.0,  # noqa: E731
                                          max_iter=iters)
        timed(run, dev)                                   # warm
        best = None
        for _ in range(reps):
            before = K.launch_counts()["segment_reduce_sorted"]
            (rank, _, it), host_ms, dev_ms = timed(run, dev)
            launches = K.launch_counts()["segment_reduce_sorted"] - before
            if best is None or host_ms < best[0]:
                best = (host_ms, dev_ms)
        rank = rank.cpu()
        if ref is None:
            ref, base = rank, best[0]
            keep["rank"] = ref
        row = {"S": S, "ms": best[0], "device_ms": best[1],
               "t1_over_tS": base / best[0], "iterations": it,
               "state_bytes": vsg.L * 4,
               "ghost_buf_bytes": vsg.num_shards * vsg.cap * 4,
               "ghost_total": vsg.ghost_total, "L": vsg.L, "cap": vsg.cap,
               "E_s": vsg.E_s, "build_s": build_s,
               "segment_reduce_launches": launches,
               "ranks_equal": bool(torch.equal(rank, ref))}
        rows.append(row)
        log(f"S={S}  {iters} supersteps {row['ms']:8.1f} ms"
            + (f" (device {row['device_ms']:.1f})" if best[1] is not None
               else "")
            + f"  t1/tS={row['t1_over_tS']:5.2f}  state/dev "
            f"{row['state_bytes'] / 1e6:6.2f} MB  ghost buf/dev "
            f"{row['ghost_buf_bytes'] / 1e3:8.1f} KB  cut={vsg.ghost_total}"
            f"  build {build_s:.1f} s  launches {launches}"
            f"  bit-identical to S={shards[0]}: {row['ranks_equal']}")
        if S == shards[-1]:
            keep["slab"] = (vsg_h.dst_local[0].clone(),
                            vsg_h.dst_off[0].clone(), vsg_h.L)
        del vsg, vsg_h, rank
    return rows, keep


def table(rows: List[Dict], n: int, e: int, iters: int = ITERS) -> str:
    """The markdown table of ``scaling.py:78-92``, with device ms."""
    lines = [f"### Vertex-sharded scaling (RMAT N={n} E={e}, {iters} PageRank"
             " supersteps; results bit-identical across S: "
             f"{all(r['ranks_equal'] for r in rows)})", "",
             "| S | time (ms) | device (ms) | t1/tS | owned state/dev | "
             "ghost buf/dev | cut size | seg-reduce launches |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        dms = "-" if r["device_ms"] is None else f"{r['device_ms']:.1f}"
        lines.append(f"| {r['S']} | {r['ms']:.1f} | {dms} | "
                     f"{r['t1_over_tS']:.2f} | "
                     f"{r['state_bytes'] / 1e6:.2f} MB | "
                     f"{r['ghost_buf_bytes'] / 1e3:.1f} KB | "
                     f"{r['ghost_total']} | "
                     f"{r['segment_reduce_launches']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from ..graph import generate as gen
    from ..graph.csr import from_edges
    from ..utils.timing import card, entry_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=DEFAULT_SIZE[0])
    ap.add_argument("--edges", type=int, default=DEFAULT_SIZE[1])
    args = ap.parse_args(argv)
    dev = entry_device("scaling", args.device)
    smi = card(dev)
    print(f"# card: {smi}", flush=True)
    n = args.nodes
    t0 = time.time()
    src, dst = gen.rmat_edges(n, args.edges, seed=SEED)
    g, _ = from_edges(src, dst, n)
    print(f"# graph N={n} E={g.num_edges} ({time.time() - t0:.1f} s)",
          flush=True)
    rows, _ = ladder(g, dev, log=lambda m: print(m, flush=True))
    print(table(rows, n, g.num_edges), flush=True)
    ok = all(r["ranks_equal"] for r in rows)
    print(json.dumps({"metric": "vsharded_scaling", "device": str(dev),
                      "card": smi, "n": n, "e": g.num_edges,
                      "iters": ITERS, "rows": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
