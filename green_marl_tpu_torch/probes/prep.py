"""The preprocessing stages at LJ scale: the port of ``scripts/probe_prep.py``.

    python -m green_marl_tpu_torch.probes.prep [--device cuda|cpu]
        [--generator native|numpy] [--nodes N --edges E]

On the graph of ``probes/bfs.py`` (the LiveJournal-scale RMAT, N=4.8M,
E=69M, seed 42; JAX's probe reads bench.py's edge cache), each stage the
port has, timed by the host clock (``probe_prep.py:22-44``):

* ``from_edges``: the CSR + CSC freeze on the host;
* ``binned_in``: the pull schedule on the host, with the sizes of
  ``slot_src`` and ``slot_edge``;
* the upload of each of ``slot_src``, ``slot_edge``, ``hub_owner``,
  ``perm`` and ``inv_perm`` (bytes, ms, GB/s; a synchronize ends each);
* ``to_binned(deg)`` on the device (the out-degrees in binned row order),
  twice: the first call also loads the gather's code.

JAX's packed transfer works around the TPU link and has no counterpart.
Prints the card's name and power limit first, a line a stage, and one JSON
line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from .bfs import LJ_E, LJ_N, rmat

UPLOADS = ("slot_src", "slot_edge", "hub_owner", "perm", "inv_perm")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def stages(src: np.ndarray, dst: np.ndarray, n: int, dev: torch.device,
           log=print) -> Dict:
    """Every stage on the edge list ``(src, dst)`` of ``n`` nodes; returns
    ``{"stages": {name: {...}}, "deg_binned": tensor on dev, "perm": the
    schedule's row order on the host}``."""
    from ..graph.csr import from_edges
    from ..ops import binned
    rec = {}
    t0 = time.perf_counter()
    g, _ = from_edges(src, dst, n)
    rec["from_edges"] = {"s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    bp = binned.binned_in(g)
    rec["binned_in"] = {"s": time.perf_counter() - t0,
                        "slot_src_bytes": bp.slot_src.numel() * 4,
                        "slot_edge_bytes": bp.slot_edge.numel() * 4}
    for name, r in rec.items():
        log(f"{name}: {r}")
    moved = {}
    for f in UPLOADS:
        a = getattr(bp, f)
        _sync(dev)
        t0 = time.perf_counter()
        moved[f] = a.to(dev)
        _sync(dev)
        s = time.perf_counter() - t0
        nbytes = a.numel() * a.element_size()
        # on the CPU ``.to`` moves nothing: no rate
        rate = nbytes / s / 1e9 if dev.type == "cuda" and s else None
        rec[f"upload {f}"] = {"bytes": nbytes, "ms": 1000 * s,
                              "gb_per_s": rate}
        log(f"upload {f} ({nbytes / 1e6:.0f} MB): {1000 * s:.1f} ms")
    bp_d = dataclasses.replace(bp, **moved)
    deg = torch.from_numpy(np.bincount(src, minlength=n).astype(np.int32))
    deg_d = deg.to(dev)
    ms = []
    for _ in range(2):              # the first call loads the gather's code
        _sync(dev)
        t0 = time.perf_counter()
        deg_binned = bp_d.to_binned(deg_d)
        _sync(dev)
        ms.append(1000 * (time.perf_counter() - t0))
    rec["to_binned(deg) device"] = {"first_ms": ms[0], "ms": ms[1]}
    log(f"to_binned(deg) device: {rec['to_binned(deg) device']}")
    return {"stages": rec, "deg_binned": deg_binned, "perm": bp.perm}


def main(argv=None) -> int:
    from ..utils.timing import card, entry_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--generator", choices=("native", "numpy"),
                    default="native")
    ap.add_argument("--nodes", type=int, default=LJ_N)
    ap.add_argument("--edges", type=int, default=LJ_E)
    args = ap.parse_args(argv)
    dev = entry_device("probes/prep.py", args.device)
    smi = card(dev)
    print(f"# card: {smi}", flush=True)
    t0 = time.time()
    src, dst = rmat(args.nodes, args.edges, args.generator)
    print(f"# edges N={args.nodes} E={args.edges} ({args.generator}, "
          f"{time.time() - t0:.1f} s)", flush=True)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)     # the context is not an upload's
    rec = stages(src, dst, args.nodes, dev,
                 log=lambda m: print(m, flush=True))
    print(json.dumps({"metric": "prep_stages", "device": str(dev),
                      "card": smi, "n": args.nodes, "e": args.edges,
                      "generator": args.generator, **rec["stages"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
