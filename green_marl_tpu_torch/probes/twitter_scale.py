"""Twitter-class batched BFS past 2^24 nodes: the port of
``scripts/probe_twitter_scale.py``.

    python -m green_marl_tpu_torch.probes.twitter_scale [N E] [--smoke]
        [--device cuda|cpu] [--variants fused,paged]

The bit BFS at B=1024 instances, ``plane_bits=8`` (128 one-byte lanes a
row), on ``generate.uniform_random_edges(N, E, seed=1)`` (default N=20M,
E=130M; N > 2^24 is required, as at ``probe_twitter_scale.py:65``;
``--smoke`` takes N=2^15, E=2^18 and lifts that check).  The CSR and CSC
come from ``native.build_csr`` (numpy where the host library does not
build), the schedule from ``ops.binned.build_binned`` over the CSC and the
out-degrees by ``to_binned`` (``:67-95``).  The roots are the 1024 nodes of
highest out-degree; the timed runs roll them by 1, 2 and 3 (``:111-139``).

JAX picks one variant (the paged closure above 21M nodes, ``:114-117``)
because a 16 GB TPU ran out; that limit is the TPU's.  This probe runs both
``models.batched.multi_source_bfs_bits`` and
``multi_source_bfs_bits_paged`` and holds them equal: levels, each
instance's ``traversed`` and ``reached``, and the visited planes.

Prints the card's name and power limit first and one JSON line last, in
JAX's keys per variant (levels, traversed, time_ms: the median over the
three rolled runs of the host clock around a run that ends on the host,
agg_gteps, run_times_ms) plus device_ms (CUDA events, the card only) and
peak_gb (the device memory peak of the variant's runs); exits 1 where the
variants differ.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

B = 1024
PLANE_BITS = 8
SEED = 1
FULL = (20_000_000, 130_000_000)        # probe_twitter_scale.py:35-36
SMOKE = (1 << 15, 1 << 18)
VARIANTS = ("fused", "paged")


def _log(msg):
    print(f"# twitter_scale: {msg}", file=sys.stderr, flush=True)


def degree_rows(bp, out_deg: np.ndarray) -> np.ndarray:
    """The out-degrees in binned row order: [n_rows] int32, 0 in pad rows
    (``probe_twitter_scale.py:91-93``)."""
    deg_rows = np.zeros(bp.n_rows, np.int32)
    deg_rows[: bp.n_nodes] = bp.to_binned(
        torch.from_numpy(out_deg.astype(np.int32))).numpy()
    return deg_rows


def schedule(begin: np.ndarray, r_begin: np.ndarray, csc_src: np.ndarray,
             n: int, e: int):
    """``(bp, deg_rows, out_deg)`` on the host: the pull schedule over the
    CSC (``build_binned``, e_pad = round_up(E)), :func:`degree_rows` and
    the out-degrees by node (int64)."""
    from ..graph.csr import round_up
    from ..ops import binned
    out_deg = np.diff(np.asarray(begin)).astype(np.int64)
    bp = binned.build_binned(np.asarray(r_begin), np.asarray(csc_src), n,
                             round_up(e))
    return bp, degree_rows(bp, out_deg), out_deg


def prepare(n: int, e: int, seed: int = SEED):
    """The probe's graph and schedule: ``(bp, deg_rows, out_deg,
    {stage: seconds})`` (``probe_twitter_scale.py:67-95``)."""
    from ..graph import generate as gen
    from ..graph import native
    sec = {}
    t0 = time.time()
    src, dst = gen.uniform_random_edges(n, e, seed=seed)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    sec["t_edges_s"] = time.time() - t0
    t0 = time.time()
    if native.available():
        begin, _, _, _, r_begin, csc_src, _, _ = native.build_csr(src, dst, n)
    else:
        r_begin = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n), out=r_begin[1:])
        csc_src = src[np.argsort(dst, kind="stable")]
        begin = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n), out=begin[1:])
    del src, dst
    sec["t_csr_s"] = time.time() - t0
    t0 = time.time()
    bp, deg_rows, out_deg = schedule(begin, r_begin, csc_src, n, e)
    sec["t_binning_s"] = time.time() - t0
    return bp, deg_rows, out_deg, sec


def top_roots(out_deg: np.ndarray, b: int = B) -> np.ndarray:
    """The ``b`` nodes of highest out-degree (``:111-112``)."""
    return np.argsort(out_deg)[::-1][:b].astype(np.int32).copy()


def run(bp, deg_rows: np.ndarray, roots0: np.ndarray, dev: torch.device,
        variants: Sequence[str] = VARIANTS, reps: int = 3,
        keep: Optional[Dict] = None) -> Dict:
    """Each variant from ``roots0`` (kept: levels, traversed, reached and
    the visited planes on the host) and from ``roots0`` rolled by 1..reps
    (timed).  Returns ``{variant: {...}, "equal": bool}``; ``keep`` (a
    dict) receives each variant's planes of the ``roots0`` run."""
    from ..models import batched
    from ..ops import binned
    from ..utils.timing import timed
    fns = {"fused": batched.multi_source_bfs_bits,
           "paged": batched.multi_source_bfs_bits_paged}
    bp_d = bp.to(dev, with_edges=False)
    deg_d = torch.from_numpy(deg_rows).to(dev)
    chunk = binned.slot_chunk_for(len(roots0) // 8)
    out = {}
    planes = {}
    for name in variants:
        fn = fns[name]

        def call(rr):
            res = fn(bp_d, rr, deg_d, plane_bits=PLANE_BITS,
                     slot_chunk=chunk)
            return res, res.traversed.cpu().numpy()  # ends on the host

        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        (res, trav), host_ms, dev_ms = timed(lambda: call(roots0), dev)
        rec = {"levels": int(res.levels_run), "traversed": int(trav.sum()),
               "first_run_ms": host_ms, "first_run_device_ms": dev_ms}
        planes[name] = (res.levels_run, trav, res.reached.cpu().numpy(),
                        res.visited.cpu())
        del res
        times, dtimes = [], []
        for k in range(1, reps + 1):
            (_, t), host_ms, dev_ms = timed(
                lambda: call(np.roll(roots0, k)), dev)
            times.append(host_ms)
            dtimes.append(dev_ms)
        dt = float(np.median(times))
        rec.update(time_ms=dt, agg_gteps=rec["traversed"] / dt / 1e6,
                   run_times_ms=times,
                   device_ms=(None if dev.type != "cuda"
                              else float(np.median(dtimes))),
                   peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                            if dev.type == "cuda" else None))
        out[name] = rec
        _log(f"{name}: B={len(roots0)} levels={rec['levels']} traversed="
             f"{rec['traversed']} time={dt:.1f} ms agg="
             f"{rec['agg_gteps']:.2f} GTEPS peak={rec['peak_gb']}")
    names = list(planes)
    a = planes[names[0]]
    out["equal"] = all(
        b[0] == a[0] and np.array_equal(b[1], a[1])
        and np.array_equal(b[2], a[2]) and torch.equal(b[3], a[3])
        for b in (planes[m] for m in names[1:]))
    if keep is not None:
        keep.update(planes)
    return out


def main(argv=None) -> int:
    from ..utils.timing import card, entry_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", nargs="*", type=int, help="N E")
    ap.add_argument("--smoke", action="store_true",
                    help="N=2^15, E=2^18 (no N > 2^24 check)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    dev = entry_device("twitter_scale", args.device)
    smi = card(dev)
    print(f"# card: {smi}", flush=True)
    n, e = SMOKE if args.smoke else FULL
    if args.size:
        n, e = args.size
    if not args.smoke and n <= (1 << 24):
        raise SystemExit("twitter_scale: the point of this probe is N > "
                         "2^24 (--smoke for a small graph)")
    bp, deg_rows, out_deg, sec = prepare(n, e)
    _log(f"N={n} E={e}: {sec} (n_rows={bp.n_rows} slots="
         f"{bp.slot_src.shape[0]})")
    if dev.type == "cuda":
        from ..ops import _build
        _build.lib()                # the kernels' build is not a run's
    variants = [v for v in args.variants.split(",") if v]
    res = run(bp, deg_rows, top_roots(out_deg), dev, variants)
    print(json.dumps({"metric": "twitter_class_batched_bfs", "n": n, "e": e,
                      "b": B, "plane_bits": PLANE_BITS, "device": str(dev),
                      "card": smi, **{k: round(v, 3) for k, v in sec.items()},
                      **res}))
    return 0 if res["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
