"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python -m gmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared, with
its limit.  The same numbers end standard error.  Without enough cards,
or with JAX loaded in the process once the window has closed, it prints
no result and exits with 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "green_marl_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the run may not load,
    compared whole (``green_marl_tpu_torch`` is not ``green_marl_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from gmbench import cell, spec

    c = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gmbench: {args.workload} needs {c.chips} CUDA device(s), "
              f"{have} available", file=sys.stderr)
        return 1
    res = cell.run_cell(c, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"gmbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in res.setup.items()),
          file=sys.stderr)
    for kind, stats in res.by_kind.items():
        print(f"kind {kind} " + " ".join(f"{k} {v!r}" for k, v in
                                         stats.items()), file=sys.stderr)
    for name, chk in res.checks.items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r} "
              f"{'ok' if chk['value'] <= chk['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
