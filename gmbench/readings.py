"""The readings that a cell's limits are set from, in one process.

    python -m gmbench.readings --workload <cell> --seeds S1 S2 ... \
        [--control-seeds C1 C2 C3] [--seconds <s>]

Runs the cell once for each seed as a benchmark run does (set-up, a
window of ``--seconds``, by default the benchmark's ``run_seconds``, so
that as many answers are compared), then once for each control seed with
each query kind's lower-precision path in the program's place
(``queries/*.py`` ``control``).  Prints one JSON line a run, then for each
number compared the largest reading of the program's runs (the lower
reading) and the smallest of the control's (the upper reading).  Needs a
card, as a run does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)

    import torch
    from gmbench import cell, spec

    if not torch.cuda.is_available():
        print("gmbench.readings: needs a CUDA device", file=sys.stderr)
        return 1
    c = spec.load_cell(args.workload)
    seconds = args.seconds or spec.load_benchmark()["run_seconds"]
    readings = {"program": {}, "control": {}}
    runs = [("program", s) for s in args.seeds] + \
        [("control", s) for s in args.control_seeds]
    for variant, seed in runs:
        t0 = time.perf_counter()
        res = cell.run_cell(c, seed, seconds, False, "cuda", t0, variant)
        numbers = {k: v["value"] for k, v in res.checks.items()}
        for k, v in numbers.items():
            readings[variant].setdefault(k, []).append(v)
        print(json.dumps({"variant": variant, "seed": seed,
                          "correct": res.correct,
                          "attempted": res.attempted, "failed": res.failed,
                          "numbers": numbers,
                          "metrics": {k: v["value"]
                                      for k, v in res.metrics.items()},
                          "by_kind": res.by_kind,
                          "run_s": time.perf_counter() - t0}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    summary = {k: {"lower": max(v),
                   "upper": min(readings["control"].get(k) or [None])}
               for k, v in readings["program"].items()}
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(),
                      "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
