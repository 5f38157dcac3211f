"""Gather probes on the card: what the batched engine's row gather can reach.

Counterpart of ``scripts/probe_gather{,2,3,4}.py``, which sized the row
gather of the degree-binned engine (``ops/binned.py``) on the TPU.  Each
probe's Pallas kernel has a hand-written CUDA counterpart in
``ops/kernels.py``, timed here beside its plain PyTorch version:

* blocked ``take_along_axis`` (``take_along_blocks``) in every mode and
  block height of the TPU probes, from a fixed 2 MB window
  (probe_gather.py) or from the block of each grid step
  (probe_gather2/3.py), over E = 2^24 indices;
* the K-in-flight row gather (``row_gather_checksum``, probe_gather4.py)
  at 32, 128 and 512-byte rows, K in {1, 2, 4, 8, 16}, from a 2^20-row
  table at 2^21 random ids;
* as one more line, ``table.index_select(0, ids)`` of [n_rows, 128] int32
  rows at the LiveJournal-scale engine's shapes: the engine's own gather.

Before it is timed, each kernel's output on every input it is timed on
is held against its plain version's, which must be equal (gathers are
exact); each record keeps the largest difference seen.  Times are CUDA
events, the median of 3 launches on varied inputs.  Run on a machine with
an NVIDIA GPU::

    python -m green_marl_tpu_torch.probes.gather [--quick]

``--quick`` runs each family at one shape.  Without a GPU the probe exits
with an error: it measures the card and has nothing to say about a CPU.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from ..ops import kernels as K

E_ROWS = 1 << 17          # idx rows of 128: E = 2^24 (the TPU probes' 16M)
WINDOW_ROWS = 4096        # probe_gather.py's 2 MB float32 window
TABLE_ROWS = 1 << 20      # probe_gather4.py's N_ROWS
# One sweep of 2^21 ids.  With two, the warps of both sweeps run at once
# and the second finds the first's rows in L2: 4.0 TB/s "measured" at
# 512-byte rows, above the HBM peak (NVIDIA H100 80GB HBM3, 700 W).
GATHER_IDS = 1 << 21
GATHER_SWEEPS = 1
ENGINE_ROWS = 4_800_008   # binned rows of the LJ-scale RMAT (N=4.8M)
ENGINE_IDS = 1 << 22      # one large bin's slots


class TakeCase(NamedTuple):
    name: str
    replaces: str
    mode: str
    block_rows: int
    table_rows: int
    window: bool
    split: bool
    idx_range: int        # indices are drawn from [0, idx_range)


def take_cases(quick: bool = False) -> List[TakeCase]:
    """The TPU probes' take-along-axis kernels, each at its shapes."""
    win = WINDOW_ROWS * K.LANES
    cases = [
        TakeCase("sublane axis0, 2 MB window", "scripts/probe_gather.py:109",
                 "axis0", 256, WINDOW_ROWS, True, True, win),
        TakeCase("lane axis1, 2 MB window", "scripts/probe_gather.py:116",
                 "axis1", 256, WINDOW_ROWS, True, True, win),
        TakeCase("composed 2-axis, 2 MB window",
                 "scripts/probe_gather.py:124", "composed", 256,
                 WINDOW_ROWS, True, True, win),
        TakeCase("axis0 [1024,128]", "scripts/probe_gather2.py:118", "axis0",
                 1024, 1024, False, False, 1024),
        TakeCase("axis1 [1024,128]", "scripts/probe_gather2.py:122", "axis1",
                 1024, 1024, False, False, K.LANES),
        TakeCase("row-broadcast [1024,128]", "scripts/probe_gather2.py:126",
                 "row", 1024, 1024, False, False, 1024),
    ]
    cases += [TakeCase(f"axis0 [{sub},128]", "scripts/probe_gather2.py:154",
                       "axis0", sub, sub, False, False, sub)
              for sub in (4096, 16384)]
    cases += [TakeCase(f"axis0 sub={sub}", "scripts/probe_gather3.py:95",
                       "axis0", sub, sub, False, False, sub)
              for sub in (8, 64, 256)]
    cases.append(TakeCase("axis1 sub=1024", "scripts/probe_gather3.py:95",
                          "axis1", 1024, 1024, False, False, K.LANES))
    if quick:
        return [cases[0], cases[3], cases[9]]
    return cases


def gather_grid(quick: bool = False):
    """(row ints, K) pairs of probe_gather4.py: 32/128/512-byte rows."""
    if quick:
        return [(128, 8)]
    return [(roww, k) for roww in (8, 32, 128) for k in K.ROW_GATHER_K]


def median_ms(fn: Callable[[int], object], reps: int = 3) -> float:
    """Median device time in ms of ``fn(rep)`` over ``reps`` launches,
    after one warm-up launch (CUDA events around each launch)."""
    fn(reps)
    times = []
    for rep in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(rep)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(what: str, pairs) -> float:
    """Largest |kernel - plain| over ``(kernel, plain)`` output pairs;
    raises unless every pair is equal."""
    err = max(float((got.double() - want.double()).abs().max())
              for got, want in pairs)
    if err != 0.0:
        raise AssertionError(f"probe: {what}: kernel != plain version "
                             f"(max abs err {err})")
    return err


def probe_take(case: TakeCase, dev: torch.device,
               gen: torch.Generator) -> Dict:
    R = E_ROWS
    n_tab = case.table_rows if case.window else R
    table = torch.rand((n_tab, K.LANES), generator=gen, device=dev)
    idxs = [torch.randint(0, case.idx_range, (R, K.LANES), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(4)]
    args = (case.mode, case.block_rows, case.table_rows, case.window,
            case.split)
    err = _max_err(case.name, ((K.take_along_blocks(table, i, *args),
                                K.take_along_blocks_ref(table, i, *args))
                               for i in idxs))
    ms = median_ms(lambda r: K.take_along_blocks(table, idxs[r], *args))
    plain = median_ms(lambda r: K.take_along_blocks_ref(table, idxs[r],
                                                        *args))
    nbytes = R * K.LANES * 8           # 4-byte index in, 4-byte value out
    return dict(probe="take_along_blocks", name=case.name, ms=ms,
                plain_ms=plain, gbs=nbytes / ms / 1e6,
                plain_gbs=nbytes / plain / 1e6, max_abs_err=err,
                staged=K.take_along_staged(case.table_rows))


def probe_row_gather(roww: int, k: int, dev: torch.device,
                     gen: torch.Generator,
                     table: Optional[torch.Tensor] = None) -> Dict:
    if table is None or table.shape[1] != roww:
        table = torch.randint(0, 100, (TABLE_ROWS, roww), generator=gen,
                              device=dev, dtype=torch.int32)
    idxs = [torch.randint(0, TABLE_ROWS, (GATHER_IDS,), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(4)]
    err = _max_err(f"row gather {roww * 4} B K={k}",
                   ((K.row_gather_checksum(table, i, GATHER_SWEEPS, k),
                     K.row_gather_checksum_ref(table, i, GATHER_SWEEPS))
                    for i in idxs))
    ms = median_ms(lambda r: K.row_gather_checksum(table, idxs[r],
                                                   GATHER_SWEEPS, k))
    plain = median_ms(lambda r: K.row_gather_checksum_ref(table, idxs[r],
                                                          GATHER_SWEEPS))
    rows = GATHER_IDS * GATHER_SWEEPS
    return dict(probe="row_gather_checksum", name=f"rowB={roww * 4} K={k}",
                ms=ms, plain_ms=plain, ns_row=ms * 1e6 / rows,
                plain_ns_row=plain * 1e6 / rows,
                gbs=rows * roww * 4 / ms / 1e6, max_abs_err=err, table=table)


def probe_index_select(dev: torch.device, gen: torch.Generator) -> Dict:
    """The engine's own gather: 512-byte rows of an [n_rows, 128] int32
    table at random slot ids (plain PyTorch; no kernel of the port)."""
    table = torch.randint(0, 1 << 30, (ENGINE_ROWS, K.LANES), generator=gen,
                          device=dev, dtype=torch.int32)
    idxs = [torch.randint(0, ENGINE_ROWS, (ENGINE_IDS,), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(4)]
    ms = median_ms(lambda r: table.index_select(0, idxs[r]))
    row_b = K.LANES * 4
    return dict(probe="index_select", name=f"[{ENGINE_ROWS},128] int32 rows "
                f"x {ENGINE_IDS} ids", ms=ms,
                ns_row=ms * 1e6 / ENGINE_IDS,
                gbs=ENGINE_IDS * (2 * row_b + 4) / ms / 1e6)


def fmt(rec: Dict) -> str:
    """One printed line of a probe record."""
    if rec["probe"] == "take_along_blocks":
        where = "shared memory" if rec["staged"] else "L1/L2"
        return (f"take_along {rec['name']:30s} kernel {rec['ms']:8.3f} ms "
                f"{rec['gbs']:7.1f} GB/s ({where}) | plain "
                f"{rec['plain_ms']:8.3f} ms {rec['plain_gbs']:7.1f} GB/s")
    if rec["probe"] == "row_gather_checksum":
        return (f"row_gather {rec['name']:14s} kernel {rec['ms']:8.3f} ms "
                f"{rec['ns_row']:6.3f} ns/row {rec['gbs']:7.1f} GB/s | plain "
                f"{rec['plain_ms']:8.3f} ms {rec['plain_ns_row']:6.3f} ns/row")
    return (f"index_select {rec['name']} {rec['ms']:8.3f} ms "
            f"{rec['ns_row']:6.3f} ns/row {rec['gbs']:7.1f} GB/s "
            "(row out + row in + id)")


def run(dev: torch.device, quick: bool = False,
        log: Callable[[str], None] = print) -> List[Dict]:
    """Check and time every probe on ``dev`` (a CUDA device); returns one
    record per line printed."""
    if dev.type != "cuda":
        raise ValueError(f"the gather probes measure a GPU, not {dev}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    recs = []
    for case in take_cases(quick):
        recs.append(probe_take(case, dev, gen))
        log(fmt(recs[-1]))
    table = None
    for roww, k in gather_grid(quick):
        rec = probe_row_gather(roww, k, dev, gen, table)
        table = rec.pop("table")
        recs.append(rec)
        log(fmt(rec))
    del table
    recs.append(probe_index_select(dev, gen))
    log(fmt(recs[-1]))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one shape per probe family")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probes.gather: torch.cuda.is_available() is False; "
                         "the probes need an NVIDIA GPU")
    dev = torch.device("cuda")
    print(f"# {torch.cuda.get_device_name(dev)}, torch {torch.__version__}")
    run(dev, quick=args.quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
