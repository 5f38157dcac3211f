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
events, per call (``utils.timing.kernel_ms``): the median over 3 varied
inputs of 10 back-to-back calls each; bounds are ``probes/bounds.py``'s.
Run on a machine with an NVIDIA GPU::

    python -m green_marl_tpu_torch.probes.gather [--quick] [--only TEXT]
        [--parts] [--root DIR]

``--quick`` runs each family at one shape; ``--only TEXT`` (repeatable)
keeps the lines whose name holds ``TEXT`` (``axis0``, ``rowB=512``,
``index_select``); ``--parts`` adds the row gather's device time launch
by launch (``torch.profiler``).  ``--root DIR`` takes the kernels from
another checkout (``DIR`` holds ``green_marl_tpu_torch/``), so two commits
can be timed in turns within one run on one card: both keep the wrappers'
Python signatures.  Without a GPU the probe exits with an error: it
measures the card and has nothing to say about a CPU.
"""

from __future__ import annotations

import argparse
import importlib
import os
import re
import statistics
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from ..ops import kernels as K
from ..utils.timing import card, kernel_ms
from . import bounds
from .profile_apps import device_times

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
TIMED_CALLS = 10          # back-to-back calls per timed input


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
    """Median over ``reps`` inputs of the device time in ms of one call
    ``fn(rep)``: ``TIMED_CALLS`` back-to-back calls on each input
    (``kernel_ms``, one group)."""
    return statistics.median(kernel_ms(lambda: fn(rep), TIMED_CALLS, 1)[0]
                             for rep in range(reps))


def _max_err(what: str, pairs) -> float:
    """Largest |kernel - plain| over ``(kernel, plain)`` output pairs;
    raises unless every pair is equal."""
    err = max(float((got.double() - want.double()).abs().max())
              for got, want in pairs)
    if err != 0.0:
        raise AssertionError(f"probe: {what}: kernel != plain version "
                             f"(max abs err {err})")
    return err


def _gather_ms(case: TakeCase, table: torch.Tensor,
               idxs) -> Optional[float]:
    """Time of one ``torch.gather`` call that computes the case's function
    from int64 indices prepared beforehand (a yardstick: the port never
    calls it); None for the composed mode, which takes two."""
    if case.mode == "composed":
        return None
    th, nb = case.table_rows, E_ROWS // case.block_rows
    tb = (table[:th].unsqueeze(0).expand(nb, th, K.LANES) if case.window
          else table.view(nb, th, K.LANES))

    def prepared(idx):
        ib = idx.view(nb, case.block_rows, K.LANES)
        if case.mode == "axis1":
            return (ib & 127 if case.split
                    else ib.clamp(0, K.LANES - 1)).long()
        rows = (ib >> 7 if case.split else ib).clamp(0, th - 1).long()
        return (rows[:, :, :1].expand(-1, -1, K.LANES).contiguous()
                if case.mode == "row" else rows)

    ix = [prepared(i) for i in idxs]
    dim = 2 if case.mode == "axis1" else 1
    return median_ms(lambda r: torch.gather(tb, dim, ix[r]))


def route_name(case: TakeCase) -> str:
    """The route the wrapper takes for the case's shape on the card (for a
    ``--root`` checkout that does not name its routes: ``"?"``)."""
    if not hasattr(K, "take_along_route"):
        return "?"
    name = K.take_along_route(case.table_rows, case.mode)
    if name == "slab":
        name += f" of {K.take_along_slab_cols(case.table_rows)} columns"
    return name


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
                route=route_name(case),
                bound_bytes=bounds.take_along_blocks(table.numel(), R,
                                                     K.LANES, case.mode),
                library_ms=_gather_ms(case, table, idxs))


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
    distinct = max(int(torch.unique(i).numel()) for i in idxs[:3])
    return dict(probe="row_gather_checksum", name=f"rowB={roww * 4} K={k}",
                ms=ms, plain_ms=plain, ns_row=ms * 1e6 / rows,
                plain_ns_row=plain * 1e6 / rows,
                gbs=rows * roww * 4 / ms / 1e6, max_abs_err=err, table=table,
                bound_bytes=bounds.row_gather_checksum(distinct, roww * 4,
                                                       GATHER_IDS),
                library_ms=None)


def kernel_name(full: str) -> str:
    """``row_gather_kernel`` of ``void (anonymous namespace)::
    row_gather_kernel<8>(int const*, ...)``."""
    head = re.split(r"[<(]", full.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else full


def row_gather_parts(roww: int, k: int, dev: torch.device,
                     gen: torch.Generator, calls: int = 20) -> Dict:
    """Device time of each launch inside one ``row_gather_checksum`` call
    (``torch.profiler``, mean over ``calls`` calls on varied ids): the
    zero fill of its scratch, the two pre-pass kernels and the copy loop."""
    table = torch.randint(0, 100, (TABLE_ROWS, roww), generator=gen,
                          device=dev, dtype=torch.int32)
    idxs = [torch.randint(0, TABLE_ROWS, (GATHER_IDS,), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(4)]
    K.row_gather_checksum(table, idxs[0], GATHER_SWEEPS, k)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for c in range(calls):
            K.row_gather_checksum(table, idxs[c % 4], GATHER_SWEEPS, k)
        torch.cuda.synchronize()
    parts: Dict[str, float] = {}
    for name, ms in device_times(prof).items():
        parts[kernel_name(name)] = parts.get(kernel_name(name), 0.0) \
            + ms / calls
    return dict(probe="row_gather_parts", name=f"rowB={roww * 4} K={k}",
                parts=parts, ms=sum(parts.values()))


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


def _bound(rec: Dict) -> str:
    """The least the card could take for the record's bytes, and the time
    of the one PyTorch call that does the same, where there is one."""
    lib = rec["library_ms"]
    return (f" | bound {rec['bound_bytes'] / 1e6:6.1f} MB "
            f"{bounds.bound_ms(rec['bound_bytes']):6.3f} ms"
            + ("" if lib is None else f" | torch.gather {lib:6.3f} ms"))


def fmt(rec: Dict) -> str:
    """One printed line of a probe record."""
    if rec["probe"] == "take_along_blocks":
        return (f"take_along {rec['name']:30s} kernel {rec['ms']:8.3f} ms "
                f"{rec['gbs']:7.1f} GB/s ({rec['route']}) | plain "
                f"{rec['plain_ms']:8.3f} ms {rec['plain_gbs']:7.1f} GB/s"
                + _bound(rec))
    if rec["probe"] == "row_gather_checksum":
        return (f"row_gather {rec['name']:14s} kernel {rec['ms']:8.3f} ms "
                f"{rec['ns_row']:6.3f} ns/row {rec['gbs']:7.1f} GB/s | plain "
                f"{rec['plain_ms']:8.3f} ms {rec['plain_ns_row']:6.3f} ns/row"
                + _bound(rec))
    if rec["probe"] == "row_gather_parts":
        return (f"row_gather {rec['name']:14s} device ms by launch: "
                + ", ".join(f"{n} {ms:.4f}" for n, ms in rec["parts"].items())
                + f"; sum {rec['ms']:.4f}")
    return (f"index_select {rec['name']} {rec['ms']:8.3f} ms "
            f"{rec['ns_row']:6.3f} ns/row {rec['gbs']:7.1f} GB/s "
            "(row out + row in + id)")


def run(dev: torch.device, quick: bool = False,
        log: Callable[[str], None] = print,
        only: Sequence[str] = (), parts: bool = False) -> List[Dict]:
    """Check and time every probe on ``dev`` (a CUDA device) whose name
    holds one of ``only`` (all of them if empty); with ``parts`` also the
    row gather's time launch by launch.  Returns one record per line
    printed."""
    if dev.type != "cuda":
        raise ValueError(f"the gather probes measure a GPU, not {dev}")

    def wanted(name: str) -> bool:
        return not only or any(text in name for text in only)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    recs = []
    for case in take_cases(quick):
        if wanted(case.name):
            recs.append(probe_take(case, dev, gen))
            log(fmt(recs[-1]))
    table = None
    for roww, k in gather_grid(quick):
        if wanted(f"rowB={roww * 4} K={k}"):
            rec = probe_row_gather(roww, k, dev, gen, table)
            table = rec.pop("table")
            recs.append(rec)
            log(fmt(rec))
    del table
    if parts:
        for roww, k in ((128, 2), (128, 8), (8, 8)):
            recs.append(row_gather_parts(roww, k, dev, gen))
            log(fmt(recs[-1]))
    if wanted("index_select"):
        recs.append(probe_index_select(dev, gen))
        log(fmt(recs[-1]))
    return recs


def use_checkout(root: str) -> None:
    """Take ``ops.kernels`` (and the CUDA sources it builds) from the
    checkout at ``root`` for the rest of this process."""
    global K
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "green_marl_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    K = importlib.import_module("green_marl_tpu_torch.ops.kernels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one shape per probe family")
    ap.add_argument("--only", action="append", default=[], metavar="TEXT",
                    help="keep the lines whose name holds TEXT (repeatable)")
    ap.add_argument("--parts", action="store_true",
                    help="the row gather's device time launch by launch")
    ap.add_argument("--root", help="take the kernels from this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probes.gather: torch.cuda.is_available() is False; "
                         "the probes need an NVIDIA GPU")
    if args.root:
        use_checkout(args.root)
    dev = torch.device("cuda")
    print(f"# {card(dev)}, torch {torch.__version__}, kernels of "
          f"{os.path.dirname(os.path.dirname(os.path.dirname(K.__file__)))}",
          flush=True)
    run(dev, quick=args.quick, only=args.only, parts=args.parts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
