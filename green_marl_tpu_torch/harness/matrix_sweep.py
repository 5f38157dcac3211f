"""The placement matrix: the port of ``scripts/matrix_sweep.py`` (the
reference's ``test_all.sh`` analog, ``scripts/test_all.sh:40-58``).

    python -m green_marl_tpu_torch.harness.matrix_sweep [--device cuda|cpu]
        [--gm-dir DIR] [--nodes N --edges E | --bin PATH]

Each app of :data:`MATRIX` (``matrix_sweep.py:38-45``) runs through the
port's CLI (``cli.apps.main``) once on one device, then with
``-GMNumChips=8 -GMPlacement=<p>`` for each placement it supports, on 8
shards of the one device (``GM_TORCH_VIRTUAL_DEVICES=8``, set for the sweep
and restored after it).  Every protocol value of a sharded cell (the lines
``name[i] = v``, ``traversed=``, ``returns:``, parsed as at
``matrix_sweep.py:50-69``) is held against the one-device run by
``matrix_sweep.py:93-98``'s rule, ``|got - want| <= 1e-5 * max(|want|,
1e-30) + 1e-9``.

The graph is JAX's (``matrix_sweep.py:73-86``): ``rmat_edges(400, 3000,
seed=7)`` with a ``member`` node property from ``default_rng(11)``, stored
as an extended BIN file; ``--nodes/--edges`` draw a larger RMAT with the
same seeds, ``--bin`` takes a BIN file as it is.

The compiled placements (``distribute``, ``replicate``) compile the app's
``.gm`` source from ``--gm-dir`` (default ``$GM_REFERENCE_APPS``, the
CLI's own variable).  A cell whose source the directory lacks is not run:
it is named on a line of its own and counted in the summary, never as
passed.  The exit code is 1 if a cell that ran failed.

Prints the card's name and power limit first, a line per cell (with its
segment-reduce launches on the card), the summary line ``MATRIX OK: <ran>
of <cells> sharded configs, ...`` (``MATRIX FAILED`` where a cell
failed), and one JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
from typing import Dict, List

import numpy as np

SHARDS = 8
# apps with a sharded path x the placement policies each supports
MATRIX = [
    ("pagerank", ["distribute", "engine", "replicate"]),
    ("hop_dist", ["distribute", "engine", "replicate"]),
    ("sssp", ["distribute", "engine", "replicate"]),
    ("conduct", ["distribute"]),
    ("avg_teen_cnt", ["distribute"]),
    ("multi_bfs", ["engine"]),
]
COMPILED = ("distribute", "replicate")      # placements that read a .gm
RTOL, ATOL = 1e-5, 1e-9                     # matrix_sweep.py:96-97
DEFAULT_GRAPH = (400, 3000)                 # matrix_sweep.py:72
GRAPH_SEED, MEMBER_SEED = 7, 11

VAL_RE = re.compile(r"^(\w+)\[(\d+)\] = (.+)$")


def parse_values(out: str) -> Dict[str, float]:
    """The protocol values of one CLI run's stdout
    (``matrix_sweep.py:56-68``)."""
    vals = {}
    for ln in out.splitlines():
        mm = VAL_RE.match(ln.strip())
        if mm:
            vals[f"{mm.group(1)}[{mm.group(2)}]"] = float(mm.group(3))
        tm = re.search(r"traversed=(\d+)", ln)
        if tm:
            vals["traversed"] = float(tm.group(1))
        rm = re.search(r"returns: ([-0-9.eE]+)", ln)
        if rm:
            vals["_return"] = float(rm.group(1))
    return vals


def mismatches(want: Dict[str, float], got: Dict[str, float]) -> List[str]:
    """Every value of ``want`` that ``got`` lacks or misses by more than
    ``matrix_sweep.py:96-97``'s tolerance."""
    bad = []
    for k, v in want.items():
        dv = got.get(k)
        if dv is None:
            bad.append(f"{k}: missing")
        elif not abs(dv - v) <= RTOL * max(abs(v), 1e-30) + ATOL:
            bad.append(f"{k}: {dv!r} != {v!r}")
    return bad


def write_graph(path: str, nodes: int = DEFAULT_GRAPH[0],
                edges: int = DEFAULT_GRAPH[1]) -> None:
    """JAX's sweep graph (``matrix_sweep.py:73-86``): the RMAT of
    ``generate.rmat_edges(nodes, edges, seed=7)`` with a ``member``
    property in {0, 1, 2} from ``default_rng(11)``, as an extended BIN
    file."""
    from ..graph import binary_io as bio
    from ..graph import generate as gen
    from ..graph.csr import from_edges
    src, dst = gen.rmat_edges(nodes, edges, seed=GRAPH_SEED)
    g, _ = from_edges(src, dst, nodes)
    member = np.random.default_rng(MEMBER_SEED).integers(
        0, 3, g.num_nodes).astype(np.int32)
    bio.store_binary(path, g.begin.numpy(),
                     g.node_idx.numpy()[: g.num_edges], node_props=[member])


def has_source(gm_dir: str, app: str) -> bool:
    return bool(gm_dir) and os.path.exists(os.path.join(gm_dir, f"{app}.gm"))


def crc_lines(out: str) -> List[str]:
    """The ``CRC`` and ``CRC16`` lines of one CLI run's stdout."""
    return [ln for ln in out.splitlines() if ln.startswith("CRC")]


def run_cli(argv: List[str]):
    """One CLI run: ``(values, segment-reduce launches, stdout)``; raises
    when it exits non-zero or prints no protocol value.  The placement
    report (stderr) is dropped."""
    from ..cli import apps
    from ..ops import kernels as K
    before = K.launch_counts()["segment_reduce_sorted"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = apps.main(argv)
    launches = K.launch_counts()["segment_reduce_sorted"] - before
    if rc != 0:
        raise RuntimeError(f"{argv} -> rc={rc}\n{out.getvalue()[-2000:]}"
                           f"{err.getvalue()[-2000:]}")
    vals = parse_values(out.getvalue())
    if not vals:
        raise RuntimeError(f"no protocol values from {argv}")
    return vals, launches, out.getvalue()


@contextlib.contextmanager
def _sweep_env(gm_dir: str):
    """``GM_TORCH_VIRTUAL_DEVICES=8`` and the CLI's ``.gm`` directory for
    the sweep, both restored after it."""
    from ..cli import apps
    from ..parallel import comm
    old_env = os.environ.get(comm.VIRTUAL_ENV)
    old_dir = apps.REFERENCE_APPS
    os.environ[comm.VIRTUAL_ENV] = str(SHARDS)
    apps.REFERENCE_APPS = gm_dir or ""
    try:
        yield
    finally:
        apps.REFERENCE_APPS = old_dir
        if old_env is None:
            os.environ.pop(comm.VIRTUAL_ENV, None)
        else:
            os.environ[comm.VIRTUAL_ENV] = old_env


def sweep(path: str, device: str, gm_dir: str, log=print) -> Dict:
    """Every cell of :data:`MATRIX` on ``path``; returns the record
    ``{"base", "cells": [...], "ran", "passed", "not_run", "ok"}``:
    ``base[app]`` holds the one-device run's values and CRC lines, a cell
    is ``{"app", "placement", "status": "ok" | "failed" | "not run",
    "checked", "launches", "base_launches", "why", "got", "crc"}``."""
    cells, bases = [], {}
    with _sweep_env(gm_dir):
        for app, placements in MATRIX:
            base, base_launches, out = run_cli(
                [app, f"-GMDevice={device}", path])
            bases[app] = {"values": base, "crc": crc_lines(out)}
            for pl in placements:
                cell = {"app": app, "placement": pl, "checked": len(base),
                        "base_launches": base_launches}
                if pl in COMPILED and not has_source(gm_dir, app):
                    cell.update(status="not run", why=(
                        f"no .gm source: {app}.gm not in "
                        f"{gm_dir or '(no --gm-dir / GM_REFERENCE_APPS)'}"))
                    log(f"not run  {app:12s} chips={SHARDS} placement={pl}"
                        f": {cell['why']}")
                    cells.append(cell)
                    continue
                got, launches, out = run_cli(
                    [app, f"-GMDevice={device}", f"-GMNumChips={SHARDS}",
                     f"-GMPlacement={pl}", path])
                bad = mismatches(base, got)
                cell.update(status="failed" if bad else "ok",
                            launches=launches, why="; ".join(bad[:5]),
                            got=got, crc=crc_lines(out))
                cells.append(cell)
                log(f"{'ok ' if not bad else 'FAILED'}  {app:12s} "
                    f"chips={SHARDS} placement={pl} ({len(base)} values "
                    f"checked; segment-reduce launches {launches}, one "
                    f"device {base_launches})"
                    + (f": {cell['why']}" if bad else ""))
    ran = [c for c in cells if c["status"] != "not run"]
    passed = [c for c in ran if c["status"] == "ok"]
    not_run = len(cells) - len(ran)
    ok = len(passed) == len(ran)
    log(f"MATRIX {'OK' if ok else 'FAILED'}: "
        + (f"{len(ran)}" if ok else f"{len(passed)} passed, "
           f"{len(ran) - len(passed)} failed,")
        + f" of {len(cells)} sharded configs"
        + (", all output-verified vs one device" if ok else "")
        + f" ({not_run} not run: no .gm source)")
    return {"base": bases, "cells": cells, "ran": len(ran),
            "passed": len(passed),
            "not_run": not_run, "ok": ok}


def main(argv=None) -> int:
    from ..utils.timing import card, entry_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gm-dir", default=os.environ.get("GM_REFERENCE_APPS",
                                                       ""),
                    help="directory of the apps' .gm sources")
    ap.add_argument("--nodes", type=int, default=DEFAULT_GRAPH[0])
    ap.add_argument("--edges", type=int, default=DEFAULT_GRAPH[1])
    ap.add_argument("--bin", help="a BIN graph file, taken as it is")
    args = ap.parse_args(argv)
    dev = entry_device("matrix_sweep", args.device)
    smi = card(dev)
    print(f"# card: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as td:
        path = args.bin
        if path is None:
            path = os.path.join(td, "m.bin")
            write_graph(path, args.nodes, args.edges)
        rec = sweep(path, dev.type, args.gm_dir,
                    log=lambda m: print(m, flush=True))
    graph = ({"bin": args.bin} if args.bin else
             {"nodes": args.nodes, "edges": args.edges, "seed": GRAPH_SEED})
    print(json.dumps({"metric": "placement_matrix", "device": str(dev),
                      "card": smi, "shards": SHARDS, "graph": graph, **rec}))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
