"""Finding the benchmark's parts by name.

``BENCHMARK.json`` names each cell's configuration, traffic mix and
metrics; the files behind the names live in the folders of this package:

* ``configs/<name>.json``: a deployment (graph generator and its sizes,
  edge lengths, what was assumed);
* ``traffic/<name>.json``: a query mix, read by ``draw.plan``;
* ``limits/<cell>.json``: the limit of each number the cell's check
  compares, with the readings it was set from;
* ``queries/<kind>.py``, ``graphs/<generator>.py``, ``metrics/<name>.py``:
  a query kind, a graph generator, a metric's reader;
* ``programs/<name>.gm``: the text of a Green-Marl program a query kind
  compiles.

A later cell or metric is added as new files and entries; no file that is
there needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent              # the checkout: BENCHMARK.json lives here

FOLDERS = {"configs": ".json", "traffic": ".json", "limits": ".json",
           "queries": ".py", "graphs": ".py", "metrics": ".py",
           "programs": ".gm"}


def find(folder: str, name: str, pkg: Path = PKG) -> Path:
    """The file of ``name`` in ``folder``; ``FileNotFoundError`` if none."""
    if folder not in FOLDERS:
        raise ValueError(f"no folder {folder!r}; one of {sorted(FOLDERS)}")
    path = pkg / folder / (name + FOLDERS[folder])
    if not path.is_file():
        raise FileNotFoundError(f"{folder} {name!r}: no file {path}")
    return path


def load_json(folder: str, name: str, pkg: Path = PKG) -> Dict[str, Any]:
    with open(find(folder, name, pkg)) as f:
        return json.load(f)


def load_module(folder: str, name: str, pkg: Path = PKG) -> ModuleType:
    """Import ``folder/name.py`` by its path (a metric's name may hold a
    dot), once per process."""
    path = find(folder, name, pkg)
    key = f"gmbench._found.{folder}.{name}.{abs(hash(str(path)))}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def program_text(name: str, pkg: Path = PKG) -> str:
    return find("programs", name, pkg).read_text()


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what its names point at."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]    # metric entries this cell reports
    per_layer: List[Dict[str, Any]]
    pkg: Path = PKG


def _reported(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT,
              pkg: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``pkg`` (this package by default)."""
    pkg = PKG if pkg is None else pkg
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"there are {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    limits = load_json("limits", name, pkg)["limits"]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=load_json("traffic", w["traffic"], pkg),
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reported(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reported(m, name)],
                pkg=pkg)
