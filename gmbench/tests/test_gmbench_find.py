"""Every part of the benchmark is found by its name, and a cell, traffic
mix, configuration and metric added as new files are found too;
``BENCHMARK.json`` keeps to the contract's shape."""

import json
import re
import shutil
import time

import pytest

from gmbench import cell, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and \
            m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_parts(w):
    c = spec.load_cell(w["name"])
    spec.load_module("graphs", c.config["generator"])
    numbers = {"unchecked_kinds"}
    for k in c.traffic["kinds"]:
        numbers |= set(spec.load_module("queries", k["kind"]).NUMBERS)
    assert set(c.limits) == numbers
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert c.end_to_end and c.per_layer


def test_find_refuses_what_is_not_there():
    with pytest.raises(FileNotFoundError):
        spec.find("configs", "no_such_config")
    with pytest.raises(ValueError):
        spec.find("nowhere", "lj")


def test_new_files_are_found(tmp_path):
    """A later cell added as files only: its configuration, traffic,
    limits and a new metric, in a copy of the package."""
    pkg = tmp_path / "gmbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = dict(spec.load_json("configs", "lj"), name="tiny", nodes=1500,
               edges=9000)
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = dict(spec.load_json("traffic", "reference_apps"), queries=30,
                   kinds=[{"kind": "hop_dist", "share": 1}])
    (pkg / "traffic" / "hops_only.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "tiny.hops.json").write_text(json.dumps(
        {"limits": {"hop_mismatch": 0, "unchecked_kinds": 0}}))
    (pkg / "metrics" / "query_ms.p50.py").write_text(
        "import statistics\n\n\ndef read(rec):\n"
        "    return 1e3 * statistics.median(rec.latencies_s)\n")
    (pkg / "programs").mkdir(exist_ok=True)
    (pkg / "programs" / "noop.gm").write_text("Procedure noop(G: Graph) {}\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "gmbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.hops", "config": "tiny",
                               "traffic": "hops_only", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "query_ms.p50", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.hops"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.load_cell("tiny.hops", root=tmp_path, pkg=pkg)
    assert c.config["nodes"] == 1500 and c.limits["hop_mismatch"] == 0
    assert "query_ms.p50" in [m["name"] for m in c.end_to_end]
    assert spec.program_text("noop", pkg).startswith("Procedure")
    res = cell.run_cell(c, 4, 0.3, False, "cpu", time.perf_counter())
    assert res.correct and res.metrics["query_ms.p50"]["value"] > 0
    assert "query_ms.p50" not in [m["name"] for m in
                                  spec.load_cell("lj.queries",
                                                 root=tmp_path,
                                                 pkg=pkg).end_to_end]
