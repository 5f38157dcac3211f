"""The port's CLI on the tracked fixture, its device handling, and its
independence from JAX.

Goldens for ``data/parity/parity10k.bin`` (N=10,000, E=80,000) come from the
JAX CLI on the CPU; hop_dist's is bit-exact with the reference binary
(BASELINE.md:78).  PageRank ranks are compared within 1e-4 relative, the
device tolerance of scripts/parity.py:85.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from green_marl_tpu.cli import apps as japps
from green_marl_tpu.graph import binary_io as jbio
from green_marl_tpu_torch.cli import apps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "data", "parity", "parity10k.bin")
GOLD_RANK = [0.000078454, 0.000063880, 0.000108653, 0.000057279]


def run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out.splitlines()


def results(lines):
    """The protocol lines that carry results (no timings)."""
    return [ln for ln in lines if "time=" not in ln]


def test_hop_dist_golden(capsys):
    lines = run(capsys, apps.main, ["hop_dist", "-GMDevice=cpu", FIXTURE])
    assert "CRC16 dist 0x5003" in lines
    assert "dist[0] = 0" in lines and "dist[9] = 4" in lines


def test_sssp_golden(capsys):
    lines = run(capsys, apps.main, ["sssp", "-GMDevice=cpu",
                                    "-GMMeasureTime=1", FIXTURE])
    assert "CRC16 dist 0x8e4e" in lines
    assert [ln for ln in lines if ln.startswith("dist[")][:4] == [
        "dist[0] = 0", "dist[1] = 141", "dist[2] = 114", "dist[3] = 170"]
    assert any(ln.startswith("running time=") for ln in lines)


def test_pagerank_golden(capsys):
    lines = run(capsys, apps.main, ["pagerank", "-GMDevice=cpu", FIXTURE])
    rank = [float(ln.split(" = ")[1]) for ln in lines
            if ln.startswith("rank[")]
    np.testing.assert_allclose(rank, GOLD_RANK, rtol=1e-4, atol=0)
    assert not any(ln.startswith("running time=") for ln in lines)


def test_ebin_edge_lengths_match_jax_cli(tmp_path, capsys):
    raw = jbio.load_binary(FIXTURE)
    lens = np.random.default_rng(3).integers(1, 50, raw.num_edges) \
        .astype(np.int32)
    path = str(tmp_path / "weighted.ebin")
    jbio.store_binary(path, raw.begin, raw.node_idx, edge_props=[lens])
    argv = ["sssp", "-GMInputFormat=EBIN", "-root=7", path]
    want = run(capsys, japps.main, argv)
    got = run(capsys, apps.main, argv[:1] + ["-GMDevice=cpu"] + argv[1:])
    assert results(got) == results(want)


def test_cuda_device_without_cuda_exits(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["hop_dist", "-GMDevice=cuda", FIXTURE],
                 ["hop_dist", FIXTURE]):            # cuda is the default
        with pytest.raises(SystemExit) as e:
            apps.main(argv)
        assert e.value.code not in (0, None)
        assert "CUDA" in str(e.value.code)
    assert "CRC" not in capsys.readouterr().out


PLACE_ALONE = ("-GMPlace/-GMPlacementFile require -GMNumChips>1 "
               "(they pin arrays of the distributed placement)")


@pytest.mark.parametrize("opts", [
    ["-GMNumChips=2"],
    ["-GMNumChips=2", "-GMPlacement=replicate"],
    ["-GMNumChips=4", "-GMPlace=dist:replicate"],
    ["-GMNumChips=2", "-GMPlacementFile=placement.json"],
    ["-GMPlace=dist:replicate"],
    ["-GMPlacementFile=placement.json", "-GMNumChips=1"],
    ["-GMDevice=mps"]])
def test_unported_options_exit(opts):
    """What would change the run is refused; placement overrides without
    -GMNumChips>1 exit as in the JAX CLI, with its message."""
    # a later -GMDevice replaces -GMDevice=cpu
    with pytest.raises(SystemExit) as e:
        apps.main(["hop_dist", "-GMDevice=cpu"] + opts + [FIXTURE])
    assert e.value.code not in (0, None)
    if opts[0].startswith("-GMNumChips"):
        assert all(o.split("=")[0] in str(e.value.code) for o in opts)
    if opts[0].startswith("-GMPlace"):
        assert e.value.code == PLACE_ALONE
        with pytest.raises(SystemExit) as je:
            japps.main(["hop_dist"] + opts + [FIXTURE])
        assert je.value.code == PLACE_ALONE


@pytest.mark.parametrize("opts", [
    ["-GMPlacement=replicate"],
    ["-GMOutputFormat=EBIN"],
    ["-GMPlacement=distribute", "-GMOutputFormat=BIN"],
    ["-GMDumpGraph=0", "-GMOutputFormat=NULL", "-GMProfile=0"]])
def test_accepted_and_ignored_options(opts, capsys):
    """What the JAX CLI takes and ignores on one device changes nothing."""
    base = ["hop_dist", "-GMDevice=cpu", FIXTURE]
    want = run(capsys, apps.main, base)
    got = run(capsys, apps.main, base[:2] + opts + base[2:])
    assert results(got) == results(want)
    assert "CRC16 dist 0x5003" in got


def test_accepted_options_and_usage(capsys):
    lines = run(capsys, apps.main, ["hop_dist", "-GMDevice=cpu",
                                    "-GMNumChips=1", "-GMProfile=0",
                                    "-GMNumThreads=8", "-GMDumpValues=2",
                                    "-root=3", FIXTURE])
    assert "dist[3] = 0" in lines          # the root's own distance
    assert apps.main([]) == 1
    assert apps.main(["no_such_app", FIXTURE]) == 1
    assert len(apps.APPS) == 25
    # the JAX CLI's apps but the two that exist only as compiled .gm
    assert set(japps.APPS) - set(apps.APPS) == {"adamicAdar", "b2"}


@pytest.mark.parametrize("opts", [
    ["-GMProfile"], ["-GMProfile=1"], ["-GMDumpGraph=1"],
    ["-GMDumpGraph=1", "-GMOutputFormat=EBIN"], ["-GMInputFormat=AVRO"]])
def test_profile_dump_and_avro_match_jax_cli(opts, tmp_path, capsys):
    """-GMProfile, -GMDumpGraph and AVRO input on hop_dist: the result
    lines, the superstep lines and the written file equal the JAX CLI's."""
    from green_marl_tpu.graph import avro_io as javro
    graph = FIXTURE
    if "-GMInputFormat=AVRO" in opts:
        raw = jbio.load_binary(FIXTURE)
        graph = str(tmp_path / "parity10k.avro")
        javro.store_avro(graph, raw.begin, raw.node_idx)
    out = {}
    for name, main, dev in (("jax", japps.main, []),
                            ("port", apps.main, ["-GMDevice=cpu"])):
        argv = ["hop_dist"] + dev + opts + [graph]
        if opts[0].startswith("-GMDumpGraph"):
            argv.append(str(tmp_path / f"{name}.out"))
        out[name] = run(capsys, main, argv)
    assert results(out["port"]) == results(out["jax"])
    assert "CRC16 dist 0x5003" in out["port"]
    steps = [[ln.split(" ")[0] for ln in out[k]
              if ln.startswith("superstep[")] for k in ("jax", "port")]
    assert steps[0] == steps[1] and (len(steps[1]) > 0) == (
        "-GMProfile" in opts[0])
    if opts[0].startswith("-GMDumpGraph"):
        jf, tf = (open(tmp_path / f"{k}.out", "rb").read()
                  for k in ("jax", "port"))
        assert tf == jf and len(tf) > 0


def test_sssp_keeps_its_device_weights(capsys):
    """The second run reuses the weights tensor of the first, so that the
    timed run of -GMMeasureTime does not upload them."""
    from green_marl_tpu_torch.models import sssp as tsssp
    m = apps.make_sssp()
    assert m.O.parse(["-GMDevice=cpu", FIXTURE])
    ctx = m.load(torch.device("cpu"))
    seen = []
    real = tsssp.sssp

    def spy(g, root, edge_len, **kw):
        seen.append(edge_len)
        return real(g, root, edge_len, **kw)

    tsssp.sssp = spy
    try:
        first = m.run_fn(ctx)
        second = m.run_fn(ctx)
    finally:
        tsssp.sssp = real
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen[0] is ctx.device_props["len"]
    np.testing.assert_array_equal(first["dist"], second["dist"])
    np.testing.assert_array_equal(
        seen[0].numpy()[: ctx.graph.num_edges], ctx.edge_props["len"])
    m.report(ctx, second)
    assert "CRC16 dist 0x8e4e" in capsys.readouterr().out.splitlines()


@pytest.fixture(scope="module")
def small_rmat(tmp_path_factory):
    """An RMAT of 500 nodes as a BIN file, for the apps that sync once a
    step (v_cover) or build a dense N x N matrix (potential_friends)."""
    from green_marl_tpu.graph import generate as jgen
    from green_marl_tpu.graph.csr import from_edges as jfrom_edges
    src, dst = jgen.rmat_edges(500, 1500, seed=41)
    g, _ = jfrom_edges(src, dst, 500)
    path = str(tmp_path_factory.mktemp("rmat") / "rmat500.bin")
    jbio.store_binary(path, np.asarray(g.begin),
                      np.asarray(g.node_idx)[: g.num_edges])
    return path


@pytest.mark.parametrize("app,small,must_have", [
    ("triangle_counting", False, "number of triangles: 93"),
    ("conduct", False, "conduct returns: "),
    ("conduct_main", False, "sum C = "),
    ("weak_cc", False, "CRC16 comp "),
    ("avg_teen_cnt", False, "avg = "),
    ("communities", False, "CRC16 Comm "),
    ("v_cover", True, "covered (may be non-deterministic) = "),
    ("potential_friends", True, "potential friend pairs = ")])
def test_new_apps_match_jax_cli(app, small, must_have, small_rmat, capsys):
    argv = [app, small_rmat if small else FIXTURE]
    want = run(capsys, japps.main, argv)
    got = run(capsys, apps.main, argv[:1] + ["-GMDevice=cpu"] + argv[1:])
    assert results(got) == results(want)
    assert any(ln.startswith(must_have) for ln in got)


def test_conduct_reads_membership_from_ebin(tmp_path, capsys):
    raw = jbio.load_binary(FIXTURE)
    member = np.random.default_rng(5).integers(0, 3, raw.num_nodes) \
        .astype(np.int32)
    path = str(tmp_path / "member.ebin")
    jbio.store_binary(path, raw.begin, raw.node_idx, node_props=[member])
    argv = ["conduct", "-GMInputFormat=EBIN", "-num=2", path]
    want = run(capsys, japps.main, argv)
    got = run(capsys, apps.main, argv[:1] + ["-GMDevice=cpu"] + argv[1:])
    assert results(got) == results(want)
    assert not any(ln == "conduct returns: 0.000000000" for ln in got)


def test_port_runs_without_jax():
    """Block jax and green_marl_tpu, import every port module, run hop_dist."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "green_marl_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import green_marl_tpu_torch
for m in pkgutil.walk_packages(green_marl_tpu_torch.__path__,
                               "green_marl_tpu_torch."):
    importlib.import_module(m.name)
from green_marl_tpu_torch.cli import apps
rc = apps.main(["hop_dist", "-GMDevice=cpu", sys.argv[1]])
assert not any(k.split(".")[0] in ("jax", "green_marl_tpu")
               for k in sys.modules)
sys.exit(rc)
"""
    proc = subprocess.run([sys.executable, "-c", code, FIXTURE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "CRC16 dist 0x5003" in proc.stdout.splitlines()


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, shutil.copy(
                            os.path.join(REPO, "chip_smoke.py"), tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
