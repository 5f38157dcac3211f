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

# hop_dist.gm with dist an output: the .gm main of the -GMNumChips cases
HOP_DIST_OUT_GM = """
Procedure hop_dist(G:Graph, root: Node; dist:N_P<Int>)
{
    N_P<Bool> updated;
    N_P<Bool> updated_nxt;
    N_P<Int>  dist_nxt;
    Bool fin = False;
    G.dist = (G == root) ? 0 : +INF;
    G.updated = (G == root) ? True: False;
    G.dist_nxt = G.dist;
    G.updated_nxt = G.updated;
    While(!fin) {
        fin = True;
        Foreach(n: G.Nodes)(n.updated) {
            Foreach(s: n.Nbrs) {
                <s.dist_nxt; s.updated_nxt> min= <n.dist + 1; True>;
            }
        }
        G.dist = G.dist_nxt;
        G.updated = G.updated_nxt;
        G.updated_nxt = False;
        fin = ! Exist(n: G.Nodes){n.updated};
    }
}
"""


def _outcome(capsys, main, argv):
    """("ok", result lines) of a run, or ("exit", its message)."""
    try:
        rc = main(argv)
    except SystemExit as e:
        capsys.readouterr()
        return "exit", str(e.code)
    out = capsys.readouterr().out
    assert rc == 0, out
    return "ok", results(out.splitlines())


@pytest.mark.parametrize("opts", [
    ["-GMNumChips=2"],
    ["-GMNumChips=2", "-GMPlacement=replicate"],
    ["-GMNumChips=4", "-GMPlace=dist:replicate"],
    ["-GMNumChips=2", "-GMPlacementFile=placement.json"],
    ["-GMPlace=dist:replicate"],
    ["-GMPlacementFile=placement.json", "-GMNumChips=1"],
    ["-GMDevice=mps"]])
def test_unported_options_exit(opts, tmp_path, monkeypatch, capsys):
    """-GMNumChips>1 runs as the JAX CLI runs it (a .gm main: the named
    apps' compiled placements need the reference's sources): the same
    lines, or the same exit (an override of an unbound array, a missing
    placement file).  Placement overrides without -GMNumChips>1 and an
    unknown device exit; the overrides with the JAX CLI's message."""
    if opts[0].startswith("-GMNumChips"):
        gm = str(tmp_path / "hop_dist.gm")
        with open(gm, "w") as f:
            f.write(HOP_DIST_OUT_GM)
        monkeypatch.setenv("GM_TORCH_VIRTUAL_DEVICES", "8")
        want = _outcome(capsys, japps.main, [gm, "-root=3"] + opts
                        + [FIXTURE])
        got = _outcome(capsys, apps.main, [gm, "-GMDevice=cpu", "-root=3"]
                       + opts + [FIXTURE])
        assert got == want
        pinned = any(o.startswith(("-GMPlace=", "-GMPlacementFile="))
                     for o in opts)
        assert want[0] == ("exit" if pinned else "ok")
        if want[0] == "ok":
            assert "CRC16 dist 0x" in " ".join(got[1])
        return
    # a later -GMDevice replaces -GMDevice=cpu
    with pytest.raises(SystemExit) as e:
        apps.main(["hop_dist", "-GMDevice=cpu"] + opts + [FIXTURE])
    assert e.value.code not in (0, None)
    if opts[0].startswith("-GMPlace"):
        assert e.value.code == PLACE_ALONE
        with pytest.raises(SystemExit) as je:
            japps.main(["hop_dist"] + opts + [FIXTURE])
        assert je.value.code == PLACE_ALONE


def _rmat_bin(tmp_path, capsys, n, m, seed=4):
    from green_marl_tpu.cli import graph_gen
    binp = str(tmp_path / "g.bin")
    assert graph_gen.main(["-type=rmat", f"-seed={seed}", str(n), str(m),
                           binp]) == 0
    capsys.readouterr()
    return binp


def test_per_array_placement_cli(tmp_path, monkeypatch, capsys):
    """-GMPlace=arr:policy / -GMPlacementFile (Shoal's
    local_array_settings.lua): pinning a read-only property to its automatic
    policy leaves the output unchanged (the single-device CRC, as the JAX
    CLI's) and shows in the placement report; invalid pins exit with the
    JAX CLI's messages."""
    import json
    from test_torch_lower import SSSP_GM
    binp = _rmat_bin(tmp_path, capsys, 300, 2400)
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "sssp.gm").write_text(SSSP_GM)
    monkeypatch.setattr(apps, "REFERENCE_APPS", str(ref))
    monkeypatch.setenv("GM_TORCH_VIRTUAL_DEVICES", "8")
    crc = [ln for ln in run(capsys, japps.main, ["sssp", binp])
           if ln.startswith("CRC dist")]
    assert crc
    got = run(capsys, apps.main, ["sssp", "-GMDevice=cpu", "-GMNumChips=8",
                                  "-GMPlace=len:distribute", binp])
    assert [ln for ln in got if ln.startswith("CRC dist")] == crc
    pf = tmp_path / "place.json"
    pf.write_text(json.dumps({"len": "distribute"}))
    rc = apps.main(["sssp", "-GMDevice=cpu", "-GMNumChips=8",
                    f"-GMPlacementFile={pf}", binp])
    assert rc == 0
    assert "Array[len]:" in capsys.readouterr().err
    # an edge property cannot be replicated; a malformed flag
    for flag, frag in (("-GMPlace=len:replicate", "placement override"),
                       ("-GMPlace=oops", "arr:policy")):
        with pytest.raises(SystemExit, match=frag):
            apps.main(["sssp", "-GMDevice=cpu", "-GMNumChips=8", flag,
                       binp])
        capsys.readouterr()


@pytest.mark.parametrize("argv", [
    ["sssp", "-GMNumChips=8", "-GMPlacement=engine",
     "-GMPlace=len:distribute"],
    ["sssp", "-GMNumChips=8", "-GMPlacement=replicate",
     "-GMPlace=len:distribute"],
    ["pagerank", "-GMPlace=rank:distribute"]],
    ids=["engine", "replicate", "single_device"])
def test_placement_override_rejections_match_jax_cli(argv, tmp_path,
                                                     monkeypatch, capsys):
    """-GMPlace under the engine or replicate policies, or on one device,
    exits before running, with the JAX CLI's message."""
    binp = _rmat_bin(tmp_path, capsys, 200, 1600)
    monkeypatch.setenv("GM_TORCH_VIRTUAL_DEVICES", "8")
    with pytest.raises(SystemExit) as je:
        japps.main(argv + [binp])
    with pytest.raises(SystemExit) as te:
        apps.main(argv[:1] + ["-GMDevice=cpu"] + argv[1:] + [binp])
    assert str(te.value.code) == str(je.value.code)
    assert ("only with" in str(te.value.code)
            or "GMNumChips" in str(te.value.code))
    assert "CRC" not in capsys.readouterr().out


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
    assert len(apps.APPS) == 27
    # every app of the JAX CLI, adamicAdar and b2 (compiled .gm) included
    assert set(japps.APPS) == set(apps.APPS)


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


@pytest.fixture(scope="module")
def edge8_files(tmp_path_factory):
    """parity10k and a 300-node RMAT stored with 8-byte ``edge_t`` (the
    reference's EDGE_SIZE=64 build, as twitter_rv is stored)."""
    from green_marl_tpu.graph import generate as jgen
    d = tmp_path_factory.mktemp("edge8")
    raw = jbio.load_binary(FIXTURE)
    src, dst = jgen.rmat_edges(300, 1200, seed=13)
    order = np.lexsort((dst, src))
    begin = np.zeros(301, np.int64)
    np.cumsum(np.bincount(src, minlength=300), out=begin[1:])
    files = {}
    for name, (b, idx) in (("parity10k", (raw.begin, raw.node_idx)),
                           ("rmat300", (begin, dst[order]))):
        for nbytes in (4, 8):
            files[name, nbytes] = str(d / f"{name}_e{nbytes}.bin")
            jbio.store_binary(files[name, nbytes], b, idx,
                              edge_bytes=nbytes)
    return files


def _same_lines(got, want, rtol=1e-5):
    """Line by line: equal, or equal but for numbers that are floats in
    both and agree within ``rtol`` (float sums differ in their last bits
    between the two packages).  The CRCs of PageRank's float ranks hash
    those bits and are not compared."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if g == w or g.startswith(("CRC rank ", "CRC16 rank ")):
            continue
        gt, wt = g.split(), w.split()
        assert len(gt) == len(wt), (g, w)
        for a, b in zip(gt, wt):
            if a != b:
                assert "." in a + b, (g, w)        # integers are exact
                np.testing.assert_allclose(float(a.rstrip(",")),
                                           float(b.rstrip(",")),
                                           rtol=rtol, err_msg=f"{g} / {w}")


EDGE8_APPS = ("pagerank", "hop_dist", "sssp", "weak_cc", "kosaraju",
              "tarjan_scc", "bc", "sssp_path", "communities", "multi_bfs",
              "triangle_counting", "conduct", "avg_teen_cnt", "v_cover",
              "random_node_sampling", "potential_friends")


@pytest.mark.parametrize("graph", ["rmat300", "parity10k"])
@pytest.mark.parametrize("app", EDGE8_APPS)
def test_edge8_bin_matches_jax_cli(app, graph, edge8_files, capsys):
    """Every app that takes a plain graph, on a BIN file with 8-byte
    ``edge_t``: the port's lines are the JAX CLI's (integers and CRCs bit
    for bit, float values within rtol 1e-5) and, bit for bit, the port's
    own on the same graph stored with 4-byte ``edge_t``.  v_cover (a host
    sync a step) and potential_friends (a dense N x N product) run on the
    RMAT only."""
    if graph == "parity10k" and app in ("v_cover", "potential_friends"):
        pytest.skip("v_cover and potential_friends want a few hundred nodes")
    def lines(main, argv):
        # multi_bfs's line ends in its host-clock GTEPS
        return [ln.split(" aggregate=")[0]
                for ln in results(run(capsys, main, argv))]

    want = lines(japps.main, [app, edge8_files[graph, 8]])
    got = lines(apps.main, [app, "-GMDevice=cpu", edge8_files[graph, 8]])
    _same_lines(got, want)
    assert got == lines(apps.main, [app, "-GMDevice=cpu",
                                    edge8_files[graph, 4]])


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
