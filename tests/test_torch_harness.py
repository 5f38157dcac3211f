"""The port's harness (``green_marl_tpu_torch.harness``) against the JAX
package's on the CPU.

* ``harness.matrix_sweep``: the port's one-device values equal the JAX
  CLI's on the same BIN file (CRC lines of integer outputs exactly, every
  value by ``scripts/matrix_sweep.py:93-98``'s rule); each of the 12 cells
  passes with ``--gm-dir`` written from the inline ``.gm`` texts of the
  port's tests; the ``engine`` cells equal the JAX CLI's
  ``-GMNumChips=8 -GMPlacement=engine`` runs; without a ``.gm`` directory
  the compiled cells are reported as not run and counted.
* ``harness.scaling`` at N=40,000, E=400,000: ``L``, ``cap`` and
  ``ghost_total`` equal JAX's ``build_vertex_sharded`` at each S, ranks
  bit-identical across S and within rtol 1e-5 of JAX's
  ``pagerank_vsharded``.
* ``harness.multihost_bench`` at N=2,000, E=20,000, 5 supersteps: the three
  gloo arrangements give equal iterations and checksums, and the checksum
  equals the one of JAX's ``pagerank_vsharded`` ranks within rtol 1e-5.
* Asked for ``cuda`` without a card, each entry point exits non-zero.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from green_marl_tpu.cli import apps as japps
from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jax_from_edges
from green_marl_tpu.parallel import vertex_sharded as JV

from green_marl_tpu_torch.graph import generate as gen
from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.harness import matrix_sweep as M
from green_marl_tpu_torch.harness import multihost_bench as MB
from green_marl_tpu_torch.harness import scaling as SC

from test_torch_distribute import AVG_TEEN_CNT_GM, CONDUCT_GM
from test_torch_lower import HOP_DIST_GM, PAGERANK_GM, SSSP_GM

GM_TEXTS = {"pagerank": PAGERANK_GM, "hop_dist": HOP_DIST_GM,
            "sssp": SSSP_GM, "conduct": CONDUCT_GM,
            "avg_teen_cnt": AVG_TEEN_CNT_GM}
CELLS = [(app, pl) for app, pls in M.MATRIX for pl in pls]
INTEGER_APPS = ("hop_dist", "sssp")           # CRC lines of int outputs
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sweep_graph(tmp_path_factory):
    d = tmp_path_factory.mktemp("matrix")
    path = str(d / "m.bin")
    M.write_graph(path)
    gm = d / "gm"
    gm.mkdir()
    for app, text in GM_TEXTS.items():
        (gm / f"{app}.gm").write_text(text)
    return path, str(gm)


@pytest.fixture(scope="module")
def full_sweep(sweep_graph):
    path, gm = sweep_graph
    return M.sweep(path, "cpu", gm, log=lambda m: None)


@pytest.fixture(scope="module")
def bare_sweep(sweep_graph):
    return M.sweep(sweep_graph[0], "cpu", "", log=lambda m: None)


def jax_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert japps.main(argv) == 0
    return out.getvalue()


def test_sweep_graph_is_jaxs(sweep_graph, tmp_path):
    """The BIN file is the one ``scripts/matrix_sweep.py:73-86`` writes,
    byte for byte (the JAX package's generator, freeze and writer)."""
    from green_marl_tpu.graph import binary_io as jbio
    src, dst = jgen.rmat_edges(400, 3000, seed=7)
    jg, _ = jax_from_edges(src, dst, 400)
    member = np.random.default_rng(11).integers(0, 3, jg.num_nodes).astype(
        np.int32)
    path = str(tmp_path / "jax.bin")
    jbio.store_binary(path, np.asarray(jg.begin),
                      np.asarray(jg.node_idx)[: jg.num_edges],
                      node_props=[member])
    with open(path, "rb") as a, open(sweep_graph[0], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("app", [a for a, _ in M.MATRIX])
def test_one_device_values_equal_jax_cli(bare_sweep, sweep_graph, app):
    out = jax_cli([app, sweep_graph[0]])
    want = M.parse_values(out)
    base = bare_sweep["base"][app]
    assert want and M.mismatches(want, base["values"]) == []
    assert set(want) == set(base["values"])
    if app in INTEGER_APPS:
        assert base["crc"] == M.crc_lines(out)
    if app == "multi_bfs":
        assert want["traversed"] == base["values"]["traversed"]


@pytest.mark.parametrize("app,placement", CELLS)
def test_every_cell_passes_with_gm_dir(full_sweep, app, placement):
    cell = next(c for c in full_sweep["cells"]
                if (c["app"], c["placement"]) == (app, placement))
    assert cell["status"] == "ok", cell["why"]
    assert M.mismatches(full_sweep["base"][app]["values"], cell["got"]) == []
    if app in INTEGER_APPS:
        assert cell["crc"] == full_sweep["base"][app]["crc"]


def test_full_sweep_summary(full_sweep, sweep_graph, capsys):
    assert (full_sweep["ran"], full_sweep["passed"],
            full_sweep["not_run"]) == (12, 12, 0)
    assert M.main(["--device", "cpu", "--gm-dir", sweep_graph[1]]) == 0
    out = capsys.readouterr().out
    assert ("MATRIX OK: 12 of 12 sharded configs, all output-verified vs "
            "one device (0 not run: no .gm source)") in out
    assert out.splitlines()[0].startswith("# card: ")


@pytest.mark.parametrize("app", [a for a, pls in M.MATRIX
                                 if "engine" in pls])
def test_engine_cells_equal_jax_cli(bare_sweep, sweep_graph, app):
    out = jax_cli([app, "-GMNumChips=8", "-GMPlacement=engine",
                   sweep_graph[0]])
    cell = next(c for c in bare_sweep["cells"]
                if (c["app"], c["placement"]) == (app, "engine"))
    assert cell["status"] == "ok"
    want = M.parse_values(out)
    assert want and M.mismatches(want, cell["got"]) == []
    if app in INTEGER_APPS:
        assert cell["crc"] == M.crc_lines(out)


def test_compiled_cells_not_run_without_sources(bare_sweep, capsys):
    not_run = [c for c in bare_sweep["cells"] if c["status"] == "not run"]
    assert sorted((c["app"], c["placement"]) for c in not_run) == sorted(
        (a, p) for a, p in CELLS if p in M.COMPILED)
    assert all("no .gm source" in c["why"] for c in not_run)
    assert (bare_sweep["ran"], bare_sweep["passed"],
            bare_sweep["not_run"], bare_sweep["ok"]) == (4, 4, 8, True)


def test_a_missing_source_is_named_and_counted(sweep_graph, tmp_path,
                                              monkeypatch):
    """A directory that lacks one source: that cell alone is not run, on
    a line of its own, and the summary counts it."""
    (tmp_path / "pagerank.gm").write_text(PAGERANK_GM)
    monkeypatch.setattr(M, "MATRIX", [("pagerank", ["distribute", "engine"]),
                                      ("sssp", ["distribute"])])
    lines = []
    rec = M.sweep(sweep_graph[0], "cpu", str(tmp_path), log=lines.append)
    assert [c["status"] for c in rec["cells"]] == ["ok", "ok", "not run"]
    assert any(ln.startswith("not run") and "sssp.gm" in ln for ln in lines)
    assert lines[-1] == ("MATRIX OK: 2 of 3 sharded configs, all "
                         "output-verified vs one device (1 not run: no .gm "
                         "source)")


def test_a_failing_cell_fails_the_sweep(monkeypatch, capsys):
    """A cell whose values miss the one-device run's is named, fails the
    summary and makes the exit code 1."""
    monkeypatch.setattr(M, "MATRIX", [("hop_dist", ["engine"])])
    monkeypatch.setattr(M, "mismatches", lambda want, got: ["dist[3]: 9"])
    assert M.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAILED  hop_dist" in out and "dist[3]: 9" in out
    assert "MATRIX FAILED: 0 passed, 1 failed, of 1 sharded configs (0 " \
        "not run: no .gm source)" in out


# -- the scaling ladder ------------------------------------------------------

SCALE_N, SCALE_E = 40_000, 400_000


@pytest.fixture(scope="module")
def scaling_run():
    src, dst = gen.rmat_edges(SCALE_N, SCALE_E, seed=SC.SEED)
    g, _ = from_edges(src, dst, SCALE_N)
    rows, keep = SC.ladder(g, CPU, log=lambda m: None)
    jsrc, jdst = jgen.rmat_edges(SCALE_N, SCALE_E, seed=SC.SEED)
    np.testing.assert_array_equal(src, jsrc)
    jg, _ = jax_from_edges(jsrc, jdst, SCALE_N)
    return rows, keep, jg


@pytest.mark.parametrize("S", SC.LADDER)
def test_scaling_footprint_equals_jax(scaling_run, S):
    rows, _, jg = scaling_run
    row = next(r for r in rows if r["S"] == S)
    jv = JV.build_vertex_sharded(jg, S)
    assert (row["L"], row["cap"], row["ghost_total"], row["E_s"]) == (
        jv.L, jv.cap, jv.ghost_total, jv.E_s)
    assert row["state_bytes"] == jv.L * 4
    assert row["ghost_buf_bytes"] == S * jv.cap * 4
    assert row["iterations"] == SC.ITERS and row["ranks_equal"]


def test_scaling_ranks_match_jax(scaling_run):
    rows, keep, jg = scaling_run
    assert all(r["ranks_equal"] for r in rows)
    mesh = JV.vmesh(8)
    jv = JV.place(JV.build_vertex_sharded(jg, 8), mesh)
    rank, _, it = JV.pagerank_vsharded(jv, mesh, e=0.0, max_iter=SC.ITERS)
    assert int(it) == SC.ITERS
    np.testing.assert_allclose(keep["rank"].numpy(),
                               np.asarray(rank)[:SCALE_N], rtol=1e-5, atol=0)
    ids, off, n_out = keep["slab"]
    assert n_out == rows[-1]["L"] and off.numel() == n_out + 1


def test_slot_base_is_where_each_slab_sits(scaling_run):
    """``slot_base[t]``, the position the sharded PageRank gives the
    segment reduce (``base``), is the CSC slot of shard t's first edge;
    the plain version's sums do not depend on it."""
    from green_marl_tpu_torch.ops import kernels as K
    from green_marl_tpu_torch.parallel import vertex_sharded as V
    _, _, jg = scaling_run
    src, dst = gen.rmat_edges(SCALE_N, SCALE_E, seed=SC.SEED)
    g, _ = from_edges(src, dst, SCALE_N)
    vsg = V.build_vertex_sharded(g, 8)
    bounds = np.searchsorted(g.r_node_idx_dst.numpy()[: g.num_edges],
                             np.arange(8) * vsg.L)
    assert vsg.slot_base == tuple(int(b) for b in bounds)
    assert all(int(vsg.csc_slot[t, 0]) == vsg.slot_base[t]
               for t in range(8) if vsg.emask[t, 0])
    vals = torch.rand(vsg.E_s, generator=torch.Generator().manual_seed(5))
    args = (vals, vsg.dst_local[3], vsg.dst_off[3], vsg.L, "add")
    assert torch.equal(K.segment_reduce_sorted(*args, base=vsg.slot_base[3]),
                       K.segment_reduce_sorted(*args))


def test_scaling_table_and_json(capsys):
    assert SC.main(["--device", "cpu", "--nodes", "4000", "--edges",
                    "40000"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# card: ")
    assert any(ln.startswith("| 8 |") for ln in out)
    assert '"ok": true' in out[-1]


# -- the multi-process bench -------------------------------------------------

MH_N, MH_E, MH_ITERS = 2_000, 20_000, 5


def test_multihost_arrangements_agree_with_each_other_and_jax():
    row = MB.bench(MH_N, MH_E, CPU, MH_ITERS, log=lambda m: None)
    arr = row["arrangements"]
    assert [a["arrangement"] for a in arr] == [
        "1 process x 4 shards (threads)", "2 processes x 2 shards",
        "4 processes x 1 shards"]
    assert row["ok"] and all(a["status"] == "ran" and a["same_as_threads"]
                             and a["iters"] == MH_ITERS for a in arr)
    assert [s["shard"] for s in arr[0]["shards"]] == [0, 1, 2, 3]
    src, dst = jgen.rmat_edges(MH_N, MH_E, seed=MB.SEED)
    jg, _ = jax_from_edges(src, dst, MH_N)
    mesh = JV.vmesh(4)
    jv = JV.place(JV.build_vertex_sharded(jg, 4), mesh)
    rank, _, it = JV.pagerank_vsharded(jv, mesh, e=1e-30, d=0.85,
                                       max_iter=MH_ITERS)
    assert int(it) == MH_ITERS
    want = MB.checksums(torch.from_numpy(np.array(rank)), 0, 4, jv.L,
                        MH_N)
    got = arr[0]["shards"]
    np.testing.assert_allclose([s["wsum"] for s in got],
                               [s["wsum"] for s in want], rtol=1e-5)
    np.testing.assert_allclose(arr[0]["wsum"],
                               sum(s["wsum"] for s in want), rtol=1e-5)


def test_multihost_checksums_are_order_independent():
    """A shard's checksum depends on its rows and their ids, not on where
    the rows sit in the tensor a process holds."""
    rank = torch.rand(4 * 16, generator=torch.Generator().manual_seed(3))
    whole = MB.checksums(rank, 0, 4, 16, 60)
    parts = (MB.checksums(rank[:32], 0, 2, 16, 60)
             + MB.checksums(rank[32:], 2, 2, 16, 60))
    assert whole == parts
    assert [s["shard"] for s in whole] == [0, 1, 2, 3]
    other = rank.clone()
    other[5] += 1e-3
    assert MB.checksums(other, 0, 4, 16, 60)[0]["fold"] != whole[0]["fold"]
    # rows at or past N do not count
    tail = rank.clone()
    tail[60:] = 7.0
    assert MB.checksums(tail, 0, 4, 16, 60) == whole


# -- the device rule ---------------------------------------------------------

@pytest.mark.parametrize("module", [M, SC, MB])
def test_harness_needs_a_card_for_cuda(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        module.main(["--device", "cuda"])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert "# card" not in capsys.readouterr().out
