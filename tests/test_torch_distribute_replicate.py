"""The port's edge-sharded compiled path (``lang.distribute``, the
``replicate`` placement) and the CLI's ``-GMNumChips`` held against the JAX
package's on the CPU.

As in ``tests/test_torch_distribute.py``: the JAX side on the 8 virtual
CPU devices of ``tests/conftest.py``, the port on 1, 3 or 8 CPU shards,
the same inline ``.gm`` sources on the same numpy graph; the port's runs
held against the JAX package's edge-sharded run at 8 shards for hop_dist
and its single-device lowering for the rest.  The CLI's
compiled placements read the inline programs as the reference's sources
(``GM_REFERENCE_APPS``); its ``engine`` placement is held against the JAX
CLI's lines.
"""

import warnings

import numpy as np
import pytest
import torch

from green_marl_tpu.cli import apps as japps
from green_marl_tpu.lang import distribute as JD
from green_marl_tpu.lang import lower as JL

from green_marl_tpu_torch.cli import apps
from green_marl_tpu_torch.graph import binary_io as bio
from green_marl_tpu_torch.lang import distribute as TD
from green_marl_tpu_torch.lang import lower as TL
from green_marl_tpu_torch.parallel import comm
from green_marl_tpu_torch.utils.gm_rand import sssp_edge_lengths

from test_torch_distribute import (  # noqa: F401  (graphs: a fixture)
    PARITY10K, PATHS_GM, PROGRAMS, REJECTED_VERTEX, REVREACH_GM, SHARDS,
    SSSP_GM, _args, _compile, _jmesh, _match, _tmesh, graphs,
    jax_reference, same_error)


@pytest.mark.parametrize("name", ["pagerank", "hop_dist", "sssp", "conduct"])
@pytest.mark.parametrize("S", SHARDS)
def test_run_sharded_matches_jax(graphs, S, name):
    gj, gt = graphs
    kw = _args(gj.n_pad, gj.e_pad, name)
    if name == "pagerank":
        kw = dict(e=1e-8, d=0.85, max=30)
    want = jax_reference(
        graphs, ("replicate", name), PROGRAMS[name],
        JD.run_sharded if name == "hop_dist" else None, **kw)
    got = TD.run_sharded(_compile(TL, PROGRAMS[name]), gt, mesh=_tmesh(S),
                         **kw)
    _match(want, got)


@pytest.mark.parametrize("text", [PATHS_GM, REVREACH_GM],
                         ids=["inbfs", "transposed_inbfs"])
def test_inbfs_sharded_matches_jax(graphs, text):
    """InBFS over edge slabs: each level's reach is reduced over the slab's
    endpoints and combined across shards, then the traced replay."""
    _, gt = graphs
    want = jax_reference(graphs, ("single", text), text, root=0)
    got = TD.run_sharded(_compile(TL, text), gt, root=0, mesh=_tmesh(8))
    _match(want, got)


def test_scalar_edge_reduction_sharded(graphs):
    src = """
Procedure esum(G: Graph, w: E_P<Double>) : Double
{
    Double s = 0.0;
    Foreach(e: G.Edges) {
        s += e.w;
    }
    Return s;
}
"""
    gj, gt = graphs
    w = np.random.RandomState(1).rand(gj.e_pad).astype(np.float32)
    w[gj.num_edges:] = 0.0
    want = jax_reference(graphs, ("single", src), src, w=w)
    got = TD.run_sharded(_compile(TL, src), gt, mesh=_tmesh(8), w=w)
    _match(want, got)
    np.testing.assert_allclose(float(got["_return"]),
                               w[:gj.num_edges].sum(), rtol=1e-5)


def test_random_target_sum_not_multiplied(graphs):
    """A node-context random-keyed += is replicated under edge sharding and
    must not be psum'd across shards."""
    src = """
Procedure selfcnt(G: Graph, p: N_P<Node>, cnt: N_P<Int>)
{
    Foreach(n: G.Nodes) { n.p = n; }
    Foreach(n: G.Nodes) {
        Node m = n.p;
        m.cnt += 1;
    }
}
"""
    gj, gt = graphs
    out = TD.run_sharded(_compile(TL, src), gt, mesh=_tmesh(8))
    c = out["cnt"][: gt.num_nodes].numpy()
    np.testing.assert_array_equal(c, np.ones_like(c))
    _match(jax_reference(graphs, ("single", src), src), out)


def test_edge_local_read_when_a_slab_is_n_pad_slots():
    """sssp.gm edge-sharded 8 ways on parity10k: every slab then holds
    10,112 slots, as many as N_pad, and the edge loop's ``Edge e`` must
    stay per slot.  The port equals its single-device run; the JAX package
    gathers ``e`` at the source nodes here and returns other distances."""
    g, _ = bio.load_binary(PARITY10K).freeze()
    w = np.zeros(g.e_pad, np.int32)
    w[: g.num_edges] = sssp_edge_lengths(g.num_edges)
    cp = _compile(TL, SSSP_GM)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = cp(g, root=0, len=w)["dist"]
        got = TD.run_sharded(cp, g, mesh=_tmesh(8), root=0, len=w)["dist"]
    assert TD.pad_edges_for(g, 8).e_pad // 8 == g.n_pad
    assert torch.equal(got[: g.n_pad], ref)


REJECTED_REPLICATE = {
    "has_edge_to": ("""
Procedure tri(G: Graph) : Long
{
    Long T = 0;
    Foreach(v: G.Nodes) {
        Foreach(u: v.Nbrs)(u > v) {
            If (u.HasEdgeTo(v)) {
                T += 1;
            }
        }
    }
    Return T;
}""", {}),
    "rng": REJECTED_VERTEX["rng"],
    "random_read": REJECTED_VERTEX["random_read"],
    "random_target_write": REJECTED_VERTEX["random_scatter"],
}


@pytest.mark.parametrize("name", list(REJECTED_REPLICATE))
def test_replicate_rejections_match_jax(graphs, name):
    gj, gt = graphs
    text, kw = REJECTED_REPLICATE[name]
    same_error(
        lambda: JD.run_sharded(_compile(JL, text), gj, mesh=_jmesh(8), **kw),
        lambda: TD.run_sharded(_compile(TL, text), gt, mesh=_tmesh(8), **kw))


def test_replicate_rejects_dfs(graphs):
    """A DFS needs concrete neighbour walks: refused with the JAX
    lowerer's text (the JAX driver fails earlier, tracing the program)."""
    _, gt = graphs
    text, kw = REJECTED_VERTEX["dfs"]
    with pytest.raises(TL.LowerError, match="InDFS not supported in "
                       "distributed lowering"):
        TD.run_sharded(_compile(TL, text), gt, mesh=_tmesh(8), **kw)


# ---------------------------------------------------------------------------
# The CLI's -GMNumChips
# ---------------------------------------------------------------------------

@pytest.fixture
def reference_apps(tmp_path, monkeypatch):
    """The inline programs as the reference's sources, and 8 CPU shards."""
    for name, text in PROGRAMS.items():
        (tmp_path / f"{name}.gm").write_text(text)
    monkeypatch.setattr(apps, "REFERENCE_APPS", str(tmp_path))
    monkeypatch.setenv(comm.VIRTUAL_ENV, "8")
    return tmp_path


def _lines(capsys, main, argv):
    rc = main(argv)
    cap = capsys.readouterr()
    assert rc == 0, cap.out
    return [ln for ln in cap.out.splitlines() if "time=" not in ln], cap.err


def _ranks(lines):
    return np.array([float(ln.split(" = ")[1]) for ln in lines
                     if ln.startswith("rank[")])


@pytest.mark.parametrize("app", ["pagerank", "hop_dist", "sssp"])
def test_cli_engine_matches_jax_cli(reference_apps, capsys, app):
    """-GMNumChips=8 -GMPlacement=engine prints the JAX CLI's lines (the
    report on stderr); pagerank's values within tolerance."""
    argv = ["-GMNumChips=8", "-GMPlacement=engine", PARITY10K]
    want, _ = _lines(capsys, japps.main, [app] + argv)
    got, err = _lines(capsys, apps.main, [app, "-GMDevice=cpu"] + argv)
    assert "ghost exchange" in err
    if app == "pagerank":
        np.testing.assert_allclose(_ranks(got), _ranks(want), rtol=1e-5)
        got = [ln for ln in got if not ln.startswith(("rank", "CRC"))]
        want = [ln for ln in want if not ln.startswith(("rank", "CRC"))]
    assert got == want


@pytest.mark.parametrize("placement", ["distribute", "replicate"])
@pytest.mark.parametrize("app", ["pagerank", "hop_dist", "sssp"])
def test_cli_compiled_placements_match_one_device(reference_apps, capsys,
                                                  app, placement):
    """The distribute and replicate routes on the inline programs give the
    single-device port's CRCs (pagerank: values within tolerance)."""
    want, _ = _lines(capsys, apps.main, [app, "-GMDevice=cpu", PARITY10K])
    got, err = _lines(capsys, apps.main, [
        app, "-GMDevice=cpu", "-GMNumChips=8", f"-GMPlacement={placement}",
        PARITY10K])
    if placement == "distribute":
        assert "owned=" in err and "halo=" in err
    if app == "pagerank":
        np.testing.assert_allclose(_ranks(got), _ranks(want), rtol=1e-4)
    else:
        assert [ln for ln in got if ln.startswith("CRC")] == \
            [ln for ln in want if ln.startswith("CRC")]


@pytest.mark.parametrize("app", ["conduct", "avg_teen_cnt"])
def test_cli_reduction_apps_sharded(reference_apps, capsys, app):
    want, _ = _lines(capsys, apps.main, [app, "-GMDevice=cpu", PARITY10K])
    got, _ = _lines(capsys, apps.main, [app, "-GMDevice=cpu",
                                        "-GMNumChips=3", PARITY10K])
    assert got == want


def test_cli_too_few_devices_exits(monkeypatch, capsys):
    """Without GM_TORCH_VIRTUAL_DEVICES the CPU is one device: the run
    exits with the JAX CLI's wording, pointing at the variable."""
    monkeypatch.delenv(comm.VIRTUAL_ENV, raising=False)
    with pytest.raises(SystemExit) as e:
        apps.main(["hop_dist", "-GMDevice=cpu", "-GMNumChips=2",
                   "-GMPlacement=engine", PARITY10K])
    assert str(e.value.code).startswith("-GMNumChips=2: only 1 devices")
    assert comm.VIRTUAL_ENV in str(e.value.code)
    assert "CRC" not in capsys.readouterr().out
