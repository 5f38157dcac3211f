"""The port's component and path models, the EDGE/ADJ inputs and the nine
apps over them, against green_marl_tpu's on the CPU.

The same numpy inputs (RMAT edge lists from a seed, a graph of strongly
connected blocks, ``data/parity/parity10k.bin``) go through the JAX function
and its counterpart.  Levels, components, distances, predecessors, CSR
slots, orders, loaded arrays and loop counts must match bit for bit; ``bc``
within rtol 1e-5 (float32 sums in another order).  The apps' stdout result
lines must equal the JAX CLI's, BC values within rtol 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from green_marl_tpu.cli import apps as japps
from green_marl_tpu.graph import binary_io as jbio
from green_marl_tpu.graph import edge_list as jel
from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.models import bc as jbc
from green_marl_tpu.models import bfs as jbfs
from green_marl_tpu.models import delta_stepping as jds
from green_marl_tpu.models import dfs as jdfs
from green_marl_tpu.models import scc as jscc
from green_marl_tpu.models import sssp as jsssp
from green_marl_tpu.models import sssp_path as jsp
from green_marl_tpu.runtime import priority_map as jpm
from green_marl_tpu_torch.cli import apps
from green_marl_tpu_torch.graph import edge_list as tel
from green_marl_tpu_torch.graph.csr import ARRAY_FIELDS, graph_from_arrays
from green_marl_tpu_torch.models import bc as tbc
from green_marl_tpu_torch.models import bfs as tbfs
from green_marl_tpu_torch.models import delta_stepping as tds
from green_marl_tpu_torch.models import dfs as tdfs
from green_marl_tpu_torch.models import relax as trelax
from green_marl_tpu_torch.models import scc as tscc
from green_marl_tpu_torch.models import sssp as tsssp
from green_marl_tpu_torch.models import sssp_path as tsp
from green_marl_tpu_torch.runtime import priority_map as tpm

INT32_MAX = np.iinfo(np.int32).max
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "parity", "parity10k.bin")


def run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out.splitlines()


def results(lines):
    """The protocol lines that carry results (no timings)."""
    return [ln for ln in lines if "time=" not in ln]


def pair(src, dst, n):
    """(JAX graph, port graph on the CPU, begin, node_idx) of one edge list."""
    jg, _ = jfrom_edges(src, dst, n)
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, n, jg.num_edges)
    return jg, tg, np.asarray(jg.begin), np.asarray(jg.node_idx)[: jg.num_edges]


def blocks(n_blocks, size, seed):
    """Dense random blocks (most of each one strongly connected), joined by
    edges that run only from lower to higher blocks: many components of
    several sizes, and more than one FW-BW round."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for b in range(n_blocks):
        base = b * size
        k = 3 * size
        src.append(base + rng.integers(0, size, k))
        dst.append(base + rng.integers(0, size, k))
        if b + 1 < n_blocks:
            src.append(base + rng.integers(0, size, 3))
            dst.append(rng.integers(base + size, n_blocks * size, 3))
    return np.concatenate(src), np.concatenate(dst), n_blocks * size


@pytest.fixture(scope="module", params=[
    ("rmat", 600, 4000, 61), ("rmat", 600, 2500, 62), ("blocks", 12, 40, 63)])
def graphs(request):
    kind, a, b, seed = request.param
    if kind == "rmat":
        src, dst = jgen.rmat_edges(a, b, seed=seed)
        n = a
    else:
        src, dst, n = blocks(a, b, seed)
    jg, tg, begin, node_idx = pair(src, dst, n)
    deg = np.diff(begin)
    rng = np.random.default_rng(seed)
    w = np.zeros(jg.e_pad, np.int32)
    w[: jg.num_edges] = rng.integers(0, 100, jg.num_edges)
    roots = [int(np.argmax(deg)), int(np.flatnonzero(deg)[0]),
             int(np.flatnonzero(deg == 0)[0]) if (deg == 0).any() else 1]
    return jg, tg, begin, node_idx, w, roots


# -- bfs(reverse=True) --------------------------------------------------------

@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
def test_reverse_bfs_matches_jax_and_oracle(graphs, direction):
    jg, tg, begin, node_idx, _, roots = graphs
    n = tg.num_nodes
    # the transposed graph's CSR, for the oracle
    r_begin = np.asarray(jg.r_begin)
    r_src = np.asarray(jg.r_node_idx)[: jg.num_edges]
    for root in roots:
        jres = jbfs.bfs(jg, root, reverse=True, direction=direction)
        tres = tbfs.bfs(tg, root, reverse=True, direction=direction)
        np.testing.assert_array_equal(tres.level.numpy(),
                                      np.asarray(jres.level))
        assert tres.levels_run == int(jres.levels_run)
        assert tres.reached == int(jres.reached)
        np.testing.assert_array_equal(tres.level.numpy()[:n],
                                      tbfs.bfs_np(r_begin, r_src, root))


def test_level_masks_match_jax(graphs):
    jg, tg, _, _, _, roots = graphs
    level = tbfs.bfs(tg, roots[0]).level
    got = tbfs.level_masks(level, 6)
    assert got.dtype == torch.bool and got.shape == (6, tg.n_pad)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbfs.level_masks(jnp.asarray(level.numpy()),
                                                 6)))


# -- scc ----------------------------------------------------------------------

def test_scc_matches_jax_and_tarjan(graphs):
    jg, tg, begin, node_idx, _, _ = graphs
    jres = jscc.scc(jg)
    tres = tscc.scc(tg)
    assert tres.comp.dtype == torch.int32
    np.testing.assert_array_equal(tres.comp.numpy(), np.asarray(jres.comp))
    assert tres.rounds == int(jres.rounds) >= 1
    np.testing.assert_array_equal(tres.comp.numpy()[: tg.num_nodes],
                                  tscc.scc_np(begin, node_idx))
    np.testing.assert_array_equal(tscc.scc_np(begin, node_idx),
                                  jscc.scc_np(begin, node_idx))


@pytest.mark.parametrize("max_rounds", [1, 2, 3])
def test_scc_max_rounds_matches_jax(max_rounds):
    """The bound cuts all three loops, as in the JAX version: the partial
    result must still be the same."""
    jg, tg, _, _ = pair(*blocks(8, 30, 64))
    jres = jscc.scc(jg, max_rounds=max_rounds)
    tres = tscc.scc(tg, max_rounds=max_rounds)
    np.testing.assert_array_equal(tres.comp.numpy(), np.asarray(jres.comp))
    assert tres.rounds == int(jres.rounds) <= max_rounds


def test_scc_blocks_take_several_rounds():
    jg, tg, begin, node_idx = pair(*blocks(12, 40, 63))
    res = tscc.scc(tg)
    comp = res.comp.numpy()[: tg.num_nodes]
    assert res.rounds > 1 and len(np.unique(comp)) > 12
    assert (comp <= np.arange(tg.num_nodes)).all()
    assert (comp[comp] == comp).all()


# -- bc -----------------------------------------------------------------------

def test_bc_matches_jax_and_oracle(graphs):
    jg, tg, begin, node_idx, _, roots = graphs
    seeds = roots + [0, 3]
    jres = jbc.bc(jg, jnp.asarray(seeds, jnp.int32))
    tres = tbc.bc(tg, seeds)
    assert tres.bc.dtype == torch.float32
    np.testing.assert_allclose(tres.bc.numpy(), np.asarray(jres.bc),
                               rtol=1e-5, atol=1e-6)
    want = tbc.bc_np(begin, node_idx, seeds)
    np.testing.assert_allclose(tres.bc.numpy()[: tg.num_nodes], want,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(want, jbc.bc_np(begin, node_idx, seeds))


def test_bc_sum_equals_hop_distances(graphs):
    """With the seed's own dependency included, sum_v BC(v) from one seed
    is sum_t dist(s, t) over the nodes it reaches."""
    _, tg, _, _, _, roots = graphs
    r = roots[0]
    total = float(tbc.bc(tg, [r]).bc.double().sum())
    level = tbfs.bfs(tg, r).level
    assert total == pytest.approx(float(level[level > 0].double().sum()),
                                  rel=1e-5)


# -- sssp_path ----------------------------------------------------------------

def test_sssp_path_matches_jax_and_sssp(graphs):
    jg, tg, begin, node_idx, w, roots = graphs
    n = tg.num_nodes
    for root in roots:
        jres = jsp.sssp_path(jg, root, jnp.asarray(w))
        tres = tsp.sssp_path(tg, root, torch.from_numpy(w))
        for f in ("dist", "prev", "prev_edge"):
            np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                          np.asarray(getattr(jres, f)))
        assert tres.iterations == int(jres.iterations)
        sp = tsssp.sssp(tg, root, torch.from_numpy(w))
        assert torch.equal(tres.dist, sp.dist)
        assert tres.iterations == sp.iterations
        # prev_edge is an edge prev -> v that realises dist[v]
        dist = tres.dist.numpy()
        prev = tres.prev.numpy()[:n]
        pe = tres.prev_edge.numpy()[:n]
        src = np.asarray(jg.node_idx_src)
        got = np.flatnonzero(prev >= 0)
        assert (src[pe[got]] == prev[got]).all()
        assert (node_idx[pe[got]] == got).all()
        assert (dist[prev[got]] + w[pe[got]] == dist[got]).all()
        for v in got[:: max(1, got.size // 50)]:
            assert tsp.get_path(prev, root, int(v)) == \
                jsp.get_path(prev, root, int(v))
        assert tsp.get_path(prev, root, root) == [root]


# -- delta_stepping -----------------------------------------------------------

@pytest.mark.parametrize("delta", [1, 8, 64])
def test_delta_stepping_matches_jax_and_sssp(graphs, delta):
    jg, tg, begin, node_idx, w, roots = graphs
    for root in roots[:2]:
        jres = jds.delta_stepping(jg, root, jnp.asarray(w), delta=delta)
        tres = tds.delta_stepping(tg, root, torch.from_numpy(w), delta=delta)
        np.testing.assert_array_equal(tres.dist.numpy(),
                                      np.asarray(jres.dist))
        assert tres.buckets_processed == int(jres.buckets_processed) > 0
        assert tres.inner_steps == int(jres.inner_steps) > 0
        assert torch.equal(tres.dist,
                           tsssp.sssp(tg, root, torch.from_numpy(w)).dist)


def test_delta_stepping_caps_match_jax():
    jg, tg, _, _ = pair(*jgen.rmat_edges(300, 2000, seed=65), 300)
    w = np.zeros(jg.e_pad, np.int32)
    w[: jg.num_edges] = np.random.default_rng(65).integers(1, 50,
                                                           jg.num_edges)
    for caps in ({"max_buckets": 3}, {"max_inner": 1},
                 {"max_buckets": 5, "max_inner": 2}):
        jres = jds.delta_stepping(jg, 0, jnp.asarray(w), delta=4, **caps)
        tres = tds.delta_stepping(tg, 0, torch.from_numpy(w), delta=4, **caps)
        np.testing.assert_array_equal(tres.dist.numpy(),
                                      np.asarray(jres.dist))
        assert (tres.buckets_processed, tres.inner_steps) == (
            int(jres.buckets_processed), int(jres.inner_steps))


# -- host Dijkstra, priority map, dfs -----------------------------------------

def test_dijkstra_host_exact_matches_jax(graphs):
    jg, tg, _, _, w, roots = graphs
    n = tg.num_nodes
    for root, dest in ((roots[0], roots[1]), (roots[1], roots[0]),
                       (roots[0], n - 1), (roots[2], roots[0])):
        want = jsssp.dijkstra_host_exact(jg, w, root, dest)
        for lens in (w, torch.from_numpy(w)):
            got = tsssp.dijkstra_host_exact(tg, lens, root, dest)
            assert got[0] == want[0] and got[3] == want[3]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        if got[0] and root != dest:
            d = trelax.min_relax(tg, root, torch.from_numpy(w)).dist
            assert got[3] == int(d[dest])


def test_priority_map_pops_like_jax():
    rng = np.random.default_rng(66)
    for is_min in (True, False):
        a = jpm.MutatablePriorityMap(-1, is_min=is_min)
        b = tpm.MutatablePriorityMap(-1, is_min=is_min)
        for _ in range(3000):
            op = rng.integers(0, 4)
            if op < 3 or a.size() == 0:
                k, v = int(rng.integers(0, 200)), int(rng.integers(0, 20))
                a.set_value(k, v)
                b.set_value(k, v)
            else:
                assert b.peek_key() == a.peek_key()
                assert b.peek_value() == a.peek_value()
                assert b.remove_root() == a.remove_root()
            assert b.size() == a.size()
        b.check_integrity()
        assert b._keys == a._keys and b._vals == a._vals


def test_dfs_orders_match_jax(graphs):
    _, _, begin, node_idx, _, roots = graphs
    n = begin.shape[0] - 1
    for root in roots:
        got, want = tdfs.dfs(begin, node_idx, root), \
            jdfs.dfs(begin, node_idx, root)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    a = np.arange(n, dtype=np.float64)
    b = np.arange(n, dtype=np.float64)[::-1].copy()
    for x, y in zip(tdfs.b2(begin, node_idx, a, b, roots[0]),
                    jdfs.b2(begin, node_idx, a, b, roots[0])):
        np.testing.assert_array_equal(x, y)


# -- EDGE and ADJ inputs ------------------------------------------------------

def _edge_file(path, n=300, m=2000, seed=67):
    """An edge list with non-contiguous keys, a node-definition line per
    keyed node (int and double) and two edge properties (int and bool)."""
    rng = np.random.default_rng(seed)
    src, dst = jgen.rmat_edges(n, m, seed=seed)
    key = rng.permutation(10 * n)[:n] * 3 + 7
    nprops = [rng.integers(-50, 50, n).astype(np.int32), rng.random(n)]
    eprops = [rng.integers(1, 100, m).astype(np.int32), rng.random(m) < 0.5]
    jel.store_edge_list(path, src, dst, nodekey=key, node_props=nprops,
                        edge_props=eprops)
    return ([jbio.GMTYPE_INT, jbio.GMTYPE_DOUBLE],
            [jbio.GMTYPE_INT, jbio.GMTYPE_BOOL])


def test_edge_list_loader_matches_jax(tmp_path):
    path = str(tmp_path / "g.edge")
    ns, es = _edge_file(path)
    want = jel.load_edge_list(path, ns, es)
    got = tel.load_edge_list(path, ns, es)
    for f in ("src", "dst", "nodekey"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.num_nodes == want.num_nodes
    for a, b in zip(got.node_props + got.edge_props,
                    want.node_props + want.edge_props):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    (tg, tprops), (jg, jprops) = got.freeze(), want.freeze()
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    for a, b in zip(tprops, jprops):
        np.testing.assert_array_equal(a, b)
    # the port's writer, read back by the JAX reader
    path2 = str(tmp_path / "g2.edge")
    tel.store_edge_list(path2, got.src, got.dst, nodekey=got.nodekey,
                        node_props=got.node_props, edge_props=got.edge_props)
    again = jel.load_edge_list(path2, ns, es)
    np.testing.assert_array_equal(again.nodekey, want.nodekey)
    np.testing.assert_array_equal(again.dst, want.dst)


def test_adjacency_loader_matches_jax(tmp_path):
    path = tmp_path / "g.adj"
    path.write_text("# comment\n0 4 2 9\n\n3 1\n2\n7 0 0 5\n")
    got = tel.load_adjacency_list(str(path))
    want = jel.load_adjacency_list(str(path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- the CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def adj_fixture(tmp_path_factory):
    """parity10k as an adjacency list (every node, in id order)."""
    raw = jbio.load_binary(FIXTURE)
    begin, node_idx = np.asarray(raw.begin), np.asarray(raw.node_idx)
    path = tmp_path_factory.mktemp("adj") / "parity10k.adj"
    with open(path, "w") as f:
        for u in range(begin.shape[0] - 1):
            f.write(" ".join(map(str, [u, *node_idx[begin[u]:begin[u + 1]]]))
                    + "\n")
    return str(path)


def _split_bc(lines):
    bc = [float(ln.split(" = ")[1]) for ln in lines if ln.startswith("BC[")]
    return bc, [ln for ln in lines if not ln.startswith(("BC[", "CRC"))]


@pytest.mark.parametrize("argv,must_have", [
    (["kosaraju"], "num_membership = 5"),
    (["tarjan_scc"], "num_membership = 5"),
    (["sssp_path"], "0 -> 6375 -> 3953 -> 3521 -> 8551 -> 1"),
    (["sssp_path", "-begin=5", "-end=77"], "shortest path from 5 to 77"),
    (["sssp_path_adj"], "    Number of links is 5"),
    (["sssp_dijkstra"], "weight  141 ,hops  -1, path=FOUND"),
    (["sssp_dijkstra", "-src=9", "-dst=4"], "weight "),
    (["bidir_dijkstra"], "weight  141 ,hops   6, time    0.00 path="
                         "v0=>v6375=>v3953=>v3521=>v8551=>v1=>"),
    (["bidir_dijkstra", "-src=77", "-dst=5"], "weight "),
    (["bc"], "CRC16 BC "),
    (["bc_random", "-num_seeds=6"], "CRC16 BC "),
    (["bc_adj"], "CRC16 BC ")])
def test_path_apps_match_jax_cli(argv, must_have, adj_fixture, capsys):
    path = adj_fixture if argv[0].endswith("_adj") else FIXTURE
    want = results(run(capsys, japps.main, argv + [path]))
    got = results(run(capsys, apps.main, argv[:1] + ["-GMDevice=cpu"]
                      + argv[1:] + [path]))
    assert any(ln.startswith(must_have) for ln in got)
    if argv[0].startswith("bc"):
        (gbc, grest), (wbc, wrest) = _split_bc(got), _split_bc(want)
        assert grest == wrest and len(gbc) == 4
        np.testing.assert_allclose(gbc, wbc, rtol=1e-5, atol=0)
        assert max(gbc) > 0
    else:
        assert got == want


def test_hop_dist_and_sssp_read_edge_input(tmp_path, capsys):
    """EDGE input through both CLIs: node keys remapped, an edge property
    read as sssp's ``len``."""
    raw = jbio.load_binary(FIXTURE)
    begin, node_idx = np.asarray(raw.begin), np.asarray(raw.node_idx)
    src = np.repeat(np.arange(begin.shape[0] - 1), np.diff(begin))
    order = np.random.default_rng(68).permutation(src.shape[0])
    lens = np.random.default_rng(69).integers(1, 60, src.shape[0])
    path = str(tmp_path / "parity10k.edge")
    jel.store_edge_list(path, src[order], node_idx[order],
                        edge_props=[lens.astype(np.int32)])
    hop = str(tmp_path / "plain.edge")
    jel.store_edge_list(hop, src[order], node_idx[order])
    for argv in (["hop_dist", "-GMInputFormat=EDGE", "-root=3", hop],
                 ["sssp", "-GMInputFormat=EDGE", "-root=3", path]):
        want = run(capsys, japps.main, argv)
        got = run(capsys, apps.main, argv[:1] + ["-GMDevice=cpu"] + argv[1:])
        assert results(got) == results(want)
        assert any(ln.startswith("CRC16 dist ") for ln in got)


def test_load_keeps_csr_perm_and_nodekey(tmp_path, adj_fixture):
    path = str(tmp_path / "g.edge")
    src, dst = jgen.rmat_edges(300, 2000, seed=70)
    lens = np.random.default_rng(70).integers(1, 9, 2000).astype(np.int32)
    jel.store_edge_list(path, src, dst, nodekey=np.arange(300) * 5 + 2,
                        edge_props=[lens])
    m = apps.make_sssp()
    assert m.O.parse(["-GMDevice=cpu", "-GMInputFormat=EDGE", path])
    ctx = m.load(torch.device("cpu"))
    want = jel.load_edge_list(path, [], [jbio.GMTYPE_INT])
    np.testing.assert_array_equal(ctx.nodekey, want.nodekey)
    np.testing.assert_array_equal(ctx.csr_perm, np.arange(ctx.graph.num_edges))
    np.testing.assert_array_equal(ctx.edge_props["len"],
                                  want.freeze()[1][0])
    m = apps.make_bc("bc_adj")                    # ADJ by default
    assert m.O.parse(["-GMDevice=cpu", adj_fixture])
    ctx = m.load(torch.device("cpu"))
    src, dst = jel.load_adjacency_list(adj_fixture)
    _, perm = jfrom_edges(src, dst)
    np.testing.assert_array_equal(ctx.csr_perm, perm)
    assert ctx.nodekey is None
    m = apps.make_hop_dist()
    assert m.O.parse(["-GMDevice=cpu", FIXTURE])
    ctx = m.load(torch.device("cpu"))
    np.testing.assert_array_equal(ctx.csr_perm,
                                  jbio.load_binary(FIXTURE).freeze()[1])


@pytest.mark.parametrize("path", ["hdfs://nn/graph.bin", "gs://b/graph.bin"])
def test_remote_paths_exit(path, monkeypatch):
    """A remote input is staged by the ``hdfs`` or ``gsutil`` command; where
    that command is missing, the port fails as the JAX CLI does, with its
    message.  The commands are hidden from both packages (and any call of
    one fails the test), so that nothing here reaches for the network."""
    import shutil
    import subprocess

    from green_marl_tpu.graph import fs as jfs
    from green_marl_tpu_torch.graph import fs as tfs

    def refuse(*args, **kwargs):
        raise AssertionError(f"a remote command was started: {args}")

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(subprocess, "run", refuse)
    assert jfs.subprocess is subprocess and tfs.subprocess is subprocess
    with pytest.raises(RuntimeError) as e:
        apps.main(["hop_dist", "-GMDevice=cpu", path])
    with pytest.raises(RuntimeError) as je:
        japps.main(["hop_dist", path])
    assert str(e.value) == str(je.value)
    assert "CLI not available" in str(e.value) and path in str(e.value)


def test_path_apps_keep_their_device_tensors(capsys):
    """The second run of bidir_dijkstra reuses the first's weights and
    transposed graph, so that the timed run of -GMMeasureTime uploads
    nothing."""
    m = apps.make_bidir_dijkstra()
    assert m.O.parse(["-GMDevice=cpu", FIXTURE])
    ctx = m.load(torch.device("cpu"))
    m.run_fn(ctx)
    kept = dict(ctx.device_props)
    m.run_fn(ctx)
    assert set(kept) == {"Weight", "__transpose"}
    assert all(ctx.device_props[k] is v for k, v in kept.items())
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("weight  141 ")
