"""green_marl_tpu_torch's graph substrate against green_marl_tpu's.

The same host inputs go through both packages' loaders and builders; every
array of the port's ``Graph`` must equal the JAX one element by element.
"""

import os

import numpy as np
import pytest

from green_marl_tpu.graph import binary_io as jbio
from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph import native as jnative
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.graph.csr import to_undirected as jto_undirected
from green_marl_tpu_torch.graph import binary_io as tbio
from green_marl_tpu_torch.graph import csr as tcsr
from green_marl_tpu_torch.graph import generate as tgen
from green_marl_tpu_torch.graph import native as tnative

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data", "parity",
                       "parity10k.bin")


def assert_same_graph(tg, jg):
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges)
    assert (tg.n_pad, tg.e_pad) == (jg.n_pad, jg.e_pad)
    for f in tcsr.ARRAY_FIELDS:
        want = np.asarray(getattr(jg, f))
        got = getattr(tg, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("n,m,seed", [(300, 2000, 5), (1000, 9000, 6)])
def test_from_edges_matches_jax(monkeypatch, use_native, n, m, seed):
    src, dst = jgen.rmat_edges(n, m, seed=seed)
    jg, jperm = jfrom_edges(src, dst, n)
    if not use_native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    tg, tperm = tcsr.from_edges(src, dst, n)
    assert_same_graph(tg, jg)
    np.testing.assert_array_equal(tperm, jperm)


def test_from_edges_empty_and_bad_input():
    tg, _ = tcsr.from_edges(np.zeros(0, np.int32), np.zeros(0, np.int32), 5)
    jg, _ = jfrom_edges(np.zeros(0, np.int32), np.zeros(0, np.int32), 5)
    assert_same_graph(tg, jg)
    with pytest.raises(ValueError):
        tcsr.from_edges(np.array([0, 7]), np.array([1, 2]), 5)


def test_load_binary_freeze_matches_jax():
    traw = tbio.load_binary(FIXTURE)
    jraw = jbio.load_binary(FIXTURE)
    np.testing.assert_array_equal(traw.begin, jraw.begin)
    np.testing.assert_array_equal(traw.node_idx, jraw.node_idx)
    tg, tperm = traw.freeze()
    jg, jperm = jraw.freeze()
    assert_same_graph(tg, jg)
    np.testing.assert_array_equal(tperm, jperm)


def test_graph_from_arrays_round_trips_jax_graph():
    src, dst = jgen.rmat_edges(400, 3000, seed=7)
    jg, _ = jfrom_edges(src, dst, 400)
    arrays = {f: np.asarray(getattr(jg, f)) for f in tcsr.ARRAY_FIELDS}
    tg = tcsr.graph_from_arrays(arrays, jg.num_nodes, jg.num_edges)
    assert_same_graph(tg, jg)
    assert_same_graph(tg.to("cpu"), jg)
    np.testing.assert_array_equal(tg.out_degree().numpy(),
                                  np.asarray(jg.out_degree()))
    np.testing.assert_array_equal(tg.in_degree().numpy(),
                                  np.asarray(jg.in_degree()))
    np.testing.assert_array_equal(tg.node_mask().numpy(),
                                  np.asarray(jg.node_mask()))
    with pytest.raises(ValueError):
        tcsr.graph_from_arrays({"begin": arrays["begin"]}, 400, 3000)


@pytest.mark.parametrize("extended", [False, True])
def test_store_binary_round_trip(tmp_path, extended):
    src, dst = jgen.rmat_edges(200, 1500, seed=8)
    jg, _ = jfrom_edges(src, dst, 200)
    begin = np.asarray(jg.begin)
    node_idx = np.asarray(jg.node_idx)[: jg.num_edges]
    rng = np.random.default_rng(0)
    kw = {}
    if extended:
        kw = dict(nodekey=np.arange(200, dtype=np.int32)[::-1].copy(),
                  node_props=[rng.random(200), rng.random(200) < 0.5],
                  edge_props=[rng.integers(0, 9, jg.num_edges)
                              .astype(np.int32)])
    path = str(tmp_path / "g.bin")
    tbio.store_binary(path, begin, node_idx, **kw)
    with open(path, "rb") as f:
        tbytes = f.read()
    jbio.store_binary(path, begin, node_idx, **kw)
    with open(path, "rb") as f:
        assert f.read() == tbytes
    raw = tbio.load_binary(path)
    np.testing.assert_array_equal(raw.begin, begin)
    np.testing.assert_array_equal(raw.node_idx, node_idx)
    if extended:
        np.testing.assert_array_equal(raw.nodekey, kw["nodekey"])
        for got, want in zip(raw.node_props + raw.edge_props,
                             kw["node_props"] + kw["edge_props"]):
            np.testing.assert_array_equal(got, want)


def test_load_binary_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00\x00\x00\x01" + b"\x00" * 20)
    with pytest.raises(ValueError):
        tbio.load_binary(str(bad))
    with open(FIXTURE, "rb") as f:
        head = f.read(1000)
    short = tmp_path / "short.bin"
    short.write_bytes(head)
    with pytest.raises(EOFError):
        tbio.load_binary(str(short))


def test_native_library_matches_jax_binding():
    from green_marl_tpu.graph import native as jnative
    src, dst = tnative.rmat_edges(5000, 40000, seed=3)
    again = tnative.rmat_edges(5000, 40000, seed=3)
    np.testing.assert_array_equal(src, again[0])     # one stream per seed
    np.testing.assert_array_equal(dst, again[1])
    assert not np.array_equal(src, tnative.rmat_edges(5000, 40000,
                                                      seed=4)[0])
    assert src.min() >= 0 and max(src.max(), dst.max()) < 5000
    assert (src != dst).all()                        # no self-loops
    for got, want in zip(tnative.build_csr(src, dst, 5000),
                         jnative.build_csr(src, dst, 5000)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnative.xorshift_lengths(1000),
                                  jnative.xorshift_lengths(1000))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_matches_jax(seed):
    """graph/generate.py is a copy: equal arrays for equal seeds."""
    for name, args in (("uniform_random_edges", (300, 2000)),
                       ("uniform_random_nonmulti_edges", (100, 900)),
                       ("rmat_edges", (500, 4000))):
        want = getattr(jgen, name)(*args, seed=seed)
        got = getattr(tgen, name)(*args, seed=seed)
        for g_, w_ in zip(got, want):
            assert g_.dtype == w_.dtype
            np.testing.assert_array_equal(g_, w_)


@pytest.mark.parametrize("dedup", [True, False])
def test_to_undirected_matches_jax(dedup):
    src, dst = tgen.rmat_edges(200, 1500, seed=12)
    got = tcsr.to_undirected(src, dst, dedup=dedup)
    for g_, w_ in zip(got, jto_undirected(src, dst, dedup=dedup)):
        assert g_.dtype == w_.dtype
        np.testing.assert_array_equal(g_, w_)
    assert got[0].size == 3000 if not dedup else got[0].size < 3000


@pytest.mark.parametrize("seed", [13, 14])
def test_native_dag_bindings_match_jax(seed):
    """gm_build_dag and gm_desc_layout through both packages' bindings."""
    src, dst = tcsr.to_undirected(*tgen.rmat_edges(500, 5000, seed=seed),
                                  dedup=False)
    g, _ = tcsr.from_edges(src, dst, 500)
    begin = g.begin.numpy()
    node_idx = g.node_idx.numpy()[: g.num_edges]
    t_begin, t_dst = tnative.build_dag(begin, node_idx, 500)
    j_begin, j_dst = jnative.build_dag(begin, node_idx, 500)
    np.testing.assert_array_equal(t_begin, j_begin)
    np.testing.assert_array_equal(t_dst, j_dst)
    assert t_dst.dtype == np.int32 and 0 < t_dst.size < g.num_edges // 2
    # rows ascend strictly: sorted and deduplicated
    for r in range(500):
        row = t_dst[t_begin[r]:t_begin[r + 1]]
        assert (np.diff(row) > 0).all() and (row > r).all()
    got = tnative.desc_layout(t_begin, t_dst, 500, t_dst.size)
    want = jnative.desc_layout(j_begin, j_dst, 500, j_dst.size)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)
