"""The port's multi-device engines (``green_marl_tpu_torch.parallel``) held
against the JAX package's (``green_marl_tpu.parallel``) on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port runs the same number of shards as threads of one process
(``parallel.comm``).  Both take the same numpy graph
(``generate.rmat_edges`` from a seed, N=500, which 3 and 8 do not divide).
Host builds, schedules, reports, integer results and bit planes must agree
bit for bit; PageRank within rtol 1e-5 (e=1e-9, max_iter=30, so that the
order of a float psum cannot change the iteration count).
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import from_edges as jax_from_edges
from green_marl_tpu.parallel import sharded as JS
from green_marl_tpu.parallel import vertex_sharded as JV

from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.models.pagerank import pagerank
from green_marl_tpu_torch.parallel import comm
from green_marl_tpu_torch.parallel import sharded as TS
from green_marl_tpu_torch.parallel import vertex_sharded as TV

try:  # JAX >= 0.4.35
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

SHARDS = [1, 3, 8]
N, E = 500, 4000
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def graphs():
    src, dst = gen.rmat_edges(N, E, seed=11)
    gj, _ = jax_from_edges(src, dst, N)
    gt, _ = from_edges(src, dst, N)
    return gj, gt


def _meshes(S):
    return (JMesh(np.asarray(jax.devices()[:S]), ("v",)),
            comm.Mesh([torch.device("cpu")] * S))


@pytest.fixture(scope="module", params=SHARDS, ids=[f"S{s}" for s in SHARDS])
def vsgs(request, graphs):
    S = request.param
    gj, gt = graphs
    jm, tm = _meshes(S)
    jv = JV.place(JV.build_vertex_sharded(gj, S), jm)
    tv = TV.place(TV.build_vertex_sharded(gt, S), tm)
    return S, jm, tm, jv, tv


# ---------------------------------------------------------------------------
# Host builds and reports
# ---------------------------------------------------------------------------

def test_build_vertex_sharded_matches_jax(vsgs):
    S, jm, tm, jv, tv = vsgs
    for f in ("dst_local", "src_vidx", "emask", "csc_slot", "send_idx",
              "deg_owned"):
        a, b = np.asarray(getattr(jv, f)), getattr(tv, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("num_nodes", "num_edges", "num_shards", "L", "E_s", "cap",
              "ghost_total"):
        assert getattr(tv, f) == getattr(jv, f), f
    assert TV.placement_report(tv, tm) == JV.placement_report(jv, jm)
    # each shard's offsets describe its sorted destination slab
    for t in range(S):
        want = np.searchsorted(tv.dst_local[t].numpy(), np.arange(tv.L + 1))
        np.testing.assert_array_equal(tv.dst_off[t].numpy(), want)


@pytest.mark.parametrize("S", SHARDS)
def test_shard_graph_matches_jax(graphs, S):
    gj, gt = graphs
    sj, st = JS.shard_graph(gj, S), TS.shard_graph(gt, S)
    for f in ("csc_src", "csc_dst", "csc_eidx", "csr_src", "csr_dst",
              "begin", "r_begin"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert (st.n_pad, st.num_shards) == (sj.n_pad, sj.num_shards)


def test_shard_edge_prop_matches_jax(vsgs, graphs):
    _, _, _, jv, tv = vsgs
    gj, gt = graphs
    w = np.random.default_rng(5).integers(1, 9, gj.e_pad).astype(np.int32)
    np.testing.assert_array_equal(TV.shard_edge_prop(tv, gt, w).numpy(),
                                  np.asarray(JV.shard_edge_prop(jv, gj, w)))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_all_to_all_matches_jax(S):
    """Asymmetric values: shard s sends ``x[s, t]`` to shard t, and
    receives ``recv[s'] = x[s', s]`` as jax.lax.all_to_all(x, 0, 0)."""
    x = np.random.default_rng(S).integers(-1000, 1000, (S, S, 3)) \
        .astype(np.int32)
    jm, tm = _meshes(S)

    def jfn(v):
        return jax.lax.all_to_all(v[0], "v", 0, 0)[None]
    want = np.asarray(shard_map(jfn, mesh=jm, in_specs=JP("v"),
                                out_specs=JP("v"))(jnp.asarray(x)))

    def tfn(axes, v):
        return axes["v"].all_to_all(v[0])[None]
    got = comm.shard_map(tfn, tm, (comm.P("v"),), comm.P("v"))(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def mesh2x4(monkeypatch):
    """The port's ("batch", "v") 2x4 mesh of CPU shards."""
    monkeypatch.setenv(comm.VIRTUAL_ENV, "8")
    return TS.make_mesh(2, 4, kind="cpu")


def test_collectives_on_a_2d_mesh_match_jax(mesh2x4):
    """psum/pmin/pmax over each axis of a ("batch", "v") 2x4 mesh reduce
    within the group that shares the other coordinate."""
    x = np.random.default_rng(7).integers(-50, 50, (2, 4, 5)).astype(
        np.int32)
    jm = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("batch", "v"))
    tm = mesh2x4

    def jfn(v):
        return (jax.lax.psum(v, "v"), jax.lax.pmin(v, "batch"),
                jax.lax.pmax(v, "v"), jax.lax.psum(v, "batch"))
    spec = JP("batch", "v")
    want = shard_map(jfn, mesh=jm, in_specs=spec,
                     out_specs=(spec,) * 4)(jnp.asarray(x))

    def tfn(axes, v):
        return (axes["v"].psum(v), axes["batch"].pmin(v),
                axes["v"].pmax(v), axes["batch"].psum(v))
    tspec = comm.P("batch", "v")
    got = comm.shard_map(tfn, tm, (tspec,), (tspec,) * 4)(
        torch.from_numpy(x))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # axis indices and replicated outputs (rank 0's)
    idx = comm.shard_map(
        lambda axes: (torch.tensor([[axes["batch"].index(),
                                     axes["v"].index()]]), axes["v"].size),
        tm, (), (comm.P("batch"), comm.P()))()
    np.testing.assert_array_equal(idx[0].numpy(), [[0, 0], [1, 0]])
    assert idx[1] == 4


def test_a_rank_that_raises_does_not_hang():
    """One shard raising aborts the others at their next collective; the
    caller gets the first real error, well inside the time limit."""
    mesh = comm.Mesh([torch.device("cpu")] * 4)

    def fn(axes):
        ax = axes["v"]
        ax.psum(torch.ones(3))
        if ax.index() == 2:
            raise ValueError("shard 2 failed")
        for _ in range(3):
            ax.psum(torch.ones(3))
        return torch.ones(1)

    t0 = time.time()
    with pytest.raises(ValueError, match="shard 2 failed"):
        comm.shard_map(fn, mesh, (), comm.P(), timeout=30)()
    assert time.time() - t0 < 10
    assert threading.active_count() < 50


def test_diverging_collectives_raise():
    """Shards that call different collectives, or read different host
    predicates, fail loudly instead of deadlocking; a shard that never
    arrives times the others out."""
    mesh = comm.Mesh([torch.device("cpu")] * 3)

    def shapes(axes):
        return axes["v"].psum(torch.ones(axes["v"].index() + 1))
    with pytest.raises(comm.CollectiveMismatch, match="different"):
        comm.shard_map(shapes, mesh, (), comm.P(), timeout=30)()

    def kinds(axes):
        ax = axes["v"]
        x = torch.ones(3)
        return ax.pmin(x) if ax.index() == 1 else ax.pmax(x)
    with pytest.raises(comm.CollectiveMismatch):
        comm.shard_map(kinds, mesh, (), comm.P(), timeout=30)()

    def host(axes):
        return axes["v"].agree(axes["v"].index() < 1)
    with pytest.raises(comm.CollectiveMismatch, match="diverged"):
        comm.shard_map(host, mesh, (), comm.P(), timeout=30)()

    def absent(axes):
        if axes["v"].index() == 0:
            return torch.zeros(1)
        return axes["v"].psum(torch.ones(1))
    t0 = time.time()
    with pytest.raises(comm.CollectiveTimeout):
        comm.shard_map(absent, mesh, (), comm.P(), timeout=1.0)()
    assert time.time() - t0 < 10


def test_virtual_devices(monkeypatch):
    """GM_TORCH_VIRTUAL_DEVICES shards share a device; without it the CPU
    is one device and a wider mesh is refused."""
    monkeypatch.delenv(comm.VIRTUAL_ENV, raising=False)
    assert comm.devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match=comm.VIRTUAL_ENV):
        comm.vmesh(2, kind="cpu")
    monkeypatch.setenv(comm.VIRTUAL_ENV, "3")
    m = comm.vmesh(3, kind="cpu")
    assert m.shape == {"v": 3} and m.single_device() == torch.device("cpu")


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

def test_pagerank_vsharded_matches_jax(vsgs, graphs):
    S, jm, tm, jv, tv = vsgs
    jr, jd, jit = JV.pagerank_vsharded(jv, jm, e=1e-9, d=0.85, max_iter=30)
    tr, td, tit = TV.pagerank_vsharded(tv, tm, e=1e-9, d=0.85, max_iter=30)
    assert tit == int(jit)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-4, atol=1e-9)


def test_pagerank_vsharded_bit_identical_per_vertex_sums(vsgs, graphs):
    """Destination-owner placement keeps each vertex's in-edges in one
    contiguous slice: the sharded ranks equal the port's single-device
    ranks bit for bit."""
    S, jm, tm, jv, tv = vsgs
    _, gt = graphs
    ref = pagerank(gt, e=0.0, d=0.85, max_iter=5).rank[:N]
    got, _, it = TV.pagerank_vsharded(tv, tm, e=0.0, d=0.85, max_iter=5)
    assert it == 5
    assert torch.equal(got, ref)


@pytest.mark.parametrize("root", [0, 123])
def test_hop_dist_vsharded_matches_jax(vsgs, root):
    S, jm, tm, jv, tv = vsgs
    jd, jdepth = JV.hop_dist_vsharded(jv, jm, root)
    td, tdepth = TV.hop_dist_vsharded(tv, tm, root)
    assert td.dtype == torch.int32 and tdepth == int(jdepth)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_sssp_vsharded_matches_jax(vsgs, graphs):
    S, jm, tm, jv, tv = vsgs
    gj, gt = graphs
    w = np.zeros(gj.e_pad, np.int32)
    w[:E] = np.random.default_rng(17).integers(1, 20, E)
    jd, jit = JV.sssp_vsharded(jv, jm, JV.shard_edge_prop(jv, gj, w), 3)
    td, tit = TV.sssp_vsharded(tv, tm, TV.shard_edge_prop(tv, gt, w), 3)
    assert td.dtype == torch.int32 and tit == int(jit)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_multi_bfs_vsharded_matches_jax(vsgs):
    """B=70 (padded to 96): the int32 planes hold JAX's uint32 bits, the
    pad-instance bits cleared."""
    S, jm, tm, jv, tv = vsgs
    roots = (np.arange(70) * 7) % N
    jvis, jdepth = JV.multi_bfs_vsharded(jv, jm, roots)
    tvis, tdepth = TV.multi_bfs_vsharded(tv, tm, roots)
    assert tvis.dtype == torch.int32 and tvis.shape == (N, 3)
    assert tdepth == int(jdepth)
    np.testing.assert_array_equal(tvis.numpy().view(np.uint32),
                                  np.asarray(jvis))
    d1, _ = TV.hop_dist_vsharded(tv, tm, int(roots[69]))
    bit = (tvis[:, 2].numpy().view(np.uint32) >> np.uint32(5)) & 1
    np.testing.assert_array_equal(bit.astype(bool), d1.numpy() < INT32_MAX)


def test_popcount32():
    x = np.random.default_rng(2).integers(0, 2**32, 4096, dtype=np.uint32)
    got = TV.popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(got, want)


def test_pagerank_sharded_on_a_2x4_mesh(graphs, mesh2x4):
    gj, gt = graphs
    jm = JS.make_mesh(batch=1, v=8)
    sj = JS.place(JS.shard_graph(gj, 8), jm)
    jr, jd, jit = JS.pagerank_sharded(sj, jm, e=1e-9, max_iter=30)
    tm = mesh2x4
    st = TS.place(TS.shard_graph(gt, 4), tm)
    tr, td, tit = TS.pagerank_sharded(st, tm, e=1e-9, max_iter=30)
    assert tit == int(jit)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-9)


def test_multi_source_bfs_sharded_on_a_2x4_mesh(graphs, mesh2x4):
    gj, gt = graphs
    roots = np.asarray([0, 7, 90, 140], np.int32)
    jm = JS.make_mesh(batch=2, v=4)
    sj = JS.place(JS.shard_graph(gj, 4), jm)
    jd, jdepth = JS.multi_source_bfs_sharded(sj, jm, jnp.asarray(roots),
                                             max_iter=N)
    tm = mesh2x4
    st = TS.place(TS.shard_graph(gt, 4), tm)
    td, tdepth = TS.multi_source_bfs_sharded(st, tm, roots, max_iter=N)
    assert tdepth == int(jdepth)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
