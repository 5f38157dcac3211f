"""The port's main-path models against green_marl_tpu's and the oracles.

Each RMAT graph (same size, different seeds, so that each JAX model
compiles once) goes through the JAX model, the port's model on the CPU
(the kernels' plain versions) and the host ``*_np`` oracle.  Distances and
levels must match exactly with equal iteration counts; ranks within rtol
1e-5 and atol 1e-8 (float32 sums in another order), with equal counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.models import bfs as jbfs
from green_marl_tpu.models import hop_dist as jhop
from green_marl_tpu.models import pagerank as jpr
from green_marl_tpu.models import sssp as jsssp
from green_marl_tpu_torch.engine.superstep import converge_loop, while_loop
from green_marl_tpu_torch.graph.csr import ARRAY_FIELDS, graph_from_arrays
from green_marl_tpu_torch.models import bfs as tbfs
from green_marl_tpu_torch.models import hop_dist as thop
from green_marl_tpu_torch.models import pagerank as tpr
from green_marl_tpu_torch.models import relax as trelax
from green_marl_tpu_torch.models import sssp as tsssp

N, M = 2000, 16000
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module", params=[21, 22, 23])
def graphs(request):
    src, dst = jgen.rmat_edges(N, M, seed=request.param)
    jg, _ = jfrom_edges(src, dst, N)
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, N, jg.num_edges)
    begin = np.asarray(jg.begin)
    node_idx = np.asarray(jg.node_idx)[: jg.num_edges]
    deg = np.diff(begin)
    roots = [int(np.argmax(deg)), int(np.flatnonzero(deg)[0])]
    return jg, tg, begin, node_idx, roots


def test_pagerank_matches_jax_and_oracle(graphs):
    jg, tg, begin, node_idx, _ = graphs
    jr = jpr.pagerank(jg)
    tr = tpr.pagerank(tg)
    assert tr.iterations == int(jr.iterations)
    np.testing.assert_allclose(tr.rank.numpy(), np.asarray(jr.rank),
                               rtol=1e-5, atol=1e-8)
    rank_np, _, cnt_np = tpr.pagerank_np(begin, node_idx)
    assert tr.iterations == cnt_np
    np.testing.assert_allclose(tr.rank.numpy()[:N], rank_np, rtol=1e-4,
                               atol=1e-8)
    assert (tr.rank[N:] == 0).all()
    # a tighter e and another cap: still the same count as JAX
    jr = jpr.pagerank(jg, e=1e-6, max_iter=7)
    tr = tpr.pagerank(tg, e=1e-6, max_iter=7)
    assert tr.iterations == int(jr.iterations) == 7


def test_hop_dist_matches_jax_and_oracle(graphs):
    jg, tg, begin, node_idx, roots = graphs
    for root in roots:
        jres = jhop.hop_dist(jg, root)
        tres = thop.hop_dist(tg, root)
        assert tres.dist.dtype == torch.int32
        np.testing.assert_array_equal(tres.dist.numpy(), np.asarray(jres.dist))
        assert tres.iterations == int(jres.iterations)
        want = trelax.min_relax_np(begin, node_idx, root)
        got = tres.dist.numpy()[:N].astype(np.int64)
        np.testing.assert_array_equal(
            np.where(got == INT32_MAX, np.iinfo(np.int64).max, got), want)


def test_sssp_matches_jax_and_oracle(graphs):
    jg, tg, begin, node_idx, roots = graphs
    rng = np.random.default_rng(31)
    w = np.zeros(jg.e_pad, np.int32)
    w[: jg.num_edges] = rng.integers(1, 100, jg.num_edges)
    for root in roots:
        jres = jsssp.sssp(jg, root, jnp.asarray(w))
        tres = tsssp.sssp(tg, root, torch.from_numpy(w))
        np.testing.assert_array_equal(tres.dist.numpy(), np.asarray(jres.dist))
        assert tres.iterations == int(jres.iterations)
        want = trelax.min_relax_np(begin, node_idx, root,
                                   w[: jg.num_edges].astype(np.int64))
        got = tres.dist.numpy()[:N].astype(np.int64)
        np.testing.assert_array_equal(
            np.where(got == INT32_MAX, np.iinfo(np.int64).max, got), want)


@pytest.mark.parametrize("direction", ["auto", "pull", "push"])
def test_bfs_matches_jax_and_oracle(graphs, direction):
    jg, tg, begin, node_idx, roots = graphs
    for root in roots:
        jres = jbfs.bfs(jg, root, direction=direction)
        tres = tbfs.bfs(tg, root, direction=direction)
        np.testing.assert_array_equal(tres.level.numpy(),
                                      np.asarray(jres.level))
        assert tres.levels_run == int(jres.levels_run)
        assert tres.reached == int(jres.reached)
        np.testing.assert_array_equal(tres.level.numpy()[:N],
                                      tbfs.bfs_np(begin, node_idx, root))


def test_bfs_levels_equal_hop_dist(graphs):
    _, tg, _, _, roots = graphs
    for root in roots:
        level = tbfs.bfs(tg, root).level
        dist = thop.hop_dist(tg, root).dist
        assert torch.equal(torch.where(level >= 0, level, INT32_MAX), dist)


def test_bfs_rejects_unknown_direction(graphs):
    with pytest.raises(ValueError):
        tbfs.bfs(graphs[1], 0, direction="sideways")


def test_loops_count_like_jax():
    calls = []

    def step(s):
        calls.append(s)
        return s + 1

    state, stats = converge_loop(step, lambda s: torch.tensor(False),
                                 0, max_iter=5)
    assert (state, stats.iterations) == (1, 1)     # Do {} While runs once
    state, stats = while_loop(step, lambda s: torch.tensor(False), 0,
                              max_iter=5)
    assert (state, stats.iterations) == (0, 0)     # While tests first
    state, stats = while_loop(step, lambda s: torch.tensor(s < 3), 0,
                              max_iter=5)
    assert (state, stats.iterations) == (3, 3)
    state, stats = converge_loop(step, lambda s: torch.tensor(True), 0,
                                 max_iter=4)
    assert (state, stats.iterations) == (4, 4)


# -- every dtype the JAX package takes ---------------------------------------

def enable_x64():
    """JAX's 64-bit context, under its newer or its older name."""
    import jax
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64 as ctx
    return ctx()


def _parity10k():
    import os

    from green_marl_tpu.graph import binary_io as jbio
    path = os.path.join(os.path.dirname(__file__), "..", "data", "parity",
                        "parity10k.bin")
    jg, _ = jbio.load_binary(path).freeze()
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, jg.num_nodes,
                           jg.num_edges)
    return jg, tg


def test_pagerank_float64_matches_jax_x64():
    """The reference's pagerank is in Double: float64 takes the plain
    segment sum (the kernels have int32 and float32 only)."""
    jg, tg = _parity10k()
    tr = tpr.pagerank(tg, dtype=torch.float64)
    assert tr.rank.dtype == torch.float64
    with enable_x64():
        jr = jpr.pagerank(jg, dtype=jnp.float64)
        want = np.asarray(jr.rank)
        assert want.dtype == np.float64
        assert tr.iterations == int(jr.iterations)
    np.testing.assert_allclose(tr.rank.numpy(), want, rtol=1e-9, atol=0)
    # and it is not the float32 run in another coat
    r32 = tpr.pagerank(tg).rank.double().numpy()
    assert np.abs(r32 - want).max() > 1e-3 * np.abs(tr.rank.numpy()
                                                     - want).max() > 0 \
        or np.array_equal(tr.rank.numpy(), want)


@pytest.mark.parametrize("dtype,op", [
    (np.int64, "sum"), (np.int64, "min"), (np.int64, "max"),
    (np.float64, "sum"), (np.float64, "max"), (np.int16, "sum"),
    (np.int16, "min"), (np.uint8, "max"), (np.bool_, "max"),
    (np.bool_, "min")])
def test_pull_reductions_take_every_dtype(graphs, dtype, op):
    from green_marl_tpu.ops import segment as jseg
    from green_marl_tpu_torch.ops import segment as tseg
    jg, tg, _, _, _ = graphs
    rng = np.random.default_rng(7)
    if dtype == np.bool_:
        vals = rng.random(jg.n_pad) < 0.3
    elif dtype == np.float64:
        vals = rng.random(jg.n_pad)
    elif dtype == np.int64:
        vals = rng.integers(1 << 40, 1 << 50, jg.n_pad)
    else:
        vals = rng.integers(0, 20, jg.n_pad).astype(dtype)
    got = getattr(tseg, f"in_nbr_{op}")(tg, torch.from_numpy(vals))
    with enable_x64():
        want = np.asarray(getattr(jseg, f"in_nbr_{op}")(jg,
                                                        jnp.asarray(vals)))
    assert got.numpy().dtype == want.dtype == dtype
    # rows with no in-edge hold the identity here and the JAX CPU path's
    # fill there (both are the dtype's extreme for min/max)
    if dtype == np.float64 and op == "sum":
        np.testing.assert_allclose(got.numpy()[:N], want[:N], rtol=1e-12)
    else:
        np.testing.assert_array_equal(got.numpy()[:N], want[:N])
    assert len(np.unique(want[:N])) > 1


def test_bool_sum_is_refused_as_in_jax(graphs):
    from green_marl_tpu.ops import segment as jseg
    from green_marl_tpu_torch.ops import segment as tseg
    jg, tg, _, _, _ = graphs
    vals = np.zeros(jg.n_pad, bool)
    with pytest.raises(TypeError):
        jseg.in_nbr_sum(jg, jnp.asarray(vals))
    with pytest.raises(TypeError):
        tseg.in_nbr_sum(tg, torch.from_numpy(vals))


def test_out_nbr_and_count_reductions_int64(graphs):
    from green_marl_tpu.ops import scan_reduce as jscan
    from green_marl_tpu.ops import segment as jseg
    from green_marl_tpu_torch.ops import scan_reduce as tscan
    from green_marl_tpu_torch.ops import segment as tseg
    jg, tg, _, _, _ = graphs
    vals = np.random.default_rng(8).integers(1 << 33, 1 << 40, jg.n_pad)
    with enable_x64():
        jv = jnp.asarray(vals)
        want = [np.asarray(f(jg, jv)) for f in (
            jseg.out_nbr_sum, jseg.out_nbr_min, jscan.in_nbr_sum_int)]
    tv = torch.from_numpy(vals)
    got = [f(tg, tv) for f in (tseg.out_nbr_sum, tseg.out_nbr_min,
                               tscan.in_nbr_sum_int)]
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int64 and w_.dtype == np.int64
        np.testing.assert_array_equal(g_.numpy()[:N], w_[:N])
