"""The port's batched models and its multi_bfs CLI against green_marl_tpu's.

One small RMAT graph from a numpy seed (``w_max=16``, so hub chunks exist)
goes through each JAX model and its counterpart in the port, on the CPU.
Distances, bit planes, reached/traversed counts and iteration counts must
match exactly; ranks within rtol 1e-5 and atol 1e-9 (float32 sums in
another order than XLA's; each rank is ~1/N, so 1e-5 relative is a few
ulps of accumulated rounding over ~20 supersteps).  The port's bit planes
are uint8/int16/int32 where JAX's are uint8/uint16/uint32: the same bits,
compared through ``.view``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from green_marl_tpu.cli import apps as japps
from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.models import batched as jbat
from green_marl_tpu.ops import binned as jb
from green_marl_tpu_torch.cli import apps
from green_marl_tpu_torch.graph.csr import ARRAY_FIELDS, graph_from_arrays
from green_marl_tpu_torch.models import batched as tbat
from green_marl_tpu_torch.ops import binned as tb

from test_torch_cli import FIXTURE, run

N, M = 900, 9000
RTOL, ATOL = 1e-5, 1e-9
UNSIGNED = {8: np.uint8, 16: np.uint16, 32: np.uint32}


@pytest.fixture(scope="module")
def case():
    src, dst = jgen.rmat_edges(N, M, seed=41)
    jg, _ = jfrom_edges(src, dst, N)
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, N, jg.num_edges)
    jbp = jb.binned_in(jg, w_max=16)
    tbp = tb.binned_in(tg, w_max=16)
    assert tbp.n_hub_chunks > tbp.n_hub > 0
    deg = np.diff(np.asarray(jg.begin))
    deg_rows = np.zeros(jbp.n_rows, np.int32)
    deg_rows[:N] = deg[np.asarray(jbp.perm)]
    order = np.argsort(deg)[::-1]
    # the highest-degree roots, one low-degree root and a repeated root
    roots = np.concatenate([order[:20], order[-3:], order[:2]]) \
        .astype(np.int32)
    return jg, tg, jbp, tbp, deg_rows, roots


def test_multi_source_bfs_matches_jax(case):
    jg, tg, _, _, _, roots = case
    want = jbat.multi_source_bfs(jg, jnp.asarray(roots), chunk=4096)
    got = tbat.multi_source_bfs(tg, roots, chunk=4096)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert got.levels_run == int(want.levels_run)
    # the edge chunk does not change the result
    other = tbat.multi_source_bfs(tg, roots, chunk=1000)
    assert torch.equal(other.dist, got.dist)


def test_multi_source_bfs_binned_matches_jax(case):
    jg, tg, jbp, tbp, _, roots = case
    want = jbat.multi_source_bfs_binned(jbp, jnp.asarray(roots))
    got = tbat.multi_source_bfs_binned(tbp, roots)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert got.levels_run == int(want.levels_run)
    # and the scatter form, in original node order
    scatter = tbat.multi_source_bfs(tg, roots)
    np.testing.assert_array_equal(tbp.from_binned(got.dist[:N]).numpy(),
                                  scatter.dist[:N].numpy())
    assert torch.equal(tbat.multi_source_bfs_binned(
        tbp, roots, slot_chunk=64).dist, got.dist)


def test_multi_pagerank_matches_jax(case):
    jg, tg, _, _, _, _ = case
    damp = 0.85 + 0.01 * np.arange(6, dtype=np.float32) - 0.03
    for e, it in ((1e-3, 100), (0.0, 12)):
        want = jbat.multi_pagerank(jg, jnp.asarray(damp), e=e, max_iter=it,
                                   chunk=4096)
        got = tbat.multi_pagerank(tg, damp, e=e, max_iter=it, chunk=4096)
        assert got.iterations == int(want.iterations)
        np.testing.assert_allclose(got.rank.numpy(), np.asarray(want.rank),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.diff.numpy(), np.asarray(want.diff),
                                   rtol=1e-4, atol=1e-7)


def test_multi_pagerank_binned_matches_jax(case):
    jg, tg, jbp, tbp, deg_rows, _ = case
    damp = 0.85 + 0.0005 * np.arange(8, dtype=np.float32)
    deg_b = deg_rows[:N]
    for e, it in ((1e-3, 100), (0.0, 20)):
        want = jbat.multi_pagerank_binned(jbp, jnp.asarray(deg_b),
                                          jnp.asarray(damp), e=e, max_iter=it)
        got = tbat.multi_pagerank_binned(tbp, torch.from_numpy(deg_b), damp,
                                         e=e, max_iter=it)
        assert got.iterations == int(want.iterations)
        np.testing.assert_allclose(got.rank.numpy(), np.asarray(want.rank),
                                   rtol=RTOL, atol=ATOL)
    # in original order, the binned ranks are the scatter form's
    scatter = tbat.multi_pagerank(tg, damp, e=0.0, max_iter=20)
    np.testing.assert_allclose(tbp.from_binned(got.rank[:N]).numpy(),
                               scatter.rank[:N].numpy(), rtol=RTOL, atol=ATOL)


def test_multi_pagerank_binned_paged_matches_jax(case):
    _, _, jbp, tbp, deg_rows, _ = case
    damp = 0.85 + 0.0005 * np.arange(5, dtype=np.float32)
    deg_b = deg_rows[:N]
    for e, it in ((1e-3, 100), (0.0, 15)):
        want = jbat.multi_pagerank_binned_paged(
            jbp, jnp.asarray(deg_b), jnp.asarray(damp), e=e, max_iter=it,
            slot_chunk=1500)
        got = tbat.multi_pagerank_binned_paged(
            tbp, torch.from_numpy(deg_b), damp, e=e, max_iter=it,
            slot_chunk=1500)
        assert got.iterations == int(want.iterations)
        np.testing.assert_allclose(got.rank.numpy(), np.asarray(want.rank),
                                   rtol=RTOL, atol=ATOL)


def _check_bits(got, want, pb):
    np.testing.assert_array_equal(got.visited.numpy().view(UNSIGNED[pb]),
                                  np.asarray(want.visited))
    assert got.levels_run == int(want.levels_run)
    np.testing.assert_array_equal(got.reached.numpy(),
                                  np.asarray(want.reached))
    np.testing.assert_array_equal(got.traversed.numpy(),
                                  np.asarray(want.traversed))


@pytest.mark.parametrize("pb", [8, 16, 32])
def test_multi_source_bfs_bits_matches_jax(case, pb):
    _, tg, jbp, tbp, deg_rows, roots = case
    want = jbat.multi_source_bfs_bits(jbp, jnp.asarray(roots),
                                      jnp.asarray(deg_rows), plane_bits=pb)
    got = tbat.multi_source_bfs_bits(tbp, roots, torch.from_numpy(deg_rows),
                                     plane_bits=pb)
    assert got.visited.dtype == tbat.PLANE_DTYPES[pb]
    _check_bits(got, want, pb)
    # reached/traversed are the reached sets of the distance BFS
    dist = tbat.multi_source_bfs(tg, roots).dist[:N].numpy()
    deg = np.diff(tg.begin.numpy())
    seen = dist < np.iinfo(np.int32).max
    np.testing.assert_array_equal(got.reached.numpy(), seen.sum(0))
    np.testing.assert_array_equal(got.traversed.numpy(),
                                  (seen * deg[:, None]).sum(0))
    chunked = tbat.multi_source_bfs_bits(tbp, roots, torch.from_numpy(
        deg_rows), plane_bits=pb, slot_chunk=48)
    assert torch.equal(chunked.visited, got.visited)


@pytest.mark.parametrize("pb", [8, 32])
def test_multi_source_bfs_bits_paged_matches_jax(case, pb):
    _, _, jbp, tbp, deg_rows, roots = case
    want = jbat.multi_source_bfs_bits_paged(
        jbp, jnp.asarray(roots), jnp.asarray(deg_rows), plane_bits=pb,
        slot_chunk=1500)
    got = tbat.multi_source_bfs_bits_paged(
        tbp, roots, torch.from_numpy(deg_rows), plane_bits=pb,
        slot_chunk=1500)
    _check_bits(got, want, pb)


def test_bit_popstats_chunked(case, monkeypatch):
    _, _, _, tbp, deg_rows, roots = case
    res = tbat.multi_source_bfs_bits(tbp, roots, torch.from_numpy(deg_rows),
                                     plane_bits=16)
    monkeypatch.setattr(tbat, "_POP_CH", 100)
    cnt, trav = tbat._bit_popstats(res.visited, torch.from_numpy(deg_rows),
                                   res.visited.shape[1], bits=16)
    np.testing.assert_array_equal(cnt[:len(roots)].numpy(),
                                  res.reached.numpy())
    np.testing.assert_array_equal(trav[:len(roots)].numpy(),
                                  res.traversed.numpy())


def test_bits_seed_checks_plane_bits(case):
    _, _, _, tbp, _, roots = case
    with pytest.raises(ValueError):
        tbat._bits_seed(tbp, roots, 12)


def _batched_line(lines):
    (line,) = [ln for ln in lines if ln.startswith("batched bfs:")]
    return line.split(" aggregate=")[0]


@pytest.mark.parametrize("argv", [["-num_roots=40"],
                                  ["-num_roots=24", "-plane_bits=8"]])
def test_multi_bfs_cli_matches_jax_cli(capsys, argv):
    want = run(capsys, japps.main, ["multi_bfs", *argv, FIXTURE])
    got = run(capsys, apps.main, ["multi_bfs", "-GMDevice=cpu", *argv,
                                  FIXTURE])
    assert _batched_line(got) == _batched_line(want)
    assert "traversed=" in _batched_line(got)


def test_multi_bfs_cli_limits():
    for argv in (["-plane_bits=12"], ["-plane_bits=8", "-num_roots=1025"]):
        with pytest.raises(SystemExit):
            apps.main(["multi_bfs", "-GMDevice=cpu", *argv, FIXTURE])
