"""The port's small analytics models and the segment ops they need, against
green_marl_tpu's on the CPU.

The same RMAT edge lists (numpy, from a seed) go through the JAX function
and its counterpart.  Integers, labels, masks and iteration counts must
match bit for bit; ``conductance`` is exact in float32 for the four cuts of
``conduct_membership`` (integer sums, one division), ``avg_teen_cnt`` within
rtol 1e-6 and ``adamic_adar_edges`` within rtol 1e-5 (float32 sums in
another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.models import analytics as jan
from green_marl_tpu.models import cc as jcc
from green_marl_tpu.models import communities as jcomm
from green_marl_tpu.models import conductance as jcond
from green_marl_tpu.models import v_cover as jvc
from green_marl_tpu.ops import scan_reduce as jscan
from green_marl_tpu.ops import segment as jseg
from green_marl_tpu.utils import gm_rand as jrand
from green_marl_tpu_torch.graph.csr import ARRAY_FIELDS, graph_from_arrays
from green_marl_tpu_torch.models import analytics as tan
from green_marl_tpu_torch.models import cc as tcc
from green_marl_tpu_torch.models import communities as tcomm
from green_marl_tpu_torch.models import conductance as tcond
from green_marl_tpu_torch.models import v_cover as tvc
from green_marl_tpu_torch.ops import scan_reduce as tscan
from green_marl_tpu_torch.ops import segment as tseg
from green_marl_tpu_torch.utils import gm_rand as trand

N, M = 400, 3000


def make(n, m, seed):
    src, dst = jgen.rmat_edges(n, m, seed=seed)
    jg, _ = jfrom_edges(src, dst, n)
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, n, jg.num_edges)
    return jg, tg, np.asarray(jg.begin), np.asarray(jg.node_idx)[: jg.num_edges]


@pytest.fixture(scope="module", params=[31, 32])
def graphs(request):
    return make(N, M, request.param)


# -- segment ops -------------------------------------------------------------

def test_has_edge_to_matches_jax(graphs):
    jg, tg, begin, node_idx = graphs
    rng = np.random.default_rng(1)
    src = rng.integers(0, N, 5000).astype(np.int32)
    dst = rng.integers(0, N, 5000).astype(np.int32)
    # half of the queries are real edges
    e = rng.integers(0, jg.num_edges, 2500)
    src[:2500] = np.asarray(jg.node_idx_src)[e]
    dst[:2500] = node_idx[e]
    want = np.asarray(jseg.has_edge_to(jg, jnp.asarray(src),
                                       jnp.asarray(dst)))
    got = tseg.has_edge_to(tg, torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:2500].all() and not want.all()
    rows = [set(node_idx[begin[v]:begin[v + 1]].tolist()) for v in range(N)]
    np.testing.assert_array_equal(
        want, [d in rows[s] for s, d in zip(src, dst)])
    # int64 queries of another shape
    got2 = tseg.has_edge_to(tg, torch.from_numpy(src).long().view(50, 100),
                            torch.from_numpy(dst).long().view(50, 100))
    np.testing.assert_array_equal(got2.numpy().ravel(), want)


@pytest.mark.parametrize("shape,dtype", [((), np.int32), ((3,), np.int32),
                                         ((2,), np.uint8)])
def test_sorted_segment_or_matches_jax(shape, dtype):
    rng = np.random.default_rng(2)
    lens = rng.choice([0, 0, 1, 2, 5, 40], size=100)
    ids = np.repeat(np.arange(100), lens).astype(np.int32)
    hi = np.iinfo(dtype).max
    words = rng.integers(0, hi, (ids.size,) + shape).astype(dtype)
    words &= rng.integers(0, hi, words.shape).astype(dtype)   # sparser bits
    want = np.asarray(jseg.sorted_segment_or(jnp.asarray(words),
                                             jnp.asarray(ids), 110))
    got = tseg.sorted_segment_or(torch.from_numpy(words),
                                 torch.from_numpy(ids), 110)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want[:100][lens == 0].any()


def test_any_and_scatter_ops_match_jax(graphs):
    jg, tg, _, _ = graphs
    rng = np.random.default_rng(3)
    mask = rng.random(jg.n_pad) < 0.05
    mask[N:] = False
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    for tf, jf in ((tseg.in_nbr_any, jseg.in_nbr_any),
                   (tscan.in_nbr_any_fast, jscan.in_nbr_any_fast),
                   (tscan.out_nbr_any_fast, jscan.out_nbr_any_fast)):
        got, want = tf(tg, tm).numpy(), np.asarray(jf(jg, jm))
        np.testing.assert_array_equal(got[:N], want[:N])
        assert want[:N].any() and not want[:N].all()
    ev = rng.integers(1, 1000, jg.e_pad).astype(np.int32)
    nv = rng.integers(1, 1000, jg.n_pad).astype(np.int32)
    te, je = torch.from_numpy(ev), jnp.asarray(ev)
    for tf, jf in ((tseg.scatter_min_to_dst, jseg.scatter_min_to_dst),
                   (tseg.scatter_sum_to_dst, jseg.scatter_sum_to_dst)):
        np.testing.assert_array_equal(tf(tg, te).numpy()[:N],
                                      np.asarray(jf(jg, je))[:N])
    for edge in (None, te):
        got = tseg.push_edge_values(tg, torch.from_numpy(nv), edge)
        want = jseg.push_edge_values(jg, jnp.asarray(nv),
                                     None if edge is None else je)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for tf, jf in ((tseg.segment_sum, jseg.segment_sum),
                   (tseg.segment_min, jseg.segment_min),
                   (tseg.segment_max, jseg.segment_max)):
        for sorted_ids in (False, True):
            got = tf(te, tg.node_idx_src, jg.n_pad, sorted_ids=sorted_ids)
            want = jf(je, jg.node_idx_src, jg.n_pad, sorted_ids=sorted_ids)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_graph_accessors_match_jax(graphs):
    jg, tg, _, _ = graphs
    assert tg.sentinel == jg.sentinel == N
    assert tg.node_dtype == torch.int32 and tg.edge_dtype == torch.int32
    np.testing.assert_array_equal(tg.edge_mask().numpy(),
                                  np.asarray(jg.edge_mask()))
    for tf, jf, dt, jdt in ((tg.node_prop, jg.node_prop, torch.int32,
                             jnp.int32),
                            (tg.edge_prop, jg.edge_prop, torch.float32,
                             jnp.float32)):
        got, want = tf(7, dt), np.asarray(jf(7, jdt))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


# -- models ------------------------------------------------------------------

def test_weak_cc_matches_jax_and_oracle(graphs):
    jg, tg, begin, node_idx = graphs
    jr, tr = jcc.weak_cc(jg), tcc.weak_cc(tg)
    assert tr.iterations == int(jr.iterations) > 1
    assert tr.comp.dtype == torch.int32
    np.testing.assert_array_equal(tr.comp.numpy(), np.asarray(jr.comp))
    np.testing.assert_array_equal(tr.comp.numpy()[:N],
                                  tcc.weak_cc_np(begin, node_idx))
    assert len(np.unique(tr.comp.numpy()[:N])) > 1
    capped = tcc.weak_cc(tg, max_iter=2)
    assert capped.iterations == int(jcc.weak_cc(jg, max_iter=2).iterations) == 2


@pytest.mark.parametrize("seed", [33, 34])
def test_v_cover_matches_jax_and_oracle(seed):
    jg, tg, begin, node_idx = make(120, 500, seed)
    jr, tr = jvc.v_cover(jg), tvc.v_cover(tg)
    assert tr.iterations == int(jr.iterations) > 10
    assert int(tr.count) == int(jr.count)
    np.testing.assert_array_equal(tr.select.numpy(), np.asarray(jr.select))
    sel, cnt = tvc.v_cover_np(begin, node_idx)
    np.testing.assert_array_equal(tr.select.numpy()[: jg.num_edges], sel)
    assert int(tr.count) == cnt


@pytest.mark.parametrize("seed", [35, 36])
def test_communities_matches_jax_and_oracle(seed):
    jg, tg, begin, node_idx = make(300, 2400, seed)
    jr, tr = jcomm.communities(jg), tcomm.communities(tg)
    assert tr.iterations == int(jr.iterations) > 1
    np.testing.assert_array_equal(tr.comm.numpy(), np.asarray(jr.comm))
    np.testing.assert_array_equal(tr.comm.numpy()[:300],
                                  tcomm.communities_np(begin, node_idx))
    capped = tcomm.communities(tg, max_iter=2)
    np.testing.assert_array_equal(
        capped.comm.numpy(), np.asarray(jcomm.communities(jg, max_iter=2).comm))


def test_communities_int64_encoding(monkeypatch):
    """Where count * n_pad leaves int32 the encoding is int64 and the
    reductions take the plain version: the same labels."""
    jg, tg, _, _ = make(300, 2400, 35)
    want = tcomm.communities(tg)
    seen = []
    real = tcomm.ops.sorted_segment_reduce

    def spy(vals, *a):
        seen.append(vals.dtype)
        return real(vals, *a)

    monkeypatch.setattr(tcomm.ops, "sorted_segment_reduce", spy)
    monkeypatch.setattr(tcomm, "_ENC_LIMIT", 1)
    got = tcomm.communities(tg)
    assert torch.int64 in seen
    assert got.iterations == want.iterations
    assert torch.equal(got.comm, want.comm)


def test_potential_friends_and_directed_triangles(graphs):
    jg, tg, begin, node_idx = graphs
    np.testing.assert_array_equal(tan.potential_friends(tg).numpy(),
                                  np.asarray(jan.potential_friends(jg)))
    want = jan.triangle_directed_count(jg)
    assert tan.triangle_directed_count(tg) == want > 0
    assert tan.triangle_directed_count(tg, chunk=97) == want


def test_conduct_membership_and_conductance(graphs):
    jg, tg, _, _ = graphs
    want = jrand.conduct_membership(N)
    got = trand.conduct_membership(N)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert sorted(np.unique(got)) == [0, 1, 2, 3]
    member = np.zeros(jg.n_pad, np.int32)
    member[:N] = got
    for num in range(4):
        t = tcond.conductance(tg, torch.from_numpy(member), num)
        j = jcond.conductance(jg, jnp.asarray(member), num)
        assert t.dtype == torch.float32
        assert float(t) == float(j) > 0
    # an empty side: 0 when nothing crosses
    assert float(tcond.conductance(tg, torch.from_numpy(member), 9)) == \
        float(jcond.conductance(jg, jnp.asarray(member), 9)) == 0.0


def test_conduct_membership_native_above_a_million():
    n = 1_000_500
    got = trand.conduct_membership(n)
    small = trand.conduct_membership(2000)
    np.testing.assert_array_equal(got[:2000], small)
    assert np.bincount(got).tolist() == np.bincount(got, minlength=4).tolist()


def test_avg_teen_cnt_matches_jax(graphs):
    jg, tg, _, _ = graphs
    rng = np.random.default_rng(4)
    age = rng.integers(0, 60, jg.n_pad).astype(np.int32)
    for k in (5, 30, 99):
        tavg, tcnt = tan.avg_teen_cnt(tg, torch.from_numpy(age), k)
        javg, jcnt = jan.avg_teen_cnt(jg, jnp.asarray(age), k)
        np.testing.assert_array_equal(tcnt.numpy()[:N], np.asarray(jcnt)[:N])
        np.testing.assert_allclose(float(tavg), float(javg), rtol=1e-6)
    assert float(tavg) == 0.0            # no node is older than 99
    assert tcnt.dtype == torch.int32


def test_adamic_adar_matches_jax(graphs):
    jg, tg, _, _ = graphs
    want = jan.adamic_adar_edges(jg)
    got = tan.adamic_adar_edges(tg)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (want > 0).any()
    np.testing.assert_allclose(tan.adamic_adar_edges(tg, chunk=1000), want,
                               rtol=1e-5, atol=1e-7)
