"""The port's triangle counting against green_marl_tpu's and the oracle.

The same numpy edge lists (made from a seed) go through the JAX package's
``triangle_count`` / ``triangle_count_literal`` and the port's, on the CPU.
Counts are integers and must match bit for bit: through the port's router,
its general (search) path, its sort-merge join forced on small graphs by
lowering the module's thresholds, and the literal form on a directed graph
and a multigraph.  The host preprocessing (DAG, descending-pair layout) is
held against the JAX package's arrays, natively and through numpy.
"""

import numpy as np
import pytest
import torch

from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.models import triangle as jtri
from green_marl_tpu_torch.graph import csr as tcsr
from green_marl_tpu_torch.graph import generate as tgen
from green_marl_tpu_torch.graph import native as tnative
from green_marl_tpu_torch.models import triangle as ttri


def both(src, dst, n):
    """The same edge list as a JAX graph, a torch graph and host CSR."""
    jg, _ = jfrom_edges(src, dst, n)
    tg = tcsr.graph_from_arrays({f: np.asarray(getattr(jg, f))
                                 for f in tcsr.ARRAY_FIELDS}, n, jg.num_edges)
    return jg, tg, np.asarray(jg.begin), np.asarray(jg.node_idx)[: jg.num_edges]


def undirected(kind, n, m, seed):
    gen = {"rmat": tgen.rmat_edges, "uniform": tgen.uniform_random_edges}[kind]
    src, dst = tcsr.to_undirected(*gen(n, m, seed=seed))
    keep = src != dst
    return src[keep], dst[keep]


def force_sortmerge(monkeypatch, width=1 << 13):
    monkeypatch.setattr(ttri, "_HASH_MIN_W", 1)
    monkeypatch.setattr(ttri, "_BITMAP_MAX_N", 1)
    monkeypatch.setattr(ttri, "_SM_DISPATCH_W", width)


def test_small_known():
    # one triangle 0-1-2 plus a pendant edge, undirected
    src, dst = tcsr.to_undirected(np.array([0, 1, 0, 2]),
                                  np.array([1, 2, 2, 3]))
    jg, tg, _, _ = both(src, dst, 4)
    assert ttri.triangle_count(tg) == jtri.triangle_count(jg) == 1
    assert ttri.count_search(ttri.build_dag(tg)) == 1
    assert ttri.count_sortmerge(ttri.build_dag(tg)) == 1
    assert ttri.triangle_count_literal(tg) == 1


def test_no_wedges():
    jg, tg, _, _ = both(np.array([0, 1]), np.array([1, 0]), 3)
    assert ttri.triangle_count(tg) == jtri.triangle_count(jg) == 0
    assert ttri.count_sortmerge(ttri.build_dag(tg)) == 0
    assert ttri.triangle_count_literal(tg) == 0


@pytest.mark.parametrize("kind,n,m,seed", [("uniform", 60, 400, 0),
                                           ("uniform", 60, 400, 1),
                                           ("rmat", 128, 2000, 2),
                                           ("rmat", 600, 6000, 3),
                                           ("rmat", 600, 6000, 4)])
def test_every_path_matches_jax_and_oracle(kind, n, m, seed, monkeypatch):
    src, dst = undirected(kind, n, m, seed)
    jg, tg, begin, node_idx = both(src, dst, n)
    want = ttri.triangle_count_np(begin, node_idx)
    assert want == jtri.triangle_count_np(begin, node_idx) > 0
    assert jtri.triangle_count(jg) == want
    assert ttri.triangle_count(tg) == want                    # bitmap route
    assert ttri.triangle_count_literal(tg) == want            # simple graph
    ctx = ttri.build_dag(tg)
    assert ttri.count_search(ctx) == want
    assert ttri.count_search(ctx, chunk=256) == want
    assert ttri.count_sortmerge(ctx, chunk=256) == want
    # the router itself: first the search (bitmap off), then the join
    monkeypatch.setattr(ttri, "_BITMAP_MAX_N", 1)
    assert ttri.triangle_count(tg, chunk=256) == want
    force_sortmerge(monkeypatch)
    ttri._PREP_CACHE.clear()
    assert ttri.triangle_count(tg, chunk=256) == want


@pytest.mark.parametrize("width", [1 << 9, 1 << 13, 1 << 27])
def test_sortmerge_dispatch_widths(width, monkeypatch):
    """Many small sorts, a few, or one: the same count."""
    src, dst = undirected("rmat", 600, 6000, 3)
    _, tg, begin, node_idx = both(src, dst, 600)
    force_sortmerge(monkeypatch, width)
    assert ttri.triangle_count(tg, chunk=128) == \
        ttri.triangle_count_np(begin, node_idx)


def test_sortmerge_matches_jax_sortmerge(monkeypatch):
    """The JAX package's own sort-merge route, forced as its tests do."""
    src, dst = undirected("rmat", 300, 2500, 5)
    jg, tg, _, _ = both(src, dst, 300)
    monkeypatch.setattr(jtri, "_HASH_MIN_W", 1)
    monkeypatch.setattr(jtri, "_BITMAP_MAX_N", 1)
    monkeypatch.setattr(jtri, "_SM_DISPATCH_W", 1 << 13)
    monkeypatch.setenv("GM_TRI_MODE", "sortmerge")
    force_sortmerge(monkeypatch)
    assert ttri.triangle_count(tg, chunk=256) == \
        jtri.triangle_count(jg, chunk=256)


def test_multigraph_dag_dedups():
    """Parallel edges (``dedup=False``) do not change the DAG count."""
    src, dst = tgen.rmat_edges(200, 1500, seed=6)
    keep = src != dst
    s1, d1 = tcsr.to_undirected(src[keep], dst[keep], dedup=True)
    s2, d2 = tcsr.to_undirected(src[keep], dst[keep], dedup=False)
    _, tg1, begin, node_idx = both(s1, d1, 200)
    jg2, tg2, _, _ = both(s2, d2, 200)
    assert tg2.num_edges > tg1.num_edges
    want = ttri.triangle_count_np(begin, node_idx)
    assert ttri.triangle_count(tg2) == jtri.triangle_count(jg2) == want
    assert ttri.count_search(ttri.build_dag(tg2)) == want
    assert ttri.count_sortmerge(ttri.build_dag(tg2), chunk=256) == want


@pytest.mark.parametrize("case", ["directed", "multigraph"])
def test_literal_matches_jax_and_oracle(case, monkeypatch):
    if case == "directed":
        src, dst = tgen.rmat_edges(150, 1800, seed=7)
    else:       # both directions and parallel edges: slots multiply wedges
        src, dst = tgen.uniform_random_edges(60, 300, seed=2)
        src, dst = tcsr.to_undirected(src, dst, dedup=False)
    jg, tg, begin, node_idx = both(src, dst, int(max(src.max(),
                                                     dst.max())) + 1)
    want = jtri.triangle_count_literal(jg)
    assert ttri.triangle_count_literal(tg) == want            # bitmap route
    monkeypatch.setattr(ttri, "_BITMAP_MAX_N", 1)             # search route
    ttri._PREP_CACHE.clear()
    assert ttri.triangle_count_literal(tg) == want
    assert ttri.triangle_count_literal(tg, chunk=100) == want
    if case == "directed":
        # the oracle reads rows as sets: it holds where no slot repeats
        _, simple = np.unique(np.stack([src, dst]), axis=1, return_index=True)
        _, tgs, b, ni = both(src[simple], dst[simple], tg.num_nodes)
        assert ttri.triangle_count_literal(tgs) == \
            ttri.triangle_count_np(b, ni)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("seed", [8, 9])
def test_host_preprocessing_matches_jax(use_native, seed, monkeypatch):
    src, dst = tcsr.to_undirected(*tgen.rmat_edges(400, 4000, seed=seed),
                                  dedup=False)
    _, _, begin, node_idx = both(src, dst, 400)
    want = jtri.build_dag_host(begin, node_idx, 400)
    if not use_native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert tnative.available()
    got = ttri.build_dag_host(begin, node_idx, 400)
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g_, w_)
    assert got[3] == want[3]
    dag_begin, dag_dst, _, D = got
    jl = jtri.descending_row_layout(dag_begin.astype(np.int32),
                                    dag_dst.astype(np.int32), D)
    tl = ttri.descending_row_layout(dag_begin.astype(np.int32),
                                    dag_dst.astype(np.int32), D)
    for g_, w_ in zip(tl, jl):
        np.testing.assert_array_equal(g_, w_)
    order = ttri.desc_order(dag_begin)
    np.testing.assert_array_equal(order, jtri.desc_order(dag_begin))
    # the order is the layout's: row i of the layout is rank order[i]'s row
    np.testing.assert_array_equal(np.diff(tl[2]),
                                  np.diff(dag_begin)[order])


def test_dag_context_and_device_helpers():
    src, dst = undirected("rmat", 300, 3000, 10)
    jg, tg, _, _ = both(src, dst, 300)
    jc, tc = jtri.build_dag(jg), ttri.build_dag(tg)
    assert (tc.num_wedges, tc.num_dag_edges) == (jc.num_wedges,
                                                 jc.num_dag_edges)
    np.testing.assert_array_equal(tc.dag_begin.numpy(),
                                  np.asarray(jc.dag_begin))
    np.testing.assert_array_equal(tc.dag_dst.numpy(), np.asarray(jc.dag_dst))
    np.testing.assert_array_equal(tc.pair_cum.numpy(),
                                  np.asarray(jc.pair_cum))
    assert tc.pair_cum.dtype == torch.int64
    jp, tp = jtri._permuted_ctx(jc), ttri._permuted_ctx(tc)
    np.testing.assert_array_equal(tp.dag_dst.numpy(), np.asarray(jp.dag_dst))
    d_len = int(tp.dag_dst.numel())
    np.testing.assert_array_equal(
        ttri._pairs_on_device(tp.dag_begin, d_len).numpy(),
        np.asarray(jtri._pairs_on_device(jp.dag_begin, d_len)))
    order = ttri.desc_order(tc.dag_begin.numpy())
    import jax.numpy as jnp
    ehi, elo = jtri._edge_keys_desc(jp.dag_dst, jp.dag_begin,
                                    jnp.asarray(order),
                                    jnp.asarray(tc.num_dag_edges, jnp.int32),
                                    d_len)
    D = tc.num_dag_edges
    keys = ttri._edge_keys_desc(tp.dag_dst, tp.dag_begin,
                                torch.from_numpy(order), D)
    np.testing.assert_array_equal(
        keys.numpy(), (np.asarray(ehi)[:D].astype(np.int64) << 32)
        | np.asarray(elo)[:D])
    np.testing.assert_array_equal(
        ttri._shift_pieces(tp.dag_begin.numpy(), 0, D, 64),
        jtri._shift_pieces(np.asarray(jp.dag_begin), 0, D, 64))


def test_bitword_table_matches_jax():
    src, dst = tgen.uniform_random_edges(70, 500, seed=11)
    jt, jw = jtri._bitword_table(src.astype(np.int64), dst.astype(np.int64),
                                 70)
    tt, tw = ttri._bitword_table(src.astype(np.int64), dst.astype(np.int64),
                                 70)
    assert tw == jw and tt.dtype == np.int32
    np.testing.assert_array_equal(tt.view(np.uint32), np.asarray(jt))
