"""Graphs past 2^24 nodes and 8-byte edge spaces, against the JAX package.

The port's counterpart of ``tests/test_scale_smoke.py`` (no pack24 test:
the port packs nothing).  Graphs built from int64 host edge arrays hold
int32 device arrays, as the JAX package's do without x64; the reduced
witness of ``green_marl_tpu_torch.probes.scale`` (the port of
``scripts/probe_vsharded_scale.py``) runs on the CPU with 4 shards and is
held against its host oracles and the JAX package's one-device hop_dist and
pagerank on the same edges.
"""

import os

import numpy as np
import pytest
import torch

from green_marl_tpu.graph.csr import from_edges as jax_from_edges
from green_marl_tpu.models.hop_dist import hop_dist as jax_hop_dist
from green_marl_tpu.models.pagerank import pagerank as jax_pagerank
from green_marl_tpu_torch.graph import generate as gen
from green_marl_tpu_torch.graph.csr import (ARRAY_FIELDS, GraphBuilder,
                                            from_edges)
from green_marl_tpu_torch.models.hop_dist import hop_dist
from green_marl_tpu_torch.models.pagerank import pagerank

EDGE_ARRAYS = ("begin", "r_begin", "e_rev2idx")


def test_int64_host_edge_space_small():
    """from_edges with an int64 edge space (``tests/test_scale_smoke.py:41``):
    the same degrees, edge count and arrays as the JAX package's, every
    array int32 on the device and the permutation int64 on the host."""
    src = np.asarray([0, 1, 2, 2], np.int64)
    dst = np.asarray([1, 2, 0, 1], np.int64)
    g, perm = from_edges(src, dst, 3, edge_dtype=np.int64)
    gj, permj = jax_from_edges(src, dst, 3, edge_dtype=np.int64)
    assert g.num_edges == gj.num_edges == 4
    deg = np.diff(g.begin.numpy())
    assert deg.sum() == 4
    np.testing.assert_array_equal(deg, np.diff(np.asarray(gj.begin)))
    assert g.edge_dtype == torch.int32 and perm.dtype == np.int64
    np.testing.assert_array_equal(perm, permj)
    for f in ARRAY_FIELDS:
        assert getattr(g, f).dtype == torch.int32, f
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)


def _builder_graph(src, dst, n):
    b = GraphBuilder(node_dtype=np.int64, edge_dtype=np.int64)
    b.add_nodes(n)
    half = len(src) // 2
    b.add_edges(src[:half], dst[:half])
    for s, d in zip(src[half:], dst[half:]):
        b.add_edge(int(s), int(d))
    return b.freeze()


@pytest.mark.parametrize("build", ["from_edges", "builder"])
def test_int64_graph_matches_jax(build):
    """An int64 edge space through from_edges or GraphBuilder: int32 device
    arrays, pagerank within rtol 1e-5 and hop_dist bit for bit of the JAX
    package's on the same edges."""
    src, dst = gen.rmat_edges(400, 3000, seed=21)
    src, dst = src.astype(np.int64), dst.astype(np.int64)
    if build == "from_edges":
        g, perm = from_edges(src, dst, 400, edge_dtype=np.int64)
    else:
        g, perm = _builder_graph(src, dst, 400)
    gj, _ = jax_from_edges(src, dst, 400, edge_dtype=np.int64)
    assert perm.dtype == np.int64
    for f in EDGE_ARRAYS:
        assert getattr(g, f).dtype == torch.int32, f
    want = jax_pagerank(gj)
    got = pagerank(g)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.rank.numpy(), np.asarray(want.rank),
                               rtol=1e-5, atol=0.0)
    for root in (0, 7):
        np.testing.assert_array_equal(hop_dist(g, root).dist.numpy(),
                                      np.asarray(jax_hop_dist(gj, root).dist))


def test_from_edges_refuses_2_31_slots():
    """2^31 edges (a zero-stride view: no memory behind it) pad past the
    int32 edge space: a ValueError that names the limit, before any pass
    over the edges."""
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.int32),
                                          shape=(2**31,), strides=(0,))
    for dt in (np.int32, np.int64):
        with pytest.raises(ValueError, match="2\\^31"):
            from_edges(big, big, 4, edge_dtype=dt)


def test_scale_witness_reduced():
    """``probes.scale`` at the JAX probe's ``VS_SCALE_SMOKE`` sizes (N=2^17,
    E=1.2M RMAT, seed 77, B=64) on the CPU with 4 shards: every check of
    the witness passes (BFS levels against scipy, the bit BFSs' reached
    sets, pagerank within 1e-3 of float64, sharded == one device, the
    segment reduce on the runs' slabs against its plain version), and the
    one-device hop_dist and pagerank equal the JAX package's on the same
    edges (levels bit for bit, ranks within rtol 1e-5)."""
    from green_marl_tpu_torch.graph import native
    from green_marl_tpu_torch.probes import scale

    n, e, b = scale.SMOKE["n"], scale.SMOKE["e"], scale.SMOKE["b"]
    g, times = scale.host_graph(n, e)
    dev = torch.device("cpu")
    roots = scale.probe_roots(g, b)
    orc = scale.oracles(g, roots)
    one = scale.one_device(g, roots, dev)
    sh = scale.sharded(g, roots, dev)
    slabs = scale.slab_checks({**one["slabs"], **sh["slabs"]}, dev)
    c = scale.checks(one, sh, orc, slabs)
    assert c["ok"], c
    assert set(slabs) == {"one device", "engine shard 0",
                          "schedule shard 0"}
    assert one["out"]["hop_levels"] == sh["out"]["hop_levels"]

    src, dst = native.rmat_edges(n, e, seed=scale.SEED)
    gj, _ = jax_from_edges(src, dst, n)
    dist = np.asarray(jax_hop_dist(gj, int(roots[0])).dist)[:n]
    np.testing.assert_array_equal(one["out"]["dist"], dist)
    np.testing.assert_array_equal(sh["out"]["dist"], dist)
    rank = np.asarray(jax_pagerank(gj, e=0.0, d=scale.PR_D,
                                   max_iter=scale.PR_ITERS).rank)[:n]
    np.testing.assert_allclose(one["out"]["rank"], rank, rtol=1e-5, atol=0)


@pytest.mark.skipif(os.environ.get("SCALE_SMOKE") != "1",
                    reason="opt-in: ~12 GB host RAM, minutes of CPU")
def test_scale_42m_nodes_smoke():
    """``tests/test_scale_smoke.py:54`` in the port: N=42M (past 2^24), E=120M
    uniform edges, the binned schedule over the pull direction and one
    binned PageRank superstep."""
    from green_marl_tpu_torch.models import batched
    from green_marl_tpu_torch.ops import binned

    n, e = 42_000_000, 120_000_000
    src, dst = gen.uniform_random_edges(n, e, seed=1)
    g, _ = from_edges(src.astype(np.int32), dst.astype(np.int32), n)
    assert g.num_nodes == n and g.num_edges == e
    out_deg = np.diff(g.begin.numpy()).astype(np.int64)
    assert out_deg.sum() == e
    del src, dst
    bp = binned.binned_in(g)
    assert bp.n_nodes >= n
    deg_rows = np.zeros(bp.n_rows, np.int32)
    deg_rows[:n] = out_deg[bp.perm.numpy()]
    r = batched.multi_pagerank_binned(
        bp, torch.from_numpy(deg_rows[:bp.n_nodes]), [0.85], e=0.0,
        max_iter=1)
    assert torch.isfinite(r.rank[:8, 0]).all()
