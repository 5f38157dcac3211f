"""The device CSR builder against the port's host builder."""

import numpy as np
import pytest
import torch

from gmbench import csr
from green_marl_tpu_torch.graph.csr import ARRAY_FIELDS, from_edges


def _edges(seed, n, e):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 3, e)       # the last 3 nodes have no out-edge
    dst = rng.integers(0, n, e)
    k = e // 8
    src[:k], dst[:k] = src[k:2 * k], dst[k:2 * k]        # duplicates
    dst[2 * k:3 * k] = src[2 * k:3 * k]                  # self-loops
    return src, dst


@pytest.mark.parametrize("seed,n,e", [(0, 50, 400), (1, 300, 256),
                                      (2, 1000, 3001), (3, 7, 1)])
def test_build_equals_from_edges(seed, n, e):
    src, dst = _edges(seed, n, e)
    lens = np.random.default_rng(seed + 9).integers(1, 100, e)
    want, perm = from_edges(src, dst, n)
    g, (w,) = csr.build(torch.from_numpy(src.astype(np.int32)),
                        torch.from_numpy(dst.astype(np.int32)), n,
                        [torch.from_numpy(lens.astype(np.int32))])
    assert (g.num_nodes, g.num_edges) == (want.num_nodes, want.num_edges)
    for f in ARRAY_FIELDS:
        got, exp = getattr(g, f), getattr(want, f)
        assert got.dtype == exp.dtype == torch.int32, f
        assert torch.equal(got, exp), f
    assert w.shape == (g.e_pad,)
    assert np.array_equal(w[:e].numpy(), lens[perm])
    assert not w[e:].any()


def test_build_refuses_past_int32():
    src = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        csr.build(src, src, 2**31 - 1)
