"""Synthetic graph generators: uniform random and RMAT.

Semantics follow the reference ``graph_gen`` tool
(``apps/output_cpp/gm_graph/src/graph_gen.cc:12-265``): same parameters
(N, M, seed; RMAT a/b/c with 10% per-level perturbation and optional vertex
permutation), same structural properties (multi-edges allowed, RMAT rejects
self-loops).  The RNG is numpy PCG64 instead of C ``rand``/``drand48`` — the
reference's regression suite only asserts structure/rc, not exact edges
(``test/regression/test.py:142``), so fixed-seed reproducibility *within*
this framework is what matters, and these are vectorized O(M) passes rather
than scalar loops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def uniform_random_edges(n: int, m: int, seed: int = 0,
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform multigraph: M independent (src, dst) pairs
    (``graph_gen.cc:12-55``)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    return src, dst


def uniform_random_nonmulti_edges(n: int, m: int, seed: int = 0,
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform graph with duplicate edges rejected and resampled
    (``create_uniform_random_nonmulti_graph``, ``graph_gen.cc:134-152``)."""
    rng = np.random.default_rng(seed)
    seen: set = set()
    src = np.empty(m, np.int64)
    dst = np.empty(m, np.int64)
    count = 0
    while count < m:
        need = m - count
        s = rng.integers(0, n, size=2 * need + 16, dtype=np.int64)
        d = rng.integers(0, n, size=2 * need + 16, dtype=np.int64)
        for u, v in zip(s, d):
            if (u, v) not in seen:
                seen.add((u, v))
                src[count] = u
                dst[count] = v
                count += 1
                if count == m:
                    break
    return src, dst


def rmat_edges(n: int, m: int, seed: int = 0, a: float = 0.45,
               b: float = 0.22, c: float = 0.22, permute: bool = True,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """RMAT generator (``create_RMAT_graph``, ``graph_gen.cc:154-265``).

    Per edge: descend ``SCALE = log2(N)`` levels of the 2x2 partition tree;
    quadrant probabilities (a, b, c, d) are re-perturbed by up to 10% and
    renormalized at every level, as in the reference.  Self-loops are
    rejected and resampled; an optional random vertex permutation hides
    degree/id correlation.  Fully vectorized over edges.
    """
    assert a + b + c < 1.0
    rng = np.random.default_rng(seed)
    scale = int(np.log2(n))

    src = np.empty(0, np.int64)
    dst = np.empty(0, np.int64)
    while src.shape[0] < m:
        need = m - src.shape[0]
        batch = need + need // 8 + 16
        u = np.zeros(batch, np.int64)
        v = np.zeros(batch, np.int64)
        av = np.full(batch, a)
        bv = np.full(batch, b)
        cv = np.full(batch, c)
        dv = np.full(batch, 1.0 - (a + b + c))
        step = n // 2
        for level in range(scale):
            if level > 0:
                # vary abcd by up to 10% per level (graph_gen.cc:203-214)
                av *= 0.95 + 0.1 * rng.random(batch)
                bv *= 0.95 + 0.1 * rng.random(batch)
                cv *= 0.95 + 0.1 * rng.random(batch)
                dv *= 0.95 + 0.1 * rng.random(batch)
                s = av + bv + cv + dv
                av /= s
                bv /= s
                cv /= s
                dv /= s
            p = rng.random(batch)
            right = (p >= av) & (p < av + bv)          # v += step
            down = (p >= av + bv) & (p < av + bv + cv)  # u += step
            both = p >= av + bv + cv
            v += np.where(right | both, step, 0)
            u += np.where(down | both, step, 0)
            step //= 2
        keep = u != v  # reject self loops (graph_gen.cc:227-231)
        src = np.concatenate([src, u[keep][:need]])
        dst = np.concatenate([dst, v[keep][:need]])

    if permute:
        perm = rng.permutation(n)
        src = perm[src]
        dst = perm[dst]
    return src, dst
