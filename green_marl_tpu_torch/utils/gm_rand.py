"""Bit-exact replica of the reference host RNG (``gm_rand.h``/``.cc``).

Counterpart of ``green_marl_tpu/utils/gm_rand.py``.  ``gm_rand32`` is an
xorshift-style int32 recurrence with the reference's quirks kept: the
middle step is an arithmetic right-shift assignment (``next = next >> 17``,
not xor), and C ``%`` truncates toward zero.  The app mains derive edge
weights from it (``sssp_main.cc:21-34``), which is what makes value-level
output parity possible on generated inputs.
"""

from __future__ import annotations

import numpy as np

from ..graph import native


class GmRand32:
    DEFAULT_SEED = 2463534242

    def __init__(self, seed: int | None = None):
        s = self.DEFAULT_SEED if seed is None else seed
        self.next = np.uint32(s).astype(np.int32)

    def rand(self) -> int:
        with np.errstate(over="ignore"):
            n = self.next
            n = np.int32(n ^ np.int32(np.uint32(n) << np.uint32(13)))
            n = np.int32(n >> 17)          # arithmetic shift (reference)
            n = np.int32(n ^ np.int32(np.uint32(n) << np.uint32(5)))
            self.next = n
        return int(n)

    def sequence(self, count: int) -> np.ndarray:
        """[count] draws (a host loop; for fixture-sized inputs)."""
        out = np.empty(count, np.int64)
        for i in range(count):
            out[i] = self.rand()
        return out


def c_mod(a: np.ndarray, m: int) -> np.ndarray:
    """C's truncating ``%`` (numpy's ``%`` floors)."""
    return np.sign(a) * (np.abs(a) % m)


def sssp_edge_lengths(num_edges: int) -> np.ndarray:
    """``len[i] = (rand() % 100) + 1`` over edges in CSR order
    (sssp_main.cc:31-33).  Above a million edges the native loop of
    ``native/gm_io.cc`` runs it, when that library builds."""
    if num_edges > 1_000_000 and native.available():
        return native.xorshift_lengths(num_edges, 100, 1)
    r = GmRand32().sequence(num_edges)
    return (c_mod(r, 100) + 1).astype(np.int32)


def conduct_membership(num_nodes: int) -> np.ndarray:
    """The 10/20/30/40% membership split of conduct_main.cc:27-38, from
    ``rand() % 100`` per node.  Above a million nodes the native loop draws
    it, when that library builds."""
    if num_nodes > 1_000_000 and native.available():
        r = native.xorshift_lengths(num_nodes, 100, 0)
    else:
        r = c_mod(GmRand32().sequence(num_nodes), 100)
    m = np.full(num_nodes, 3, np.int32)
    m[r < 60] = 2
    m[r < 30] = 1
    m[r < 10] = 0
    return m
