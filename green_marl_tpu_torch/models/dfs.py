"""Sequential DFS with pre/post visit hooks.

A copy of ``green_marl_tpu/models/dfs.py`` (numpy only), which the port
cannot import.

The reference DFS template is explicitly sequential
(``apps/output_cpp/gm_graph/inc/gm_dfs_template.h``, 187 LoC, no OpenMP),
so this is a host-side (numpy) implementation by design — DFS order is
inherently serial, and the reference's ``InDFS``/``InPost`` bodies (e.g.
``apps/src/b2.gm``) mutate scalars/properties in visit order.

Neighbors are visited in semi-sorted (ascending destination) order, which
matches the frozen reference graph's iteration order.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def dfs(begin: np.ndarray, node_idx: np.ndarray, root: int,
        pre: Optional[Callable[[int], None]] = None,
        post: Optional[Callable[[int], None]] = None,
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Iterative DFS from ``root``; calls ``pre(v)`` on first visit and
    ``post(v)`` when v's subtree completes.  Returns (pre_order_index,
    post_order_index) arrays (-1 = unreached)."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    pre_ix = np.full(N, -1, np.int64)
    post_ix = np.full(N, -1, np.int64)
    pre_ctr = 0
    post_ctr = 0
    stack = [(int(root), 0)]
    while stack:
        v, k = stack[-1]
        if k == 0:
            if pre_ix[v] != -1:  # already visited via another path
                stack.pop()
                continue
            pre_ix[v] = pre_ctr
            pre_ctr += 1
            if pre:
                pre(v)
        row = node_idx[begin[v]:begin[v + 1]]
        advanced = False
        for i in range(k, len(row)):
            w = int(row[i])
            if pre_ix[w] == -1:
                stack[-1] = (v, i + 1)
                stack.append((w, 0))
                advanced = True
                break
        if advanced:
            continue
        post_ix[v] = post_ctr
        post_ctr += 1
        if post:
            post(v)
        stack.pop()
    return pre_ix, post_ix


def b2(begin: np.ndarray, node_idx: np.ndarray, a: np.ndarray,
       b: np.ndarray, root: int) -> Tuple[np.ndarray, np.ndarray]:
    """``apps/src/b2.gm``: InDFS  t.A = t.B + 1;  InPost  t.B = t.A + 1."""
    a = np.array(a, copy=True)
    b = np.array(b, copy=True)

    def pre(v):
        a[v] = b[v] + 1

    def post(v):
        b[v] = a[v] + 1

    dfs(begin, node_idx, root, pre, post)
    return a, b
