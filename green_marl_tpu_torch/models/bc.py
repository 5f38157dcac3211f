"""Betweenness centrality (Brandes), estimated over a seed set.

Counterpart of ``green_marl_tpu/models/bc.py`` (``apps/src/bc.gm:1-31``
and its bc_adj / bc_random variants).  For each seed s one forward BFS
gives ``level[v]``; the reference's ``v.UpNbrs`` are the in-neighbours one
level up and ``v.DownNbrs`` the out-neighbours one level down, so

* forward, level by level: ``sigma[v] = sum of sigma over UpNbrs`` (a pull
  sum over in-edges);
* backward, level by level: ``delta[v] = sigma[v] * sum over DownNbrs w of
  (1 + delta[w]) / sigma[w]`` (a push sum over out-edges).

Both are float32 sums through ``ops.segment`` (the segment-reduce kernel on
the card), in host loops over the ``levels_run + 1`` levels the BFS
reports.  Seeds run one after another, as the reference iterates its
``Node_Sequence``.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops import segment as ops
from .bfs import bfs


class BCResult(NamedTuple):
    bc: torch.Tensor  # [N_pad] float32


def _one_seed(g: Graph, seed: int, bc_acc: torch.Tensor,
              max_iter: int) -> torch.Tensor:
    res = bfs(g, seed, max_iter=max_iter)
    level = res.level                        # -1 unreached
    n_levels = res.levels_run + 1
    ids = torch.arange(g.n_pad, device=g.device)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)

    sigma = (ids == seed).to(torch.float32)
    for l in range(1, n_levels):
        contrib = torch.where(level == l - 1, sigma, zero)
        sigma = torch.where(level == l, ops.in_nbr_sum(g, contrib), sigma)

    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    delta = torch.zeros(g.n_pad, dtype=torch.float32, device=g.device)
    for l in range(n_levels - 2, -1, -1):    # levels L-2 .. 0
        term = torch.where(level == l + 1, (1.0 + delta) / safe_sigma, zero)
        delta = torch.where(level == l, sigma * ops.out_nbr_sum(g, term),
                            delta)
    return bc_acc + torch.where(g.node_mask(), delta, zero)


def bc(g: Graph, seeds: Sequence[int],
       max_iter: Optional[int] = None) -> BCResult:
    """``seeds``: node ids (the reference's ``Seeds`` sequence)."""
    if max_iter is None:
        max_iter = g.num_nodes + 1
    acc = torch.zeros(g.n_pad, dtype=torch.float32, device=g.device)
    for s in seeds:
        acc = _one_seed(g, int(s), acc, max_iter)
    return BCResult(bc=acc)


def bc_np(begin, node_idx, seeds):
    """Host Brandes oracle (literal bc.gm semantics), float64."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    deg = np.diff(begin)
    src = np.repeat(np.arange(N), deg)
    dst = node_idx[: src.shape[0]]
    BC = np.zeros(N)
    for s in seeds:
        level = np.full(N, -1)
        level[s] = 0
        q = collections.deque([s])
        while q:
            u = q.popleft()
            for v in node_idx[begin[u]:begin[u + 1]]:
                if level[v] < 0:
                    level[v] = level[u] + 1
                    q.append(v)
        # forward sigma / backward delta by level over the BFS DAG
        maxl = level.max()
        sigma = np.zeros(N)
        sigma[s] = 1.0
        for l in range(1, maxl + 1):
            m = (level[src] == l - 1) & (level[dst] == l)
            np.add.at(sigma, dst[m], sigma[src[m]])
        delta = np.zeros(N)
        for l in range(maxl - 1, -1, -1):
            m = (level[src] == l) & (level[dst] == l + 1)
            contrib = np.zeros(N)
            np.add.at(contrib, src[m],
                      (1.0 + delta[dst[m]]) /
                      np.where(sigma[dst[m]] > 0, sigma[dst[m]], 1.0))
            delta = np.where(level == l, sigma * contrib, delta)
        BC += np.where(level >= 0, delta, 0.0)
    return BC
