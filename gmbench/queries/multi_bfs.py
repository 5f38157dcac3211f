"""``models.batched.multi_source_bfs_bits``: one BFS from each of
``batch`` sources a call, ``plane_bits`` sources to a lane of bit planes,
with the schedule of ``models.batched.bits_schedule`` (what the
``multi_bfs`` app runs).  Arguments: ``batch``, ``plane_bits``,
``min_out_degree``.

The plan gives each call one root, the pivot; the call's sources are
``batch(eligible, pivot, size)``: ``eligible`` the nodes of at least
``min_out_degree`` out-edges in id order (a seeded shuffle, since ids
are the run's labels), M of them, p the pivot's position among them and
s = M // size, the sources are ``eligible[(p + k * s) mod M]`` for k = 0 ..
size - 1, a stratified uniform sample that starts at the pivot.  The
answer is ``cat([reached, traversed])``, 2 x ``batch`` int64.

Check, over the edge list drawn again: ``msbfs_mismatch``, the instances
among those with the fewest and the most reached nodes and 14 drawn from
a generator seeded by the pivot whose reached or traversed count differs
from the reference's (``reference/multi_bfs.py``); ``msbfs_implausible``,
the instances of every checked call that reach nothing or traverse fewer
edges than their source's out-degree.  Bits have no lower precision, so
the kind has no control."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gmbench.draw import generator
from gmbench.reference import multi_bfs as ref
from green_marl_tpu_torch.models import batched

NUMBERS = ("msbfs_mismatch", "msbfs_implausible")
DRAWN = 14          # instances a checked call compares besides its extremes


def eligible(out_degree: torch.Tensor, min_out_degree: int) -> np.ndarray:
    """The ids of the nodes with at least ``min_out_degree`` out-edges,
    ascending, from their [N] out-degrees."""
    ok = out_degree >= int(min_out_degree)
    return torch.nonzero(ok).flatten().cpu().numpy().astype(np.int64)


def batch(nodes: np.ndarray, pivot: int, size: int) -> np.ndarray:
    """The ``size`` sources of the call whose root is ``pivot``, from the
    ascending eligible ids ``nodes``."""
    m = len(nodes)
    p = int(np.searchsorted(nodes, pivot))
    if p == m or nodes[p] != pivot:
        raise ValueError(f"root {pivot} has too few out-edges for a batch")
    if m < size:
        raise ValueError(f"{m} nodes are eligible as sources, {size} asked")
    return nodes[(p + np.arange(size, dtype=np.int64) * (m // size)) % m]


def sampled(reached: torch.Tensor, pivot: int) -> List[int]:
    """The instances a check compares with the reference."""
    g = generator(pivot, "msbfs_check", "cpu")
    picks = {int(reached.argmin()), int(reached.argmax())}
    picks.update(torch.randperm(reached.numel(), generator=g)[:DRAWN]
                 .tolist())
    return sorted(picks)


def prepare(graph, lengths, args):
    size, pb = int(args["batch"]), int(args["plane_bits"])
    return dict(schedule=batched.bits_schedule(graph, size, pb), size=size,
                plane_bits=pb,
                eligible=eligible(graph.out_degree()[:graph.num_nodes],
                                  args["min_out_degree"]))


def call(state, root):
    bp, deg_rows, chunk = state["schedule"]
    res = batched.multi_source_bfs_bits(
        bp, batch(state["eligible"], root, state["size"]), deg_rows,
        plane_bits=state["plane_bits"], slot_chunk=chunk)
    return (torch.cat([res.reached, res.traversed]),
            {"steps": int(res.levels_run)})


def check(samples, edges, args):
    size, n = int(args["batch"]), edges.num_nodes
    out_deg = torch.bincount(edges.src.to(torch.int64), minlength=n)
    nodes = eligible(out_deg, args["min_out_degree"])
    out_deg = out_deg.cpu()
    mismatch = implausible = 0
    for s in samples:
        sources = torch.from_numpy(batch(nodes, s.root, size))
        answer = s.answer[:2 * size].to(torch.int64)
        reached, traversed = answer[:size], answer[size:]
        implausible += int(((reached < 1)
                            | (traversed < out_deg[sources])).sum())
        picks = sampled(reached, s.root)
        want_r, want_t = ref.counts(edges.src, edges.dst, n,
                                    sources[picks].tolist())
        mismatch += int(((reached[picks] != want_r.cpu())
                         | (traversed[picks] != want_t.cpu())).sum())
    return {"msbfs_mismatch": mismatch, "msbfs_implausible": implausible}
