"""What the lockstep kinds (``gm_pagerank_lanes``, ``gm_hop_dist_lanes``)
share: the compiled program, the answer's layout and the call's passes.

A call runs one compiled Green-Marl program over ``lanes`` instances in
lockstep (``CompiledProc.batch``) and returns each lane's values at one
stratified sample of the nodes: ``o, o + lanes, o + 2 * lanes, ...``
below N, with ``o = root % lanes`` from the call's root, lane after lane.
So a checked answer holds at most ``n_pad`` values, as the harness's
answer buffers do, and every node is sampled by some root.
"""

from __future__ import annotations

import warnings

import torch

from gmbench import spec
from green_marl_tpu_torch.lang import lower
from green_marl_tpu_torch.ops import kernels


def compile_program(name: str):
    """``programs/<name>.gm`` compiled, its race warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", lower.RaceWarning)
        return lower.compile_source(spec.program_text(name))


def nodes(root: int, n: int, lanes: int, device=None) -> torch.Tensor:
    """The sampled node ids of the call whose root is ``root`` (int64)."""
    return torch.arange(root % lanes, n, lanes, device=device)


def answer(values: torch.Tensor, root: int, n: int) -> torch.Tensor:
    """``values`` ([lanes, n_pad], one row a lane) at the sampled nodes,
    flattened lane after lane."""
    lanes = values.shape[0]
    return values[:, root % lanes:n:lanes].reshape(-1)


def lanes_of(sample, n: int, lanes: int):
    """``(nodes, [lanes, len(nodes)] values)`` of a kept answer."""
    ids = nodes(sample.root, n, lanes)
    return ids, sample.answer[:lanes * ids.numel()].view(lanes, ids.numel())


def passes() -> int:
    """The traced ``While`` passes run so far (``lower.lane_pass_counts``);
    where the program has no such counter, the lane-batched launches of
    the segment reduce (one a pagerank.gm pass after its first)."""
    counts = getattr(lower, "lane_pass_counts", None)
    if counts is not None:
        return counts()["passes"]
    return kernels.lane_launch_counts()["segment_reduce_sorted[lanes]"]
