"""Random sampling, random walks and a random bipartite matching.

Counterpart of ``green_marl_tpu/models/sampling.py``, drawing the JAX
package's own bits (``runtime.rng``), so every sampled set equals the JAX
version's:

* ``random_node_sampling`` (``random_node_sampling.gm``)
* ``random_degree_node_sampling`` (``random_degree_node_sampling.gm``)
* ``random_walk_with_jump`` (``random_walk_sampling_with_random_jump.gm``)
* ``parallel_random_walks`` (W walkers in lockstep)
* ``random_bipartite_matching`` (``random_bipartite_matching.gm``)

The walks' key chain does not depend on the graph, so every key and draw
is made up front, one vectorised Threefry call per kind of draw.  With the
draws known, a step that jumps lands on its drawn node whatever the walker's
current node: such steps cut the walk into runs that are walked side by
side (``_walk``), one sweep per step of the longest run, with no host sync
inside.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..engine.superstep import while_loop
from ..graph.csr import Graph
from ..ops import segment as ops
from ..runtime import rng

INT32_MAX = torch.iinfo(torch.int32).max


def random_node_sampling(g: Graph, key: torch.Tensor, n: int) -> torch.Tensor:
    """``S.Add(v)`` with probability ``1/n`` each: [N_pad] bool."""
    prob = 1.0 / torch.tensor(n, dtype=torch.float32, device=g.device)
    dice = rng.uniform(key.to(g.device), (g.n_pad,))
    return (dice < prob) & g.node_mask()


def random_degree_node_sampling(g: Graph, key: torch.Tensor,
                                n: int) -> torch.Tensor:
    """Each node with probability ``n * deg / sum(deg)`` (float32, summed
    in float32 as in the JAX version: exact while E < 2^24)."""
    mask = g.node_mask()
    deg = g.out_degree().to(torch.float32)
    deg_sum = torch.where(mask, deg, 0.0).sum()
    prob = deg / deg_sum.clamp(min=1.0) * torch.tensor(
        n, dtype=torch.float32, device=g.device)
    dice = rng.uniform(key.to(g.device), (g.n_pad,))
    return (dice < prob) & mask


class WalkDraws(NamedTuple):
    """Per step and walker: the jump draw (``Uniform() < c``), the node a
    jump lands on and the draw that picks a neighbour."""
    jump: torch.Tensor   # [S, W] bool
    node: torch.Tensor   # [S, W] int32
    nbr_u: torch.Tensor  # [S, W] float32


def walk_draws(g: Graph, keys: torch.Tensor, walkers: Optional[int],
               c: float) -> WalkDraws:
    """The draws of the steps whose carried keys are ``keys`` [S, 2]: each
    step splits ``key, k1, k2, k3`` and draws its jump from ``k1``, its node
    from ``k2`` and its neighbour from ``k3``, of shape ``(walkers,)``
    (``()`` for one walker: then W = 1), on the graph's device."""
    sub = rng.split(keys.to(g.device), 4)
    shape = () if walkers is None else (walkers,)
    c32 = torch.tensor(c, dtype=torch.float32, device=g.device)
    jump = rng.uniform(sub[:, 1], shape) < c32
    node = rng.randint(sub[:, 2], shape, 0, g.num_nodes)
    nbr_u = rng.uniform(sub[:, 3], shape)
    if walkers is None:
        jump, node, nbr_u = jump[:, None], node[:, None], nbr_u[:, None]
    return WalkDraws(jump, node, nbr_u)


def _walk(g: Graph, start: torch.Tensor, d: WalkDraws) -> torch.Tensor:
    """[S + 1, W] int32 positions of walkers that start at ``start`` [W] and
    take step i as ``where(jump | deg == 0, node, nbr)``.

    A step whose jump draw is set lands on its drawn node whatever the
    current node, so its successor is known up front; every sweep then
    advances all positions whose predecessor is known.  The sweeps needed
    are the longest run of steps without a drawn jump."""
    S, W = d.jump.shape
    dev = g.device
    steps = torch.arange(S, device=dev)[:, None]
    last_jump = torch.cummax(torch.where(d.jump, steps, -1), dim=0).values
    sweeps = int((steps - last_jump).max()) if S else 0
    traj = torch.empty((S + 1, W), dtype=torch.int32, device=dev)
    traj[0] = start
    traj[1:] = torch.where(d.jump, d.node, 0)
    known = torch.zeros((S + 1, W), dtype=torch.bool, device=dev)
    known[0] = True
    known[1:] = d.jump
    for _ in range(sweeps):
        cur = traj[:-1]
        nbr = rng.random_nbr(g, cur, d.nbr_u)
        dead = g.begin[cur.long() + 1] == g.begin[cur.long()]
        nxt = torch.where(d.jump | dead, d.node, nbr)
        new = known[:-1] & ~known[1:]
        traj[1:] = torch.where(new, nxt, traj[1:])
        known[1:] |= new
    return traj


def random_walk_with_jump(g: Graph, key: torch.Tensor, steps: int,
                          c: float = 0.15,
                          start: Optional[int] = None) -> torch.Tensor:
    """One walker, ``steps`` visits; it jumps to a uniform node with
    probability ``c`` or at a dead end.  Returns the visited set [N_pad]
    bool.  Keys as in JAX: ``k0, key = split(key)`` (``k0`` picks the start
    when none is given), then ``key, k1, k2, k3 = split(key, 4)`` a step."""
    key = key.to(g.device)
    k0, key = rng.split(key)
    if start is None:
        first = rng.pick_random_nodes(k0, g).reshape(1)
    else:
        first = torch.tensor([start], dtype=torch.int32, device=g.device)
    traj = _walk(g, first, walk_draws(g, rng.key_chain(key, steps), None, c))
    visited = torch.zeros(g.n_pad, dtype=torch.bool, device=g.device)
    visited[traj[:steps, 0].long()] = True
    return visited


def parallel_random_walks(g: Graph, key: torch.Tensor, starts: torch.Tensor,
                          steps: int, c: float = 0.15
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W walkers in lockstep: ``(visit counts [N_pad] int32, trajectory
    [steps, W] int32)``, the trajectory holding each step's position
    before it moves."""
    key = key.to(g.device)
    starts = starts.to(device=g.device, dtype=torch.int32)
    draws = walk_draws(g, rng.key_chain(key, steps), starts.shape[0], c)
    traj = _walk(g, starts, draws)[:steps]
    counts = torch.bincount(traj.reshape(-1).long(), minlength=g.n_pad)
    return counts.to(torch.int32), traj


class MatchingResult(NamedTuple):
    match: torch.Tensor  # [N_pad] int32 partner, -1 = unmatched
    count: int
    iterations: int


def random_bipartite_matching(g: Graph, is_left: torch.Tensor,
                              max_iter: Optional[int] = None
                              ) -> MatchingResult:
    """``random_bipartite_matching.gm``: propose/accept rounds until a
    round adds no pair.  The reference's write-write race ("only one will
    make effect") is a min-id reduction, as in the JAX version: each
    unmatched right node accepts its smallest proposing left in-neighbour
    (int32 min over its CSC run), and each left node the smallest right
    node that accepted it (int32 min over its CSR run)."""
    if max_iter is None:
        max_iter = g.num_nodes + 1
    dev = g.device
    n_pad, n = g.n_pad, g.num_nodes
    is_left = is_left.to(dev)
    mask = g.node_mask()
    big = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
    ids = torch.arange(n_pad, dtype=torch.int32, device=dev)

    def step(state):
        match, _, count = state
        free = (match == -1) & mask
        free_left, free_right = is_left & free, ~is_left & free
        # left n proposes to every unmatched right out-neighbour t; t takes
        # the smallest proposer (a pull over t's in-edges)
        prop = torch.where(free_left.index_select(0, g.r_node_idx),
                           g.r_node_idx, big)
        suitor = ops.sorted_segment_reduce(prop, g.r_node_idx_dst, g.r_begin,
                                           n_pad, "min")
        suitor = torch.where(free_right & (suitor < big), suitor, -1)
        # n takes the smallest t that chose it (over n's out-edges)
        tgt = g.node_idx
        reply = torch.where((suitor.index_select(0, tgt) == g.node_idx_src)
                            & (tgt < n), tgt, big)
        chosen = ops.sorted_segment_reduce(reply, g.node_idx_src, g.begin,
                                           n_pad, "min")
        has = free_left & (chosen < big)
        match = torch.where(has, chosen, match)
        # each right node has one suitor, so the targets are distinct; the
        # JAX version's writes of the other lanes go to the pad row n_pad-1
        # and change nothing
        match[chosen[has].long()] = ids[has]
        added = has.sum()
        return match, added > 0, count + added

    state0 = (torch.full((n_pad,), -1, dtype=torch.int32, device=dev),
              torch.ones((), dtype=torch.bool, device=dev),
              torch.zeros((), dtype=torch.int64, device=dev))
    (match, _, count), stats = while_loop(step, lambda s: s[1], state0,
                                          max_iter)
    return MatchingResult(match=torch.where(mask, match, -1),
                          count=int(count), iterations=stats.iterations)
