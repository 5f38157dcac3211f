"""RMAT as the reference's ``graph_gen`` draws it
(``create_RMAT_graph``, ``graph_gen.cc:154-265``), on the device.

Per edge, ``floor(log2(N))`` levels of the 2x2 partition: the quadrant
probabilities (a, b, c, d) are perturbed by up to ``perturb / 2`` of
themselves and renormalised at every level after the first; a self-loop
is rejected and drawn again when the configuration says so; then one
random permutation relabels the nodes.  The walk starts at ``N // 2`` and
halves, so a graph whose N is not a power of two spans ids up to about N.
The random numbers are torch's, not C ``rand``; the structure is the
reference's.

The walk and the lengths are drawn from the configuration's
``structure_seed``, the node labels from the run's seed: every seed gets
the same graph up to its labels (one deployment's graph), with its own
ids and layout in memory, so that seeds change the order of the work and
not its amount.

Configuration keys: ``nodes``, ``edges``, ``a``, ``b``, ``c``,
``perturb``, ``self_loops`` (kept or rejected), ``structure_seed``,
``lengths`` (``{"low", "high"}``, one length per directed edge).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gmbench.draw import generator
from gmbench.edges import Edges, uniform_lengths

CHUNK = 1 << 25        # candidate edges drawn at a time (memory bound)


def _quadrants(count: int, n: int, a: float, b: float, c: float,
               perturb: float, gen: torch.Generator, device):
    u = torch.zeros(count, dtype=torch.int32, device=device)
    v = torch.zeros(count, dtype=torch.int32, device=device)
    p = torch.tensor([a, b, c, 1.0 - (a + b + c)], device=device)
    p = p[:, None].expand(4, count).contiguous()
    step = n // 2
    for level in range(n.bit_length() - 1):
        if level and perturb:
            p.mul_(torch.rand((4, count), generator=gen, device=device)
                   .mul_(perturb).add_(1.0 - perturb / 2))
            p.div_(p.sum(0, keepdim=True))
        r = torch.rand(count, generator=gen, device=device)
        edge = p[0].clone()
        q = (r >= edge).to(torch.int32)
        q += r >= edge.add_(p[1])
        q += r >= edge.add_(p[2])
        # q: 0 top-left, 1 right (v), 2 down (u), 3 both
        v += (q & 1) * step
        u += (q >> 1) * step
        step //= 2
    return u, v


def draw(config: Dict[str, Any], seed: int, device) -> Edges:
    n, m = int(config["nodes"]), int(config["edges"])
    a, b, c = float(config["a"]), float(config["b"]), float(config["c"])
    if not a + b + c < 1.0:
        raise ValueError("rmat needs a + b + c < 1")
    structure = int(config["structure_seed"])
    gen = generator(structure, "graph", device)
    us, vs, have = [], [], 0
    while have < m:
        need = m - have
        count = min(need + need // 8 + 16, CHUNK)
        u, v = _quadrants(count, n, a, b, c, float(config["perturb"]), gen,
                          device)
        if not config["self_loops"]:
            keep = u != v
            u, v = u[keep], v[keep]
        us.append(u[:need])
        vs.append(v[:need])
        have += us[-1].numel()
    perm = torch.randperm(n, generator=generator(seed, "labels", device),
                          device=device, dtype=torch.int32)
    src = perm.index_select(0, torch.cat(us))
    dst = perm.index_select(0, torch.cat(vs))
    lens = uniform_lengths(m, int(config["lengths"]["low"]),
                           int(config["lengths"]["high"]),
                           generator(structure, "lengths", device), device)
    return Edges(src=src, dst=dst, lens=lens, num_nodes=n, labels=perm)
