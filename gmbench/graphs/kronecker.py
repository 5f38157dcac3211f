"""The Graph500 Kronecker generator (graph500.org specification, kernel 1's
input: ``kronecker_generator.m``), on the device.

For each of ``edgefactor * 2^scale`` edge tuples and each of ``scale``
levels: bit ``i`` is set with probability ``1 - (A + B)``, then bit ``j``
with probability ``B / (A + B)`` where ``i`` is clear and ``D / (C + D)``
where it is set.  One random permutation relabels the nodes.  Duplicates
and self-loops stay, as the generator makes them.  The graph is
undirected: each tuple is stored both ways, the second half of the edge
list mirroring the first, and both directions share the tuple's length.
The specification's final shuffle of the tuples is left out: the tuples
are independent draws, so their order carries nothing, and the CSR the
port is given does not depend on it.

The tuples and their lengths are drawn from the configuration's
``structure_seed``, the node labels from the run's seed: every seed gets
the same graph up to its labels, with its own ids and layout in memory.

Configuration keys: ``scale``, ``edgefactor``, ``A``, ``B``, ``C``,
``structure_seed``, ``lengths`` (``{"low", "high"}``, one length per tuple).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gmbench.draw import generator
from gmbench.edges import Edges, uniform_lengths

CHUNK = 1 << 25        # tuples drawn at a time (memory bound)


def draw(config: Dict[str, Any], seed: int, device) -> Edges:
    scale = int(config["scale"])
    n = 1 << scale
    m = int(config["edgefactor"]) * n
    A, B, C = float(config["A"]), float(config["B"]), float(config["C"])
    ab = A + B
    a_norm, c_norm = A / ab, C / (1.0 - ab)
    structure = int(config["structure_seed"])
    gen = generator(structure, "graph", device)
    src = torch.empty(2 * m, dtype=torch.int32, device=device)
    dst = torch.empty(2 * m, dtype=torch.int32, device=device)
    for lo in range(0, m, CHUNK):
        count = min(CHUNK, m - lo)
        i = torch.zeros(count, dtype=torch.int32, device=device)
        j = torch.zeros(count, dtype=torch.int32, device=device)
        for level in range(scale):
            r = torch.rand((2, count), generator=gen, device=device)
            ii = r[0] > ab
            jj = r[1] > torch.where(ii, c_norm, a_norm)
            i += ii.to(torch.int32) << level
            j += jj.to(torch.int32) << level
        src[lo:lo + count] = i
        dst[lo:lo + count] = j
    perm = torch.randperm(n, generator=generator(seed, "labels", device),
                          device=device, dtype=torch.int32)
    src[:m] = perm.index_select(0, src[:m])
    dst[:m] = perm.index_select(0, dst[:m])
    src[m:] = dst[:m]
    dst[m:] = src[:m]
    w = uniform_lengths(m, int(config["lengths"]["low"]),
                        int(config["lengths"]["high"]),
                        generator(structure, "lengths", device), device)
    return Edges(src=src, dst=dst, lens=torch.cat([w, w]), num_nodes=n,
                 labels=perm)
