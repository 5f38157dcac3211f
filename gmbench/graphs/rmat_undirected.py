"""``rmat.py``'s draw made undirected, on the device.

The edges are exactly what ``rmat.draw`` draws with the configuration's
keys (so a configuration whose keys equal ``lj.json``'s holds lj's graph
under the same labels); then each edge is added in reverse, self-loops are
dropped and duplicate pairs are dropped by sorted int64 keys
``src * N + dst``: the simple undirected graph, each edge stored both
ways, in (source, destination) order.  One length a stored edge is drawn
from the structure's seed only because the CSR build carries an edge
property; triangle counting reads none of them.

Configuration keys: those of ``rmat.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gmbench.draw import generator
from gmbench.edges import Edges, uniform_lengths
from gmbench.graphs import rmat


def draw(config: Dict[str, Any], seed: int, device) -> Edges:
    directed = rmat.draw(config, seed, device)
    n = directed.num_nodes
    src = torch.cat([directed.src, directed.dst])
    dst = torch.cat([directed.dst, directed.src])
    labels = directed.labels
    del directed
    keep = src != dst
    keys = torch.unique(src[keep].to(torch.int64) * n + dst[keep])
    del src, dst, keep
    src, dst = (keys // n).to(torch.int32), (keys % n).to(torch.int32)
    lens = uniform_lengths(
        keys.numel(), int(config["lengths"]["low"]),
        int(config["lengths"]["high"]),
        generator(int(config["structure_seed"]), "lengths", device), device)
    return Edges(src=src, dst=dst, lens=lens, num_nodes=n, labels=labels)
