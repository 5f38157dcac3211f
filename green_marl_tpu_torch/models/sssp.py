"""SSSP by Bellman-Ford relaxation (``apps/src/sssp.gm:1-28``).

Counterpart of ``green_marl_tpu/models/sssp.py``.  ``sssp`` converges to
the shortest distances for non-negative int32 weights;
``dijkstra_host_exact`` replays ``sssp_dijkstra.gm``'s sequential pop-min
loop step for step on the host, over the pop-order-exact
``runtime.priority_map``, so that its Parent/ParentEdge trees carry the
reference binary's tie-breaks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph.csr import Graph
from .relax import RelaxResult, min_relax


def sssp(g: Graph, root: int, edge_len: torch.Tensor,
         max_iter: Optional[int] = None) -> RelaxResult:
    """``edge_len``: [E_pad] weights in CSR slot order (``e.len``)."""
    return min_relax(g, root, edge_len=edge_len, max_iter=max_iter)


def dijkstra_host_exact(g: Graph, edge_len, root: int, dest: int):
    """``apps/src/sssp_dijkstra.gm:1-54`` over the priority-map replica.

    The reference's compiled loop: ``GetMinKey`` -> compare with dest ->
    mark Reached -> ``RemoveMin`` -> relax the semi-sorted neighbour list
    in CSR slot order.  Host-sequential by nature, as the reference's loop
    is: it reads the graph's CSR and ``edge_len`` (tensors on any device,
    or arrays) back to numpy.

    Returns (found, parent[N], parent_edge[N], dist_at_dest) with NIL as
    -1; ``dist_at_dest`` is -1 when ``dest`` is unreachable.
    """
    from ..runtime.priority_map import MutatablePriorityMap

    begin = g.begin.cpu().numpy()
    node_idx = g.node_idx[: g.num_edges].cpu().numpy()
    lens = (edge_len.cpu().numpy() if isinstance(edge_len, torch.Tensor)
            else np.asarray(edge_len))[: g.num_edges]
    n = g.num_nodes
    parent = np.full(n, -1, np.int32)
    parent_edge = np.full(n, -1, np.int32)
    reached = np.zeros(n, bool)

    m: MutatablePriorityMap[int, int] = MutatablePriorityMap(0)
    m.set_value(int(root), 0)
    found = failed = False
    while not found and not failed:
        if m.size() == 0:
            failed = True
        else:
            nxt = m.peek_key()
            if nxt == dest:
                found = True
            else:
                reached[nxt] = True
                dist = m.get_value(nxt)
                m.remove_root()
                for slot in range(begin[nxt], begin[nxt + 1]):
                    v = int(node_idx[slot])
                    if reached[v]:
                        continue
                    relax = dist + int(lens[slot])
                    if not m.has_key(v) or m.get_value(v) > relax:
                        m.set_value(v, relax)
                        parent[v] = nxt
                        parent_edge[v] = slot
    dist_dest = m.get_value(int(dest)) if found else -1
    return (not failed), parent, parent_edge, dist_dest
