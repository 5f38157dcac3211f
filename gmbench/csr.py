"""The port's ``Graph`` built on the device from an edge list.

The fields and their padding are those of
``green_marl_tpu_torch.graph.csr.from_edges``, which builds on the host:
CSR slots sorted by (source, destination), CSC slots by (destination,
source), ties (duplicate edges) in input order; ``e_rev2idx`` maps each
CSC slot to its edge's CSR slot; edge arrays padded to a multiple of 128
with the sentinel node id N (``e_rev2idx`` with 0).  Here two stable
sorts of int64 keys on the device do in a second or two what the host
build does in tens of seconds at LiveJournal scale.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from green_marl_tpu_torch.graph.csr import Graph, round_up

INT32_MAX = 2**31 - 1


def _order(major: torch.Tensor, minor: torch.Tensor, n: int) -> torch.Tensor:
    """Stable argsort of the pairs (major, minor), int64."""
    key = major.to(torch.int64).mul_(n).add_(minor)
    return torch.sort(key, stable=True).indices


def _padded(a: torch.Tensor, e_pad: int, fill: int) -> torch.Tensor:
    out = torch.full((e_pad,), fill, dtype=torch.int32, device=a.device)
    out[:a.numel()] = a
    return out


def build(src: torch.Tensor, dst: torch.Tensor, n: int,
          edge_props: Sequence[torch.Tensor] = ()
          ) -> Tuple[Graph, List[torch.Tensor]]:
    """``(graph, props)``: the graph of the int32 edge list ``src -> dst``
    over ``n`` nodes on the edges' device, and each of ``edge_props``
    (one int32 value per input edge) in CSR slot order, padded with 0."""
    E = int(src.numel())
    e_pad = round_up(max(E, 1))
    if e_pad > INT32_MAX or n >= INT32_MAX:
        raise ValueError(f"{E} edges over {n} nodes: a Graph holds fewer "
                         f"than 2^31 edge slots and nodes")
    dev = src.device
    ids = torch.arange(n + 1, dtype=torch.int32, device=dev)

    perm = _order(src, dst, n)
    csr_src = src[perm]
    csr_dst = dst[perm]
    props = [_padded(p[perm], e_pad, 0) for p in edge_props]
    input_to_csr = torch.empty(E, dtype=torch.int32, device=dev)
    input_to_csr[perm] = torch.arange(E, dtype=torch.int32, device=dev)
    del perm
    begin = torch.searchsorted(csr_src, ids, out_int32=True)

    perm = _order(dst, src, n)
    csc_src = src[perm]
    csc_dst = dst[perm]
    e_rev2idx = input_to_csr[perm]
    del perm, input_to_csr
    r_begin = torch.searchsorted(csc_dst, ids, out_int32=True)

    graph = Graph(begin=begin, node_idx=_padded(csr_dst, e_pad, n),
                  node_idx_src=_padded(csr_src, e_pad, n), r_begin=r_begin,
                  r_node_idx=_padded(csc_src, e_pad, n),
                  r_node_idx_dst=_padded(csc_dst, e_pad, n),
                  e_rev2idx=_padded(e_rev2idx, e_pad, 0),
                  num_nodes=n, num_edges=E)
    return graph, props
