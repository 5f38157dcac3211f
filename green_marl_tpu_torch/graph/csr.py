"""Frozen CSR+CSC graph of tensors.

Counterpart of ``green_marl_tpu/graph/csr.py``, with the same fields and
padding so that every array compares element by element:

* every O(E) array is padded to ``e_pad``, a multiple of 128; padded slots
  hold the sentinel node id ``N``;
* node properties have ``n_pad = round_up(N + 1, 128)`` rows, so the
  sentinel is a valid index into a junk row and gathers need no mask.

The graph is built on the host (the native builder of ``native/gm_io.cc``,
or numpy) and moved to a device with :meth:`Graph.to`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import native

LANE = 128  # padded axes are multiples of this

ARRAY_FIELDS = ("begin", "node_idx", "node_idx_src", "r_begin",
                "r_node_idx", "r_node_idx_dst", "e_rev2idx")


def round_up(x: int, m: int = LANE) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """Frozen CSR+CSC graph; all tensors on one device."""

    # CSR (push direction): out-edges of node u live in
    # node_idx[begin[u] : begin[u+1]], sorted by destination.
    begin: torch.Tensor         # [N+1] edge_t
    node_idx: torch.Tensor      # [E_pad] node_t, dst per CSR slot (pad = N)
    node_idx_src: torch.Tensor  # [E_pad] node_t, src per CSR slot (pad = N)

    # CSC (pull direction): in-edges of node v live in
    # r_node_idx[r_begin[v] : r_begin[v+1]] (the source endpoints).
    r_begin: torch.Tensor         # [N+1] edge_t
    r_node_idx: torch.Tensor      # [E_pad] node_t, src per CSC slot (pad = N)
    r_node_idx_dst: torch.Tensor  # [E_pad] node_t, dst per CSC slot (pad = N)
    e_rev2idx: torch.Tensor       # [E_pad] edge_t, CSR slot of each CSC slot

    num_nodes: int
    num_edges: int

    @property
    def n_pad(self) -> int:
        """Padded property length: sentinel id ``num_nodes`` is in range."""
        return round_up(self.num_nodes + 1)

    @property
    def e_pad(self) -> int:
        return int(self.node_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.node_idx.device

    @property
    def sentinel(self) -> int:
        """Node id of padded slots (a junk row in property tensors)."""
        return self.num_nodes

    @property
    def node_dtype(self) -> torch.dtype:
        return self.node_idx.dtype

    @property
    def edge_dtype(self) -> torch.dtype:
        return self.begin.dtype

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS})

    def node_mask(self) -> torch.Tensor:
        """[N_pad] bool, True for real nodes."""
        return torch.arange(self.n_pad, device=self.device) < self.num_nodes

    def edge_mask(self) -> torch.Tensor:
        """[E_pad] bool, True for real edges (CSR and CSC share E)."""
        return torch.arange(self.e_pad, device=self.device) < self.num_edges

    def out_degree(self) -> torch.Tensor:
        """[N_pad] edge_t; reference ``OutDegree()``."""
        return _pad_to(self.begin.diff(), self.n_pad)

    def in_degree(self) -> torch.Tensor:
        """[N_pad] edge_t; reference ``InDegree()``."""
        return _pad_to(self.r_begin.diff(), self.n_pad)

    def node_prop(self, fill, dtype) -> torch.Tensor:
        """A node property tensor on the graph's device (``Node_Prop<T>``)."""
        return torch.full((self.n_pad,), fill, dtype=dtype,
                          device=self.device)

    def edge_prop(self, fill, dtype) -> torch.Tensor:
        """An edge property tensor in CSR slot order."""
        return torch.full((self.e_pad,), fill, dtype=dtype,
                          device=self.device)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n - x.shape[0]))


def graph_from_arrays(arrays: Dict[str, np.ndarray], num_nodes: int,
                      num_edges: int, device="cpu") -> Graph:
    """A ``Graph`` from host arrays of its fields (for example
    ``np.asarray`` of each field of a ``green_marl_tpu`` graph)."""
    missing = set(ARRAY_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing graph arrays: {sorted(missing)}")
    tensors = {}
    for f in ARRAY_FIELDS:
        a = np.asarray(arrays[f])
        # torch shares a writable array's memory; copy read-only ones
        tensors[f] = torch.as_tensor(a if a.flags.writeable else a.copy(),
                                     device=device)
    return Graph(**tensors, num_nodes=int(num_nodes),
                 num_edges=int(num_edges))


def from_edges(src: np.ndarray, dst: np.ndarray,
               num_nodes: Optional[int] = None, node_dtype=np.int32,
               edge_dtype=np.int32) -> Tuple[Graph, np.ndarray]:
    """Build a frozen ``Graph`` on the CPU from an edge list.

    The reference's ``freeze()`` + ``do_semi_sort()`` +
    ``make_reverse_edges()`` + ``prepare_edge_source()`` in one pass.
    Returns ``(graph, csr_perm)``; ``csr_perm[i]`` is the input index of
    the edge in CSR slot ``i`` (to permute edge properties given in input
    order).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src/dst must be equal-length 1-D arrays")
    E = int(src.shape[0])
    if num_nodes is None:
        num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    N = int(num_nodes)
    src = src.astype(node_dtype, copy=False)
    dst = dst.astype(node_dtype, copy=False)
    if E and (src.min() < 0 or dst.min() < 0 or src.max() >= N
              or dst.max() >= N):
        raise ValueError("edge endpoint out of range")
    e_pad = round_up(max(E, 1))

    if (E and np.dtype(node_dtype) == np.int32
            and np.dtype(edge_dtype) == np.int32 and native.available()):
        (begin, csr_dst, csr_src, csr_perm, r_begin, csc_src, csc_dst,
         e_rev2idx) = native.build_csr(src, dst, N)
    else:
        # CSR: sort by (src, dst), which semi-sorts every row.
        csr_perm = np.lexsort((dst, src)).astype(edge_dtype)
        csr_src = src[csr_perm]
        csr_dst = dst[csr_perm]
        begin = np.zeros(N + 1, dtype=edge_dtype)
        np.cumsum(np.bincount(src, minlength=N), out=begin[1:],
                  dtype=edge_dtype)
        # CSC: sort by (dst, src); e_rev2idx maps CSC slot -> CSR slot.
        csc_of_input = np.lexsort((src, dst)).astype(edge_dtype)
        csc_src = src[csc_of_input]
        csc_dst = dst[csc_of_input]
        r_begin = np.zeros(N + 1, dtype=edge_dtype)
        np.cumsum(np.bincount(dst, minlength=N), out=r_begin[1:],
                  dtype=edge_dtype)
        input_to_csr = np.empty(E, dtype=edge_dtype)
        input_to_csr[csr_perm] = np.arange(E, dtype=edge_dtype)
        e_rev2idx = input_to_csr[csc_of_input]

    sent = np.dtype(node_dtype).type(N)

    def padded(a, fill):
        out = np.full(e_pad, fill, dtype=a.dtype)
        out[:E] = a
        return out

    g = graph_from_arrays(dict(
        begin=begin,
        node_idx=padded(csr_dst, sent),
        node_idx_src=padded(csr_src, sent),
        r_begin=r_begin,
        r_node_idx=padded(csc_src, sent),
        r_node_idx_dst=padded(csc_dst, sent),
        e_rev2idx=padded(e_rev2idx, np.dtype(edge_dtype).type(0)),
    ), N, E)
    return g, csr_perm


class GraphBuilder:
    """Mutable host-side graph: the reference's "flexible format"
    (``gm_graph.h:186-203``: ``add_node``/``add_edge``, then ``freeze()``
    into CSR; ``thaw()`` back for more mutation) and its node-key map
    (``gm_graph.h:396-436``: ``add_nodekey``/``find_nodekey``/
    ``find_nodeid`` between external keys and dense ids)."""

    def __init__(self, node_dtype=np.int32, edge_dtype=np.int32):
        self._src: list = []
        self._dst: list = []
        self._num_nodes = 0
        self.node_dtype = node_dtype
        self.edge_dtype = edge_dtype
        self._key2id: dict = {}
        self._id2key: list = []

    @classmethod
    def thaw(cls, g: Graph, node_dtype=np.int32,
             edge_dtype=np.int32) -> "GraphBuilder":
        """CSR -> flexible (``gm_graph::thaw``): a builder seeded with the
        graph's edges, from any device."""
        b = cls(node_dtype=node_dtype, edge_dtype=edge_dtype)
        begin = g.begin[: g.num_nodes + 1].cpu().numpy()
        dst = g.node_idx[: g.num_edges].cpu().numpy()
        src = np.repeat(np.arange(g.num_nodes, dtype=node_dtype),
                        np.diff(begin.astype(np.int64)))
        b.add_edges(src, dst.astype(node_dtype, copy=False))
        b._num_nodes = max(b._num_nodes, g.num_nodes)
        return b

    def add_nodekey(self, key) -> int:
        """External key -> dense id (created on first use)."""
        nid = self._key2id.get(key)
        if nid is None:
            nid = self.add_node()
            self._key2id[key] = nid
            self._id2key.extend([None] * (nid + 1 - len(self._id2key)))
            self._id2key[nid] = key
        return nid

    def find_nodekey(self, key) -> int:
        """Key -> id, -1 when absent (``gm_graph::find_nodekey``)."""
        return self._key2id.get(key, -1)

    def find_nodeid(self, nid: int):
        """Id -> key (``gm_graph::find_nodeid``); None for a node made
        without a key."""
        return self._id2key[nid] if 0 <= nid < len(self._id2key) else None

    def add_keyed_edge(self, skey, dkey) -> None:
        self.add_edge(self.add_nodekey(skey), self.add_nodekey(dkey))

    @property
    def nodekeys(self) -> list:
        return list(self._id2key)

    def add_node(self) -> int:
        self._num_nodes += 1
        return self._num_nodes - 1

    def add_nodes(self, n: int) -> None:
        self._num_nodes += int(n)

    def add_edge(self, s: int, d: int) -> None:
        self._src.append(s)
        self._dst.append(d)
        self._num_nodes = max(self._num_nodes, s + 1, d + 1)

    def add_edges(self, src, dst) -> None:
        src = np.asarray(src)
        dst = np.asarray(dst)
        self._src.append(src)
        self._dst.append(dst)
        if src.size:
            self._num_nodes = max(self._num_nodes, int(src.max()) + 1,
                                  int(dst.max()) + 1)

    def freeze(self) -> Tuple[Graph, np.ndarray]:
        """``(Graph on the CPU, csr_perm)`` of the edges so far, in the
        order they were added."""
        def cat(parts):
            if not parts:
                return np.zeros(0, self.node_dtype)
            return np.concatenate([np.atleast_1d(np.asarray(p))
                                   for p in parts])
        return from_edges(cat(self._src), cat(self._dst), self._num_nodes,
                          self.node_dtype, self.edge_dtype)


def to_undirected(src: np.ndarray, dst: np.ndarray,
                  dedup: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrise an edge list of node ids in ``[0, 2^31)`` (both
    directions, self-loops once).  With ``dedup`` the pairs come back unique
    and sorted by (source, destination): one sort of ``src << 32 | dst``
    keys, which orders them as a row-wise ``np.unique`` does."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    if dedup:
        keys = np.sort((s.astype(np.int64) << 32) | d.astype(np.int64))
        if keys.size:
            # sorted neighbours compared, not np.unique: numpy 2.3's takes
            # 17 s for 8.6M int64 keys where this takes 0.4 s
            keys = keys[np.concatenate([[True], keys[1:] != keys[:-1]])]
        s = (keys >> 32).astype(s.dtype)
        d = (keys & 0xFFFFFFFF).astype(d.dtype)
    return s, d


def degrees_np(g: Graph) -> Dict[str, Any]:
    """Host-side degree figures of a graph on any device (a loader's check)."""
    deg = np.diff(g.begin.cpu().numpy())
    return dict(
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        max_out_degree=int(deg.max(initial=0)),
        mean_out_degree=float(deg.mean()) if deg.size else 0.0,
    )
