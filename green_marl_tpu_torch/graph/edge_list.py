"""Text graph loaders and writers: edge list (with typed properties) and
adjacency list.

Counterpart of ``green_marl_tpu/graph/edge_list.py`` (``EdgeListResult``,
``load_edge_list``, ``store_edge_list``, ``load_adjacency_list``,
``load_snap_edge_list``), copied: that file imports the JAX package's
``csr``, which imports jax.  It reimplements the reference readers
(``apps/output_cpp/gm_graph/inc/gm_edge_list_graph_reader.h:17-240``,
``src/gm_edge_list_graph_reader.cc``, ``src/gm_graph_adj_loader.cc``) with
numpy instead of line-at-a-time ``strtok``.

Edge-list format (one record per line, ``#`` comments skipped)::

    <node-key> * <node-prop ...>      # node-definition line
    <src-key> <dst-key> <edge-prop ...>

Node keys may be arbitrary non-contiguous ids.  They are remapped to dense
node ids in first-appearance order, with destination-only nodes appended
after all keyed nodes (``load_adjacency_list_internal``'s DEST_ONLY
handling, ``gm_graph_adj_loader.cc:37-62``).

Adjacency-list format: ``load_adjacency_list`` accepts the common
``src dst1 dst2 ...`` form, not the reference's line with properties.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import binary_io as bio
from .csr import Graph, from_edges

_TYPE_TO_NP = {
    bio.GMTYPE_BOOL: np.dtype(bool),
    bio.GMTYPE_INT: np.dtype(np.int32),
    bio.GMTYPE_LONG: np.dtype(np.int64),
    bio.GMTYPE_FLOAT: np.dtype(np.float32),
    bio.GMTYPE_DOUBLE: np.dtype(np.float64),
    bio.GMTYPE_NODE: np.dtype(np.int32),
    bio.GMTYPE_EDGE: np.dtype(np.int32),
}

_PARSE_BOOL = {"true": True, "false": False, "1": True, "0": False}


def _parse_token(tok: str, tid: int):
    if tid == bio.GMTYPE_BOOL:
        return _PARSE_BOOL[tok.lower()]
    if tid in (bio.GMTYPE_FLOAT, bio.GMTYPE_DOUBLE):
        return float(tok)
    return int(tok)


class EdgeListResult:
    """Decoded edge-list file (host side)."""

    def __init__(self):
        self.src: np.ndarray = np.zeros(0, np.int64)
        self.dst: np.ndarray = np.zeros(0, np.int64)
        self.nodekey: Optional[np.ndarray] = None  # dense id -> original key
        self.node_props: List[np.ndarray] = []
        self.edge_props: List[np.ndarray] = []     # in input edge order
        self.num_nodes: int = 0

    def freeze(self) -> Tuple[Graph, List[np.ndarray]]:
        g, perm = from_edges(self.src, self.dst, self.num_nodes)
        eprops = [p[perm] for p in self.edge_props]
        return g, eprops


def load_edge_list(path: str,
                   node_schema: Sequence[int] = (),
                   edge_schema: Sequence[int] = ()) -> EdgeListResult:
    """Parse an edge-list file with optional typed property schemas."""
    keys: Dict[int, int] = {}
    order: List[int] = []

    def intern(key: int) -> int:
        nid = keys.get(key)
        if nid is None:
            nid = len(order)
            keys[key] = nid
            order.append(key)
        return nid

    src_l: List[int] = []
    dst_l: List[int] = []
    nprops_rows: Dict[int, tuple] = {}
    eprops_rows: List[tuple] = []

    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            u = intern(int(toks[0]))
            if len(toks) > 1 and toks[1] == "*":
                vals = toks[2:]
                if len(vals) != len(node_schema):
                    raise ValueError(
                        f"{path}:{lineno}: expected {len(node_schema)} "
                        f"node props, got {len(vals)}")
                nprops_rows[u] = tuple(
                    _parse_token(t, tid) for t, tid in zip(vals, node_schema))
            else:
                if len(toks) < 2:
                    raise ValueError(f"{path}:{lineno}: missing destination")
                v = intern(int(toks[1]))
                vals = toks[2:]
                if len(vals) != len(edge_schema):
                    raise ValueError(
                        f"{path}:{lineno}: expected {len(edge_schema)} "
                        f"edge props, got {len(vals)}")
                src_l.append(u)
                dst_l.append(v)
                eprops_rows.append(tuple(
                    _parse_token(t, tid) for t, tid in zip(vals, edge_schema)))

    res = EdgeListResult()
    res.num_nodes = len(order)
    res.nodekey = np.asarray(order, dtype=np.int64)
    res.src = np.asarray(src_l, dtype=np.int64)
    res.dst = np.asarray(dst_l, dtype=np.int64)
    for j, tid in enumerate(node_schema):
        col = np.zeros(res.num_nodes, dtype=_TYPE_TO_NP[tid])
        for nid, row in nprops_rows.items():
            col[nid] = row[j]
        res.node_props.append(col)
    for j, tid in enumerate(edge_schema):
        col = np.asarray([r[j] for r in eprops_rows], dtype=_TYPE_TO_NP[tid])
        res.edge_props.append(col)
    return res


def store_edge_list(path: str, src: np.ndarray, dst: np.ndarray,
                    nodekey: Optional[np.ndarray] = None,
                    node_props: Sequence[np.ndarray] = (),
                    edge_props: Sequence[np.ndarray] = ()) -> None:
    """Write an edge-list file readable by ``load_edge_list`` (and by the
    reference reader, given matching schemas)."""
    def fmt(v):
        if isinstance(v, (bool, np.bool_)):
            return "true" if v else "false"
        return repr(float(v)) if isinstance(v, (float, np.floating)) else str(int(v))

    n = (max(int(src.max(initial=-1)), int(dst.max(initial=-1))) + 1
         if src.size else 0)
    key = nodekey if nodekey is not None else np.arange(n)
    with open(path, "w") as f:
        for i in range(len(node_props[0]) if node_props else 0):
            f.write(f"{key[i]} * " +
                    " ".join(fmt(p[i]) for p in node_props) + "\n")
        for e in range(src.shape[0]):
            line = f"{key[src[e]]} {key[dst[e]]}"
            if edge_props:
                line += " " + " ".join(fmt(p[e]) for p in edge_props)
            f.write(line + "\n")


def load_adjacency_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``src dst1 dst2 ...`` adjacency text into an edge list."""
    src_l: List[int] = []
    dst_l: List[int] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            u = int(toks[0])
            for t in toks[1:]:
                src_l.append(u)
                dst_l.append(int(t))
    return np.asarray(src_l, np.int64), np.asarray(dst_l, np.int64)


def load_snap_edge_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Plain two-column (SNAP-style) edge lists such as
    soc-LiveJournal1.txt, the input of the reference's format-converter
    pipeline (``README.md:28-33``): ``(src, dst)`` int64."""
    data = np.loadtxt(path, dtype=np.int64, comments="#", ndmin=2)
    return data[:, 0].copy(), data[:, 1].copy()
