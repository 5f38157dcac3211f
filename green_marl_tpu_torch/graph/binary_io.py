"""Reference-compatible binary graph files (BIN and EBIN).

Counterpart of ``green_marl_tpu/graph/binary_io.py``, bit-compatible with
the reference format (``gm_graph_binary_loader.cc:16-40``).  Basic format
(magic ``0x03939999``), every multi-byte field big-endian::

    [MAGIC_WORD     : 4B]
    [sizeof(node_t) : 4B]     (4 or 8)
    [sizeof(edge_t) : 4B]
    [num nodes N    : sizeof(node_t)]
    [num edges E    : sizeof(edge_t)]
    [begin[0..N]    : sizeof(edge_t) * (N+1)]
    [node_idx[0..E) : sizeof(node_t) * E]

The extended format (magic ``0x99191191``) continues with::

    [nodekey defined : 1B] { [reverse key : sizeof(node_t) * N] }
    [num node props  : 4B] ( [type:4B] [bytes:8B] [data] )*
    [num edge props  : 4B] ( [type:4B] [bytes:8B] [data] )*

Property payloads are big-endian element by element; 1-byte bools are raw.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .csr import Graph, from_edges

MAGIC_WORD_BIN = 0x03939999
MAGIC_WORD_EBIN = 0x99191191

# VALUE_TYPE enum (gm_graph_typedef.h:22-31)
GMTYPE_BOOL = 0
GMTYPE_INT = 1
GMTYPE_LONG = 2
GMTYPE_FLOAT = 3
GMTYPE_DOUBLE = 4
GMTYPE_NODE = 5
GMTYPE_EDGE = 6

_TYPE_TO_BE_DTYPE = {
    GMTYPE_BOOL: np.dtype("u1"),
    GMTYPE_INT: np.dtype(">i4"),
    GMTYPE_LONG: np.dtype(">i8"),
    GMTYPE_FLOAT: np.dtype(">f4"),
    GMTYPE_DOUBLE: np.dtype(">f8"),
}

_NP_KIND_TO_TYPE = {
    ("b", 1): GMTYPE_BOOL,
    ("u", 1): GMTYPE_BOOL,
    ("i", 4): GMTYPE_INT,
    ("i", 8): GMTYPE_LONG,
    ("f", 4): GMTYPE_FLOAT,
    ("f", 8): GMTYPE_DOUBLE,
}


def value_type_of(arr: np.ndarray) -> int:
    key = (arr.dtype.kind, arr.dtype.itemsize)
    if key not in _NP_KIND_TO_TYPE:
        raise ValueError(f"no GMTYPE for dtype {arr.dtype}")
    return _NP_KIND_TO_TYPE[key]


def _be_dtype(type_id: int, node_bytes: int, edge_bytes: int) -> np.dtype:
    if type_id == GMTYPE_NODE:
        return np.dtype(f">i{node_bytes}")
    if type_id == GMTYPE_EDGE:
        return np.dtype(f">i{edge_bytes}")
    if type_id not in _TYPE_TO_BE_DTYPE:
        raise ValueError(f"unknown property type {type_id}")
    return _TYPE_TO_BE_DTYPE[type_id]


@dataclass
class RawGraph:
    """A decoded graph file: the file's CSR (insertion order) plus the
    optional node keys and properties."""
    begin: np.ndarray
    node_idx: np.ndarray
    nodekey: Optional[np.ndarray] = None
    node_props: List[np.ndarray] = field(default_factory=list)
    edge_props: List[np.ndarray] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return int(self.begin.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.node_idx.shape[0])

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray]:
        deg = np.diff(self.begin)
        src = np.repeat(
            np.arange(self.num_nodes, dtype=self.node_idx.dtype), deg)
        return src, self.node_idx.copy()

    def freeze(self) -> Tuple[Graph, np.ndarray]:
        """Host ``Graph`` (semi-sorted, as the reference does after loading
        the basic format) and its CSR permutation."""
        src, dst = self.edge_list()
        edge_dtype = np.int64 if self.begin.dtype.itemsize == 8 else np.int32
        return from_edges(src, dst, self.num_nodes,
                          node_dtype=self.node_idx.dtype.newbyteorder("="),
                          edge_dtype=edge_dtype)


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated graph file")
    return b


def load_binary(path: str) -> RawGraph:
    """Load a basic or extended binary graph (told apart by the magic)."""
    with open(path, "rb") as f:
        (magic,) = struct.unpack(">I", _read_exact(f, 4))
        if magic not in (MAGIC_WORD_BIN, MAGIC_WORD_EBIN):
            raise ValueError(f"bad magic word 0x{magic:08x}")
        extended = magic == MAGIC_WORD_EBIN

        (node_bytes,) = struct.unpack(">i", _read_exact(f, 4))
        (edge_bytes,) = struct.unpack(">i", _read_exact(f, 4))
        if node_bytes not in (4, 8) or edge_bytes not in (4, 8):
            raise ValueError("unsupported node_t/edge_t size")
        node_be = np.dtype(f">i{node_bytes}")
        edge_be = np.dtype(f">i{edge_bytes}")

        N = int(np.frombuffer(_read_exact(f, node_bytes), node_be)[0])
        E = int(np.frombuffer(_read_exact(f, edge_bytes), edge_be)[0])
        if N < 0 or E < 0:
            raise ValueError(f"negative size in header: N={N} E={E}")

        begin = np.frombuffer(_read_exact(f, edge_bytes * (N + 1)),
                              edge_be).astype(f"=i{edge_bytes}")
        node_idx = np.frombuffer(_read_exact(f, node_bytes * E),
                                 node_be).astype(f"=i{node_bytes}")
        raw = RawGraph(begin=begin, node_idx=node_idx)
        if not extended:
            return raw

        if _read_exact(f, 1)[0]:
            raw.nodekey = np.frombuffer(
                _read_exact(f, node_bytes * N), node_be).astype(
                    f"=i{node_bytes}")

        for dest, count in ((raw.node_props, N), (raw.edge_props, E)):
            (nprops,) = struct.unpack(">i", _read_exact(f, 4))
            for _ in range(nprops):
                (tid,) = struct.unpack(">i", _read_exact(f, 4))
                (nbytes,) = struct.unpack(">q", _read_exact(f, 8))
                dt = _be_dtype(tid, node_bytes, edge_bytes)
                data = np.frombuffer(_read_exact(f, nbytes), dt)
                if data.shape[0] != count:
                    raise ValueError("property length mismatch")
                arr = data.astype(dt.newbyteorder("="))
                if tid == GMTYPE_BOOL:
                    arr = arr.astype(bool)
                dest.append(arr)
        return raw


def store_binary(path: str, begin: np.ndarray, node_idx: np.ndarray,
                 node_bytes: int = 4, edge_bytes: int = 4,
                 nodekey: Optional[np.ndarray] = None,
                 node_props: Optional[List[np.ndarray]] = None,
                 edge_props: Optional[List[np.ndarray]] = None,
                 extended: Optional[bool] = None) -> None:
    """Write a basic (or, with properties or keys, extended) binary graph."""
    node_props = node_props or []
    edge_props = edge_props or []
    if extended is None:
        extended = bool(node_props or edge_props or nodekey is not None)
    N = begin.shape[0] - 1
    E = node_idx.shape[0]
    node_be = np.dtype(f">i{node_bytes}")
    edge_be = np.dtype(f">i{edge_bytes}")
    with open(path, "wb") as f:
        f.write(struct.pack(">I",
                            MAGIC_WORD_EBIN if extended else MAGIC_WORD_BIN))
        f.write(struct.pack(">i", node_bytes))
        f.write(struct.pack(">i", edge_bytes))
        f.write(np.asarray([N], dtype=node_be).tobytes())
        f.write(np.asarray([E], dtype=edge_be).tobytes())
        f.write(np.asarray(begin, dtype=edge_be).tobytes())
        f.write(np.asarray(node_idx, dtype=node_be).tobytes())
        if not extended:
            return
        f.write(struct.pack("B", 1 if nodekey is not None else 0))
        if nodekey is not None:
            f.write(np.asarray(nodekey, dtype=node_be).tobytes())
        for props in (node_props, edge_props):
            f.write(struct.pack(">i", len(props)))
            for arr in props:
                arr = np.asarray(arr)
                tid = value_type_of(arr)
                payload = arr.astype(
                    _be_dtype(tid, node_bytes, edge_bytes)).tobytes()
                f.write(struct.pack(">i", tid))
                f.write(struct.pack(">q", len(payload)))
                f.write(payload)


def load_graph(path: str) -> Tuple[Graph, RawGraph, np.ndarray]:
    """Load and freeze in one call: ``(Graph on the CPU, raw, csr_perm)``."""
    raw = load_binary(path)
    g, perm = raw.freeze()
    return g, raw, perm
