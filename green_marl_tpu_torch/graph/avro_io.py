"""Avro object-container graph I/O (``gm_graph_avro_loader.cc`` analog).

A copy of ``green_marl_tpu/graph/avro_io.py``, which the port cannot
import (the JAX package's ``__init__`` imports jax).

The reference loads/stores graphs as Avro object-container files via the
vendored avro-c-1.7.2: one record per node with fields

    [ src node id : union(null, long),
      node prop 1 : union(null, T1), ...,
      edge list   : union(null, array< record{ dst : union(null,long),
                                               edge props ... } >) ]

(``gm_graph_avro_loader.cc:160-220``: first field = source id, middle
fields = node properties, last field = edge array).  This module
implements the same container format (magic ``Obj\\x01``, metadata map
with the JSON schema, 16-byte sync marker, zigzag-varint primitives) in
pure numpy/python — enough to round-trip reference-shaped files without
the avro-c dependency.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"Obj\x01"

_PRIM_NP = {"boolean": np.bool_, "int": np.int32, "long": np.int64,
            "float": np.float32, "double": np.float64}


# ---------------------------------------------------------------------------
# primitive codec
# ---------------------------------------------------------------------------

def _zz_enc(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zz_dec(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _write_long(out: io.BytesIO, n: int) -> None:
    u = _zz_enc(int(n)) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def long(self) -> int:
        u = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return _zz_dec(u)

    def boolean(self) -> bool:
        b = self.buf[self.pos]
        self.pos += 1
        return b != 0

    def float_(self) -> float:
        v = struct.unpack_from("<f", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def double(self) -> float:
        v = struct.unpack_from("<d", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def bytes_(self) -> bytes:
        n = self.long()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def prim(self, tname: str):
        if tname == "long" or tname == "int":
            return self.long()
        if tname == "boolean":
            return self.boolean()
        if tname == "float":
            return self.float_()
        if tname == "double":
            return self.double()
        raise ValueError(f"unsupported avro primitive {tname}")


def _write_prim(out: io.BytesIO, tname: str, v) -> None:
    if tname in ("long", "int"):
        _write_long(out, int(v))
    elif tname == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif tname == "float":
        out.write(struct.pack("<f", float(v)))
    elif tname == "double":
        out.write(struct.pack("<d", float(v)))
    else:
        raise ValueError(f"unsupported avro primitive {tname}")


def _branch_type(field_type) -> str:
    """union ["null", T] -> T (the reference reads branch 1)."""
    if isinstance(field_type, list):
        for t in field_type:
            if t != "null":
                return t if isinstance(t, str) else t["type"]
        raise ValueError("all-null union")
    if isinstance(field_type, dict):
        return field_type["type"]
    return field_type


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def graph_schema(nprop_types: Sequence[str],
                 eprop_types: Sequence[str]) -> dict:
    """Reference-shaped record schema: id, node props, edge array."""
    edge_fields = [{"name": "dst", "type": ["null", "long"]}]
    for i, t in enumerate(eprop_types):
        edge_fields.append({"name": f"eprop{i}", "type": ["null", t]})
    fields = [{"name": "id", "type": ["null", "long"]}]
    for i, t in enumerate(nprop_types):
        fields.append({"name": f"nprop{i}", "type": ["null", t]})
    fields.append({"name": "edges", "type": ["null", {
        "type": "array",
        "items": {"type": "record", "name": "edge",
                  "fields": edge_fields}}]})
    return {"type": "record", "name": "node", "fields": fields}


# ---------------------------------------------------------------------------
# store / load
# ---------------------------------------------------------------------------

def store_avro(path: str, begin: np.ndarray, node_idx: np.ndarray,
               node_props: Optional[List[np.ndarray]] = None,
               edge_props: Optional[List[np.ndarray]] = None,
               nprop_types: Optional[List[str]] = None,
               eprop_types: Optional[List[str]] = None,
               sync_every: int = 4096) -> None:
    node_props = node_props or []
    edge_props = edge_props or []
    if nprop_types is None:
        nprop_types = [_np_avro_type(a) for a in node_props]
    if eprop_types is None:
        eprop_types = [_np_avro_type(a) for a in edge_props]
    schema = graph_schema(nprop_types, eprop_types)
    sync = os.urandom(16)
    N = len(begin) - 1

    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = io.BytesIO()
        _write_long(meta, 2)
        for k, v in (("avro.schema", json.dumps(schema)),
                     ("avro.codec", "null")):
            kb, vb = k.encode(), v.encode()
            _write_long(meta, len(kb))
            meta.write(kb)
            _write_long(meta, len(vb))
            meta.write(vb)
        _write_long(meta, 0)
        f.write(meta.getvalue())
        f.write(sync)

        v0 = 0
        while v0 < N:
            v1 = min(v0 + sync_every, N)
            blk = io.BytesIO()
            for v in range(v0, v1):
                _write_long(blk, 1)          # union branch 1 (non-null)
                _write_long(blk, v)          # id
                for t, arr in zip(nprop_types, node_props):
                    _write_long(blk, 1)
                    _write_prim(blk, t, arr[v])
                _write_long(blk, 1)          # edges union branch
                cnt = int(begin[v + 1] - begin[v])
                if cnt:
                    _write_long(blk, cnt)    # array block count
                    for s in range(int(begin[v]), int(begin[v + 1])):
                        _write_long(blk, 1)
                        _write_long(blk, int(node_idx[s]))
                        for t, arr in zip(eprop_types, edge_props):
                            _write_long(blk, 1)
                            _write_prim(blk, t, arr[s])
                _write_long(blk, 0)          # array end
            data = blk.getvalue()
            hdr = io.BytesIO()
            _write_long(hdr, v1 - v0)
            _write_long(hdr, len(data))
            f.write(hdr.getvalue())
            f.write(data)
            f.write(sync)
            v0 = v1


def _np_avro_type(a: np.ndarray) -> str:
    k = np.asarray(a).dtype.kind
    if k == "b":
        return "boolean"
    if k == "i":
        return "long" if np.asarray(a).dtype.itemsize > 4 else "int"
    if k == "f":
        return "double" if np.asarray(a).dtype.itemsize > 4 else "float"
    raise ValueError(f"no avro type for dtype {np.asarray(a).dtype}")


def load_avro(path: str):
    """Returns (src, dst, node_props, edge_props, nprop_types,
    eprop_types, num_nodes) — edge endpoints in file order (the caller
    builds the CSR with ``from_edges``, like ``gm_graph::load_avro``);
    ``num_nodes`` comes from the record count, preserving isolated
    high-id nodes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError("not an Avro object container")
    r = _Reader(data)
    r.pos = 4
    meta: Dict[str, bytes] = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:
            # spec: negative block count is followed by the byte size
            n = -n
            r.long()
        for _ in range(n):
            k = r.bytes_().decode()
            meta[k] = r.bytes_()
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", ""):
        raise ValueError(f"unsupported avro codec {codec}")
    sync = data[r.pos:r.pos + 16]
    r.pos += 16

    fields = schema["fields"]
    if len(fields) < 2:
        raise ValueError("node record needs at least id + edges")
    nprop_types = [_branch_type(f["type"]) for f in fields[1:-1]]
    edges_t = fields[-1]["type"]
    arr_t = _branch_type(edges_t)
    if isinstance(edges_t, list):
        arr_schema = next(t for t in edges_t if t != "null")
    else:
        arr_schema = edges_t
    e_fields = arr_schema["items"]["fields"]
    eprop_types = [_branch_type(f["type"]) for f in e_fields[1:]]

    src: List[int] = []
    dst: List[int] = []
    nvals: List[List] = [[] for _ in nprop_types]
    evals: List[List] = [[] for _ in eprop_types]
    node_ids: List[int] = []

    def read_union_prim(tname):
        br = r.long()
        if br == 0:
            return None
        return r.prim(tname)

    while r.pos < len(data):
        count = r.long()
        size = r.long()
        end = r.pos + size
        for _ in range(count):
            vid = read_union_prim("long")
            if vid is None:
                raise ValueError("null node id (reference expects the "
                                 "non-null union branch)")
            node_ids.append(vid)
            for i, t in enumerate(nprop_types):
                nvals[i].append(read_union_prim(t))
            br = r.long()             # edges union
            if br != 0:
                while True:
                    cnt = r.long()
                    if cnt == 0:
                        break
                    if cnt < 0:       # block with byte size prefix
                        cnt = -cnt
                        r.long()
                    for _ in range(cnt):
                        d = read_union_prim("long")
                        src.append(vid)
                        dst.append(d)
                        for i, t in enumerate(eprop_types):
                            evals[i].append(read_union_prim(t))
        assert r.pos == end, (r.pos, end)
        if data[r.pos:r.pos + 16] != sync:
            raise ValueError("sync marker mismatch")
        r.pos += 16

    def finalize(vals, t):
        # a null union branch takes the avro default (0/False) instead
        # of poisoning np.asarray with None (advisor r3)
        default = False if t == "boolean" else 0
        return np.asarray([default if v is None else v for v in vals],
                          _PRIM_NP[t])

    nprops = [finalize(v, t) for v, t in zip(nvals, nprop_types)]
    eprops = [finalize(v, t) for v, t in zip(evals, eprop_types)]
    # one record per node: the record count IS the node count (isolated
    # high-id nodes would otherwise be lost by max-endpoint inference)
    num_nodes = max(len(node_ids),
                    int(max(node_ids, default=-1)) + 1)
    # records may arrive in any node-id order: re-align node property
    # rows with their ids (advisor r3: out-of-order files silently
    # misaligned properties)
    ids = np.asarray(node_ids, np.int64)
    if nprops and ids.size and not (np.diff(ids) > 0).all():
        aligned = []
        for arr in nprops:
            out = np.zeros(num_nodes, arr.dtype)
            out[ids] = arr
            aligned.append(out)
        nprops = aligned
    return (np.asarray(src, np.int64), np.asarray(dst, np.int64),
            nprops, eprops, nprop_types, eprop_types, num_nodes)
