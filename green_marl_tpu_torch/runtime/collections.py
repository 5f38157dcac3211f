"""Collection types of compiled programs (the reference's ``gm_graph``
collections).

Counterpart of ``green_marl_tpu/runtime/collections.py``:

=====================  ====================================================
reference              here
=====================  ====================================================
``gm_sized_set``       ``NodeSet``: a bitmap over the padded node space
``gm_seq``             ``NodeSeq``: a fixed-capacity ring with a count
``gm_order``           ``NodeOrder``: a NodeSeq with a membership bitmap
``gm_map_*``           ``DenseNodeMap``: ``Map<Node, V>`` as dense value and
                       presence tensors
=====================  ====================================================

Every structure is a frozen dataclass of tensors; mutating verbs return new
values.  JAX treats these as pytrees; here :func:`tree_map` and
:func:`tree_leaves` walk their fields, so that a loop carry or a branch
merge can treat them leaf by leaf.

Indexing follows JAX's rules for out-of-range indices, which the lowering
relies on: :func:`take` wraps negative indices once and clamps the rest,
:func:`put` wraps negative indices once and drops what is still out of
range.  Each of them also takes lane values of a batched program
(``runtime.lanes``): lane-leading arrays with shared or per-lane indices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import lanes as LN


# ---------------------------------------------------------------------------
# JAX's indexing rules
# ---------------------------------------------------------------------------

def _index(idx, n: int, device) -> torch.Tensor:
    idx = torch.as_tensor(idx, device=device).long()
    return torch.where(idx < 0, idx + n, idx)


def take(arr: torch.Tensor, idx) -> torch.Tensor:
    """``arr[idx]`` along axis 0 as a JAX gather: a negative index counts
    from the end, an index still out of range reads the nearest row."""
    if LN.is_lanes(arr) or LN.is_lanes(idx):
        return LN.take(arr, torch.as_tensor(idx, device=arr.device))
    n = arr.shape[0]
    return arr[_index(idx, n, arr.device).clamp(0, n - 1)]


def put(arr: torch.Tensor, idx, val) -> torch.Tensor:
    """``arr.at[idx].set(val)`` along axis 0: a new tensor; a negative index
    counts from the end, an index still out of range is dropped.  Duplicate
    indices must carry equal values (every caller writes a constant or a
    single index)."""
    if any(LN.is_lanes(x) for x in (arr, idx, val)):
        return LN.put(arr, idx, val)
    n = arr.shape[0]
    i = _index(idx, n, arr.device)
    i = torch.where((i >= 0) & (i < n), i, n).reshape(-1)
    v = torch.as_tensor(val, device=arr.device).to(arr.dtype)
    v = v.expand(tuple(i.shape) + tuple(arr.shape[1:])) \
        if v.dim() == 0 else v.reshape((-1,) + tuple(arr.shape[1:]))
    buf = torch.cat([arr, arr[:1]])     # row n takes the dropped writes
    buf.index_put_((i,), v)
    return buf[:n]


def put2(arr: torch.Tensor, rows, cols, val) -> torch.Tensor:
    """``arr.at[rows, cols].set(val)`` on a 2-D tensor, JAX's rules per
    axis (a write out of range on either axis is dropped)."""
    n0, n1 = arr.shape[-2:]
    r = _index(rows, n0, arr.device)
    c = _index(cols, n1, arr.device)
    if any(LN.is_lanes(x) for x in (arr, r, c, val)):
        # one scatter per lane into the flattened matrix
        ok = (r >= 0) & (r < n0) & (c >= 0) & (c < n1)
        flat = LN.put(arr.flatten(-2), torch.where(ok, r * n1 + c, n0 * n1),
                     val)
        return flat.reshape(flat.shape[0], n0, n1)
    r, c = torch.broadcast_tensors(r, c)
    ok = (r >= 0) & (r < n0) & (c >= 0) & (c < n1)
    flat = torch.where(ok, r * n1 + c, n0 * n1).reshape(-1)
    v = torch.as_tensor(val, device=arr.device).to(arr.dtype)
    buf = torch.cat([arr.reshape(-1), arr.reshape(-1)[:1]])
    buf.index_put_((flat,), v.expand(flat.shape) if v.dim() == 0
                   else v.reshape(-1))
    return buf[: n0 * n1].reshape(n0, n1)


# ---------------------------------------------------------------------------
# Leafwise maps over the dataclasses (JAX's pytree walk)
# ---------------------------------------------------------------------------

def is_tree(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def tree_map(fn, *trees):
    """``jax.tree_util.tree_map`` over these dataclasses (fields in
    declaration order; a tensor is a leaf)."""
    t0 = trees[0]
    if is_tree(t0):
        return type(t0)(**{
            f.name: tree_map(fn, *[getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0)})
    return fn(*trees)


def tree_leaves(tree) -> list:
    if is_tree(tree):
        out = []
        for f in dataclasses.fields(tree):
            out.extend(tree_leaves(getattr(tree, f.name)))
        return out
    return [tree]


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


# ---------------------------------------------------------------------------
# The collections
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeSet:
    """Bitmap node set (``gm_sized_set``)."""
    bits: torch.Tensor   # [N_pad] bool

    @staticmethod
    def empty(n_pad: int, device="cpu") -> "NodeSet":
        return NodeSet(bits=torch.zeros(n_pad, dtype=torch.bool,
                                        device=device))

    def add(self, v) -> "NodeSet":
        return NodeSet(put(self.bits, v, True))

    def add_mask(self, mask: torch.Tensor) -> "NodeSet":
        return NodeSet(self.bits | mask)

    def remove(self, v) -> "NodeSet":
        return NodeSet(put(self.bits, v, False))

    def has(self, v) -> torch.Tensor:
        return take(self.bits, v)

    def size(self) -> torch.Tensor:
        return LN.reduce("sum", self.bits.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class NodeSeq:
    """Fixed-capacity sequence (``gm_seq``): push front and back.

    A ring buffer; ``head`` is the index of the front element.  The
    capacity is declared up front (typically N); the caller precludes
    overflow."""
    buf: torch.Tensor     # [cap] node ids
    head: torch.Tensor    # int32
    count: torch.Tensor   # int32

    @staticmethod
    def empty(cap: int, device="cpu", dtype=torch.int32) -> "NodeSeq":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return NodeSeq(buf=torch.full((cap,), -1, dtype=dtype,
                                      device=device), head=z, count=z)

    @property
    def capacity(self) -> int:
        return int(self.buf.shape[-1])

    def push_back(self, v) -> "NodeSeq":
        pos = (self.head + self.count) % self.capacity
        return NodeSeq(put(self.buf, pos, v), self.head, self.count + 1)

    def push_front(self, v) -> "NodeSeq":
        pos = (self.head - 1) % self.capacity
        return NodeSeq(put(self.buf, pos, v), pos, self.count + 1)

    def pop_back(self) -> Tuple[torch.Tensor, "NodeSeq"]:
        """Callers guard ``Size() > 0`` (the reference's precondition);
        on an empty sequence the count stays at 0."""
        pos = (self.head + self.count - 1) % self.capacity
        return take(self.buf, pos), NodeSeq(
            self.buf, self.head, (self.count - 1).clamp(min=0))

    def pop_front(self) -> Tuple[torch.Tensor, "NodeSeq"]:
        """See pop_back."""
        new_head = torch.where(self.count > 0,
                               (self.head + 1) % self.capacity, self.head)
        return (take(self.buf, self.head),
                NodeSeq(self.buf, new_head, (self.count - 1).clamp(min=0)))

    def items(self) -> torch.Tensor:
        """[cap] ids in order, -1 beyond ``count``."""
        ar = torch.arange(self.capacity, device=self.buf.device)
        vals = take(self.buf, (self.head + ar) % self.capacity)
        return torch.where(ar < self.count, vals,
                           torch.full((), -1, dtype=vals.dtype,
                                      device=vals.device))


@dataclasses.dataclass(frozen=True)
class NodeOrder:
    """Sequence with uniqueness (``gm_order``)."""
    seq: NodeSeq
    member: torch.Tensor  # [N_pad] bool

    @staticmethod
    def empty(cap: int, n_pad: int, device="cpu") -> "NodeOrder":
        # one extra slot takes the writes of duplicate pushes
        return NodeOrder(NodeSeq.empty(cap + 1, device),
                         torch.zeros(n_pad, dtype=torch.bool, device=device))

    def push_back(self, v) -> "NodeOrder":
        fresh = ~take(self.member, v)
        cap = self.seq.capacity
        pos = torch.where(fresh, (self.seq.head + self.seq.count) % cap,
                          cap - 1)
        seq = NodeSeq(put(self.seq.buf, pos, v), self.seq.head,
                      self.seq.count + fresh.to(torch.int32))
        return NodeOrder(seq, put(self.member, v, True))

    def has(self, v) -> torch.Tensor:
        return take(self.member, v)


def _extrema(dtype):
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


@dataclasses.dataclass(frozen=True)
class DenseNodeMap:
    """``Map<Node, V>`` as dense value and presence tensors (node-keyed, so
    an [N_pad] slab replaces the hash map).  Min and max queries break
    value ties by the smallest key."""
    val: torch.Tensor       # [N_pad] value dtype
    present: torch.Tensor   # [N_pad] bool

    @staticmethod
    def empty(n_pad: int, dtype=torch.int32, device="cpu") -> "DenseNodeMap":
        return DenseNodeMap(torch.zeros(n_pad, dtype=dtype, device=device),
                            torch.zeros(n_pad, dtype=torch.bool,
                                        device=device))

    def set(self, k, v) -> "DenseNodeMap":
        return DenseNodeMap(put(self.val, k, v), put(self.present, k, True))

    def add(self, k, v) -> "DenseNodeMap":
        """changeValueAtomicAdd: an absent key maps to the summand."""
        cur = torch.where(take(self.present, k), take(self.val, k),
                          torch.zeros((), dtype=self.val.dtype,
                                      device=self.val.device))
        return DenseNodeMap(put(self.val, k, cur + v),
                            put(self.present, k, True))

    def get(self, k):
        """An absent key reads the default value (``V()``)."""
        return torch.where(take(self.present, k), take(self.val, k),
                           torch.zeros((), dtype=self.val.dtype,
                                       device=self.val.device))

    def remove(self, k) -> "DenseNodeMap":
        return DenseNodeMap(self.val, put(self.present, k, False))

    def has_key(self, k):
        return take(self.present, k)

    def size(self):
        return LN.reduce("sum", self.present.to(torch.int32))

    def _masked(self, for_min: bool):
        big, small = _extrema(self.val.dtype)
        return torch.where(self.present, self.val,
                           torch.full((), big if for_min else small,
                                      dtype=self.val.dtype,
                                      device=self.val.device))

    def min_key(self):
        """Key with the minimum value (getMinKey_seq); ties: smallest key."""
        return LN.arg("min", self._masked(True)).to(torch.int32)

    def max_key(self):
        return LN.arg("max", self._masked(False)).to(torch.int32)

    def min_value(self):
        return LN.reduce("min", self._masked(True))

    def max_value(self):
        return LN.reduce("max", self._masked(False))

    def has_min_value(self, k):
        return take(self.present, k) & (take(self.val, k) == self.min_value())

    def has_max_value(self, k):
        return take(self.present, k) & (take(self.val, k) == self.max_value())
