"""Exact host replica of the reference's mutable priority map.

The reference's generated C++ backs every ``Map<Node, T>`` that drives
a pop-min/pop-max loop with ``gm_mutatable_priority_map_unordered_min``
/ ``_max`` (``gm_cpplib_gen.cc:139-150``): a binary heap
(``value_vector`` / ``key_vector``) with STRICT ``is_less`` sift rules
plus an unordered map for ``hasKey``/``getValue``
(``gm_mutatable_priority_map.h:894-1267``).  Pop order among EQUAL
priorities is therefore fully determined by the heap mechanics and the
operation sequence — no libstdc++ iteration-order dependence — so a
faithful re-implementation reproduces the reference's pop order
POP-FOR-POP, including ties.

This module mirrors those mechanics operation by operation:

* ``set_value`` on a new key appends to the heap tail + ``heapify_up``
  (``insertToHeap``, h:1253-1262 / 1125-1132).
* ``set_value`` on an existing key with a CHANGED value adjusts in
  place: ``heapify_up`` if the new value is strictly less (toward the
  root), else ``heapify_down`` (``adjustHeap``, h:1134-1143).  Setting
  the SAME value is a no-op (h:941 ``if (oldValue == value) return``)
  — it must not disturb heap order.
* ``remove_min`` erases the root, moves the LAST heap element to the
  root, and ``heapify_down`` (``removeSmallest``, h:999-1020).
* ``heapify_down`` prefers the LEFT child on equal children (strict
  ``is_less`` comparisons only, h:1172-1197); ``heapify_up`` stops on
  equality (h:1199-1211).

A copy of ``green_marl_tpu/runtime/priority_map.py``, which the port
cannot import.  It is the host-exact reference semantics used by
``models/sssp.dijkstra_host_exact``; the JAX package's copy is held
against a driver compiled from the reference header
(``tests/test_priority_map.py``), and this one against the JAX package's
(``tests/test_torch_paths.py``).
"""

from __future__ import annotations

from typing import Dict, Generic, List, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class MutatablePriorityMap(Generic[K, V]):
    """``gm_mutatable_priority_map_unordered_min/max`` replica.

    ``is_min=True`` replicates ``_min`` (``is_less = v1 < v2``),
    ``is_min=False`` replicates ``_max`` (``is_less = v1 > v2``,
    h:1270-1333).  ``default`` is returned by ``get_value`` for absent
    keys (``getValue``, h:917-923).
    """

    def __init__(self, default: V, is_min: bool = True):
        self._default = default
        self._is_min = is_min
        self._value: Dict[K, V] = {}      # data_map: key -> value
        self._index: Dict[K, int] = {}    # the int* place-holders
        self._vals: List[V] = []          # value_vector
        self._keys: List[K] = []          # key_vector

    # -- is_less ------------------------------------------------------
    def _less(self, a: V, b: V) -> bool:
        return (a < b) if self._is_min else (a > b)

    # -- queries ------------------------------------------------------
    def has_key(self, key: K) -> bool:
        return key in self._value

    def get_value(self, key: K) -> V:
        return self._value.get(key, self._default)

    def size(self) -> int:
        return len(self._value)

    def clear(self) -> None:
        self._value.clear()
        self._index.clear()
        self._vals.clear()
        self._keys.clear()

    # getMinKey_seq / getMinValue_seq read the heap ROOT (h:987-997);
    # for the _max subclass the same methods are exposed as getMaxKey.
    def peek_key(self) -> K:
        assert self._keys, "peek on empty priority map"
        return self._keys[0]

    def peek_value(self) -> V:
        assert self._vals, "peek on empty priority map"
        return self._vals[0]

    # -- mutation -----------------------------------------------------
    def set_value(self, key: K, value: V) -> None:
        """``setValue_seq`` (h:931-946)."""
        if key not in self._value:
            self._index[key] = len(self._keys)
            self._vals.append(value)
            self._keys.append(key)
            self._value[key] = value
            self._heapify_up(len(self._keys) - 1)
        else:
            old = self._value[key]
            if old == value:
                return                      # h:941 — no heap movement
            self._value[key] = value
            idx = self._index[key]
            self._vals[idx] = value
            if self._less(value, old):
                self._heapify_up(idx)       # adjustHeap, h:1134-1143
            else:
                self._heapify_down(idx)

    def remove_root(self) -> K:
        """``removeMinKey_seq`` -> ``removeSmallest`` (h:999-1020).
        Returns the removed key (the reference returns void; callers
        read ``GetMinKey`` first — returning it here is a convenience
        that does not alter state order)."""
        assert self._keys, "remove on empty priority map"
        root = self._keys[0]
        del self._value[root]
        del self._index[root]
        last = len(self._keys) - 1
        self._vals[0] = self._vals[last]
        self._keys[0] = self._keys[last]
        if last > 0:
            self._index[self._keys[0]] = 0
        self._vals.pop()
        self._keys.pop()
        self._heapify_down(0)
        return root

    # -- heap mechanics (h:1162-1211) ---------------------------------
    def _swap(self, i: int, j: int) -> None:
        self._vals[i], self._vals[j] = self._vals[j], self._vals[i]
        self._keys[i], self._keys[j] = self._keys[j], self._keys[i]
        self._index[self._keys[i]] = i
        self._index[self._keys[j]] = j

    def _heapify_down(self, i: int) -> None:
        n = len(self._vals)
        while True:
            left = 2 * i + 1
            right = 2 * i + 2
            smallest = i
            if left < n and self._less(self._vals[left],
                                       self._vals[smallest]):
                smallest = left
            if right < n and self._less(self._vals[right],
                                        self._vals[smallest]):
                smallest = right
            if smallest == i:
                return
            self._swap(smallest, i)
            i = smallest

    def _heapify_up(self, i: int) -> None:
        while i > 0:
            parent = (i - 1) // 2
            if not self._less(self._vals[i], self._vals[parent]):
                return
            self._swap(i, parent)
            i = parent

    # -- invariants (check_integrity, h:1234-1266) --------------------
    def check_integrity(self) -> None:
        n = len(self._vals)
        assert len(self._keys) == n == len(self._value) == \
            len(self._index)
        for i in range(n):
            for c in (2 * i + 1, 2 * i + 2):
                if c < n:
                    assert not self._less(self._vals[c], self._vals[i])
            assert self._index[self._keys[i]] == i
            assert self._value[self._keys[i]] == self._vals[i]
