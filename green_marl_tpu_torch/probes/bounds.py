"""The least bytes each hand-written kernel of the port must move, and the
least time that takes on the card.

Each function takes shapes, not tensors, and counts every input the kernel
needs read once and every output written once, whatever the kernel reads
again: the bound of a memory-bound kernel, over :data:`HBM_BYTES_PER_MS`.
The segment reduce and the relax step count the slots in
``[offsets[0], offsets[-1])``, the only slots they read.  Every value,
id, offset and flag is 4 bytes, ``updated`` 1.

The probes (``probes/segment.py``, ``probes/gather.py``,
``scripts/probe_relax.py``, ``scripts/probe_edge_map.py``) take their bounds
from here.  The benchmark keeps frozen copies of two of them
(``gmbench/metrics/_roofline.py``, ``_edge_map_bytes.py``), and
``tests/test_torch_probes.py`` holds these counts equal to them.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_MS = 3.35e9    # H100 SXM data sheet: 3.35 TB/s at 700 W


def bound_ms(nbytes: int) -> float:
    """The least ms the card takes to move ``nbytes`` at its peak."""
    return nbytes / HBM_BYTES_PER_MS


def segment_reduce(slots: int, offsets: int, n_out: int,
                   lanes: int = 1) -> int:
    """``segment_reduce_sorted``: each lane's ``slots`` values in range and
    ``n_out`` rows out, and the ``offsets`` once."""
    return lanes * (4 * slots + 4 * n_out) + 4 * offsets


def relax(slots: int, offsets: int, n_out: int, weighted: bool) -> int:
    """The segment reduce's gather form (hop_dist's and sssp's relax step):
    the source id of each slot in range (and its weight when
    ``weighted``), the offsets, the ``n_out`` rows out, and ``dist`` and
    ``updated`` over ``n_out`` nodes."""
    return ((8 if weighted else 4) * slots + 4 * offsets
            + (4 + 4 + 1) * n_out)


def plain_cumsum(n: int, lanes: int = 1, exclusive: bool = False) -> int:
    """``plain_cumsum``: ``n`` values in and ``n`` (``n + 1`` exclusive)
    out, a lane."""
    return 4 * lanes * (2 * n + int(exclusive))


def segmented_scan(n: int) -> int:
    """``segmented_scan``: ``n`` values and ``n`` segment ids in, ``n``
    out."""
    return 12 * n


def take_along_blocks(table_numel: int, idx_rows: int, lanes: int,
                      mode: str) -> int:
    """``take_along_blocks``: the table once, each of the
    ``[idx_rows, lanes]`` values out, and each index in (the row mode needs
    one a row)."""
    idx = idx_rows if mode == "row" else idx_rows * lanes
    return 4 * table_numel + 4 * idx_rows * lanes + 4 * idx


def row_gather_checksum(distinct_rows: int, row_bytes: int,
                        ids: int) -> int:
    """``row_gather_checksum``: each row its ids name, once, and the ids."""
    return distinct_rows * row_bytes + 4 * ids


def edge_map_bor(slots: int, n_rows: int, row_bytes: int) -> Tuple[int, int]:
    """``edge_map_bor``, one call: ``(table once, gathered rows)``.  The
    first reads each slot's id, the table and writes the output once each
    (what ``edge_map_roofline_pct`` counts); the second reads each slot's
    source row besides, one for each slot past the ``n_rows`` that the
    table once holds."""
    table = 4 * slots + 2 * n_rows * row_bytes
    return table, table + (slots - n_rows) * row_bytes


def edge_map_bor_level(slots: int, n_rows: int, row_bytes: int,
                       visited_read: int,
                       visited_written: int) -> Tuple[int, int]:
    """``edge_map_bor_level``, one call (a bit-BFS level): ``(table once,
    gathered rows)`` of :func:`edge_map_bor`, each with the bytes of
    ``visited`` that the level needs besides: ``visited_read`` where the
    OR has a bit (elsewhere the next frontier is 0 whatever ``visited``
    holds) and ``visited_written`` where the next frontier has one, as the
    level's OR and next frontier count them (``scripts/probe_edge_map.py``:
    the 16-byte pieces, a lane's, with a bit)."""
    table, gathered = edge_map_bor(slots, n_rows, row_bytes)
    visited = visited_read + visited_written
    return table + visited, gathered + visited


def bit_popstats(n_rows: int, lanes: int, plane_bytes: int) -> int:
    """``bit_popstats``: the [n_rows, lanes] plane of ``plane_bytes``-byte
    lanes and the 4-byte degrees once, and the two int64 outputs of
    ``lanes * 8 * plane_bytes`` instances each."""
    row_bytes = lanes * plane_bytes
    return n_rows * row_bytes + 4 * n_rows + 2 * 8 * 8 * row_bytes


def triangle_search(n_nodes: int, dag_edges: int, anchor_slots: int,
                    anchor_row_slots: int) -> Tuple[int, int]:
    """``triangle_search``, one call: ``(the DAG once, each anchor's row
    once)``.  The first reads the ``n_nodes + 1`` row offsets and the
    ``dag_edges`` row entries once; the second, for each of the
    ``anchor_slots`` slots that anchor a wedge, its row b's two bounds and
    its ``anchor_row_slots`` entries (summed over those slots), as a search
    that reads each anchor's row b once and no row again must."""
    return (4 * (n_nodes + 1) + 4 * dag_edges,
            8 * anchor_slots + 4 * anchor_row_slots)
