"""The least bytes a batched edge map (``ops/binned.py`` ``edge_map``)
moves, from the shapes its counter gives (``binned.edge_map_counts()``):
each slot's 4-byte id read once, the node table read once and the output
table written once (``n_rows`` x a row's bytes each), however the gather
and the fold are implemented.  Per-slot values (``slot_vals``), which the
bit BFS has none of, are not counted, so the count stays a lower bound."""

from __future__ import annotations

from typing import Optional


def edge_map_bytes(counts: dict) -> int:
    """The bytes of the calls ``counts`` sums."""
    return 4 * counts["slots"] + 2 * counts["table_bytes"]


def per_call() -> Optional[float]:
    """The mean bytes of the process's edge-map calls so far; None where
    the program has no counter or made no call."""
    from green_marl_tpu_torch.ops import binned
    counts_of = getattr(binned, "edge_map_counts", None)
    counts = counts_of() if counts_of is not None else None
    if not counts or not counts.get("calls"):
        return None
    return edge_map_bytes(counts) / counts["calls"]
