"""Metric readers, one file each, found by the metric's name in
``BENCHMARK.json``.  A reader has ``read(record) -> float | None``
(``gmbench.cell.Record``): end-to-end metrics read the window's host
clocks and the memory peak, per-layer metrics the trace of a ``--trace 1``
run.  A reader that finds nothing to read returns None and the metric is
left out of the line.

``_roofline`` and ``_groups`` are frozen copies of the program's own
yardsticks (``probes/segment.py``'s bound arithmetic, ``probes/
profile_apps.py``'s kernel groups), kept here so that a change to the
program cannot move them.
"""
