"""Idle time of the traced window under the program's own spans.

The port opens ``gm:`` spans inside a call (``green_marl_tpu_torch/utils/
timing.py`` ``span``): ``gm:setup`` around a model call's work before its
loop, ``gm:superstep`` around each pass of a superstep loop (nested where
loops nest), ``gm:sync:<site>`` around each host wait.  An idle gap of the
device is put down to a span when its midpoint falls inside one, as
``Trace.idle_gaps`` does for the benchmark's spans.  A program without
these spans gives None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def gaps(tr) -> List[Tuple[int, int]]:
    """The window's idle gaps: what the union of activities leaves."""
    lo, hi = tr.window
    out, t = [], lo
    for s, e in tr.busy + [(hi, hi)]:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    return out


def _union(ranges) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def share(rec, name: str) -> Optional[float]:
    """100 x idle seconds whose gap's midpoint lies inside a span named
    ``name`` / the window's seconds; None without device activity or
    without such a span."""
    tr = rec.trace
    if tr is None or not tr.activities:
        return None
    ranges = _union((s, e) for s, e, n in tr.spans if n == name)
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    idle = 0
    for s, e in gaps(tr):
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and ranges[i][1] >= mid:
            idle += e - s
    return 100.0 * idle / 1e9 / tr.window_s
