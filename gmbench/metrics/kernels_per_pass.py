"""Device kernels (copies and memsets left out) launched inside the
program's ``gm:lower:pass`` spans, over the number of those spans: the
launches of one pass of a compiled ``While``, every lane at once.  A
kernel launched inside nested spans counts once.  None without such
spans or without device activity."""

import bisect

from gmbench.metrics._program_idle import _union

SPAN = "gm:lower:pass"


def read(rec):
    tr = rec.trace
    if tr is None or not tr.activities:
        return None
    passes = sum(n == SPAN for _, _, n in tr.spans)
    if not passes:
        return None
    ranges = _union((s, e) for s, e, n in tr.spans if n == SPAN)
    starts = [s for s, _ in ranges]
    kernels = 0
    for a in tr.activities:
        i = bisect.bisect_right(starts, a.launched) - 1
        kernels += (a.kind == "kernel" and i >= 0
                    and a.launched <= ranges[i][1])
    return kernels / passes
