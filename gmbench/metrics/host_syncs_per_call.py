"""Host waits for the device a query: the program's ``gm:sync:<site>``
spans (a predicate read, a scalar upload from pageable memory, BFS's
direction and reached reads) that start in the traced window, over the
calls in it.  None without device activity or without such spans."""

SYNC = "gm:sync:"


def read(rec):
    tr = rec.trace
    if tr is None or not tr.activities or not rec.latencies_s:
        return None
    lo, hi = tr.window
    syncs = sum(n.startswith(SYNC) and lo <= s <= hi for s, _, n in tr.spans)
    return syncs / len(rec.latencies_s) if syncs else None
