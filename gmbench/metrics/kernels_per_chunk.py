"""Device kernels (copies and memsets left out) launched inside the
program's ``gm:triangle:chunk`` spans, over the number of those spans: the
launches of one chunk of the wedge search (its decode and its bisection
passes).  None without such spans or without device activity."""

SPAN = "gm:triangle:chunk"


def read(rec):
    tr = rec.trace
    if tr is None or not tr.activities:
        return None
    chunks = sum(n == SPAN for _, _, n in tr.spans)
    if not chunks:
        return None
    return sum(a.kind == "kernel" for a in tr.under(SPAN)) / chunks
