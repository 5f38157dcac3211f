"""The batched edge map's share of its memory bound, in %: its calls in
the traced window (``gm:edge_map`` spans, opened by the program) times
the least bytes a call moves (``_edge_map_bytes``, from the program's
counter; every call of a cell has one shape), over 3.35 TB/s, divided
by the device time of everything launched inside those spans.  None
without such spans."""

from gmbench.metrics import _edge_map_bytes, _roofline

SPAN = "gm:edge_map"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    calls = sum(n == SPAN for _, _, n in tr.spans)
    if not calls:
        return None
    per_call = _edge_map_bytes.per_call()
    seconds = sum(a.end - a.start for a in tr.under(SPAN)) / 1e9
    if per_call is None or not seconds:
        return None
    return 100.0 * calls * per_call / _roofline.HBM_BYTES_PER_S / seconds
