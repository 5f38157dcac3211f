"""100 x (1 - the union of kernel, copy and memset intervals / the traced
window)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.activities:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
