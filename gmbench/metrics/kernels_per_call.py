"""Device kernels (copies and memsets left out) in the traced window over
the calls into the program in it."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.latencies_s:
        return None
    kernels = sum(a.kind == "kernel" for a in tr.activities)
    return kernels / len(rec.latencies_s) if kernels else None
