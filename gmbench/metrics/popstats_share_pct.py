"""Device time launched inside the program's ``gm:popstats`` spans (the
bit BFS's final per-instance counts over its visited planes) over the
device's busy time in the traced window, in %.  None without such
spans."""


def read(rec):
    tr = rec.trace
    if tr is None or not any(n == "gm:popstats" for _, _, n in tr.spans):
        return None
    busy = tr.busy_s()
    if not busy:
        return None
    seconds = sum(a.end - a.start for a in tr.under("gm:popstats")) / 1e9
    return 100.0 * seconds / busy
