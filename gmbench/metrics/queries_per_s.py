"""Queries completed in the window over the window's length, which runs
until the last call ends (host clock)."""


def read(rec):
    return len(rec.latencies_s) / rec.window_s if rec.latencies_s else None
