"""Seconds from the start of the benchmark's process to its first timed
call: imports, the graph drawn and built on the card, the kernels loaded
(built on a checkout's first run), the plan drawn, each kind warmed."""


def read(rec):
    return rec.setup_s
