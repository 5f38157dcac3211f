"""Device idle time inside the program's ``gm:setup`` spans (a model
call's work before its loop: scalars uploaded, initial state, gathers of
per-call inputs) over the traced window, in %."""

from gmbench.metrics._program_idle import share


def read(rec):
    return share(rec, "gm:setup")
