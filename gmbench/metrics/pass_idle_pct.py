"""Device idle time inside the program's ``gm:lower:pass`` spans (each
pass of a compiled ``While``: the body's launches, then the predicate
read) over the traced window, in %: the device drained by the read and
waiting for the host to queue the next pass, or running short kernels
faster than the lowerer queues them.  None without such spans."""

from gmbench.metrics._program_idle import share


def read(rec):
    return share(rec, "gm:lower:pass")
