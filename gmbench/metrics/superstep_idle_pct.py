"""Device idle time inside the program's ``gm:superstep`` spans (each pass
of a superstep loop: the predicate read, then the step's launches) over
the traced window, in %: the device drained by the read and waiting for
the host to queue the next step, or running short kernels faster than the
host queues them."""

from gmbench.metrics._program_idle import share


def read(rec):
    return share(rec, "gm:superstep")
