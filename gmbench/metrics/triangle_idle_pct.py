"""Device idle time inside the program's ``gm:triangle:count`` spans (one
a ``count_dag`` call: the row bound read, then the search's chunks, then
the count read) over the traced window, in %: the device waiting for the
host to queue the search's passes.  None without such spans."""

from gmbench.metrics._program_idle import share


def read(rec):
    return share(rec, "gm:triangle:count")
