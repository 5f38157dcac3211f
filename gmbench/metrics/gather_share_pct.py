"""Device time of the gathers (torch's ``index_select`` and ``gather``
kernels, wherever they launch) over the device's busy time, in %."""

from gmbench.metrics import _groups


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    busy = tr.busy_s()
    if not busy:
        return None
    gathers = sum(a.end - a.start for a in tr.activities
                  if _groups.group_of(a.name, a.launcher) == _groups.GATHERS)
    return 100.0 * gathers / 1e9 / busy
