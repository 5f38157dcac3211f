"""``segment_reduce_sorted``'s share of its memory bound in the lockstep
cell, in %: the bytes of every launch in the traced window
(``_roofline.segment_reduce_bytes`` with the launch's lanes: a
lane-batched launch reads [16, E_pad] values and writes [16, n_pad] rows)
over 3.35 TB/s, divided by the device time of all it launched.  Besides
its lane-batched launches, pagerank.gm makes one 1-D launch a call for
its first pass, which no lane value enters yet."""

from gmbench.metrics._bound_share import share


def read(rec):
    return share(rec, "segment_reduce_sorted")
