"""``segment_reduce_sorted``'s share of its memory bound, in %: the bytes
of every launch in the traced window (``_roofline.segment_reduce_bytes``
of its arguments) over 3.35 TB/s, divided by the device time of all it
launched (the status clear, the row bounds, the tiles)."""

from gmbench.metrics._bound_share import share


def read(rec):
    return share(rec, "segment_reduce_sorted")
