"""``plain_cumsum``'s share of its memory bound, in %: the bytes of every
launch in the traced window (``_roofline.cumsum_bytes``) over 3.35 TB/s,
divided by the device time of all it launched."""

from gmbench.metrics._bound_share import share


def read(rec):
    return share(rec, "plain_cumsum")
