"""Peaks of the card and the bytes each kernel of the port must move.

Frozen from ``green_marl_tpu_torch/probes/segment.py`` (``HBM_BYTES_PER_MS``
and ``time_all``'s byte counts): each input read once, each output written
once.  A share of the bound is ``bytes / HBM_BYTES_PER_S / device seconds``.
"""

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet (80 GB HBM3), at 700 W


def segment_reduce_bytes(vals_numel: int, offsets_numel: int, n_out: int,
                         lanes: int, itemsize: int = 4) -> int:
    """``segment_reduce_sorted``: the values, the offsets (int32) and the
    output rows of every lane (``4*e_pad + 4*offsets + 4*n_pad`` in 1-D)."""
    return itemsize * vals_numel + 4 * offsets_numel + itemsize * n_out * lanes


def cumsum_bytes(n: int, lanes: int, exclusive: bool,
                 itemsize: int = 4) -> int:
    """``plain_cumsum``: ``n`` values read and ``n`` (``n + 1`` exclusive)
    written, per lane."""
    return itemsize * lanes * (2 * n + int(exclusive))
