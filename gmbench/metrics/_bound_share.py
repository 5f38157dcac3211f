"""A kernel wrapper's share of its memory bound over the traced window."""

from gmbench.metrics import _roofline


def share(rec, wrapper: str):
    """100 x (bytes its launches must move / HBM bandwidth) / device
    seconds of everything launched inside them; None without launches."""
    tr = rec.trace
    if tr is None or not tr.launch_bytes.get(wrapper):
        return None
    acts = tr.under(f"gm:{wrapper}")
    seconds = sum(a.end - a.start for a in acts) / 1e9
    if not seconds:
        return None
    return 100.0 * tr.launch_bytes[wrapper] / _roofline.HBM_BYTES_PER_S / seconds
