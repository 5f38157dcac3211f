"""The wedge search's rate in Gwedges/s: the traced window's
``gm:triangle:count`` spans (one a ``count_dag`` call, opened by the
program) times the wedges a call tests (``models.triangle.search_counts()``:
its wedges over its calls, summed over the process's searches; every call
of a cell counts one DAG), over the device time of the kernels launched
inside those spans.  None without such spans, without the counter, or
where it counted no search."""

SPAN = "gm:triangle:count"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    calls = sum(n == SPAN for _, _, n in tr.spans)
    if not calls:
        return None
    from green_marl_tpu_torch.models import triangle
    counts_of = getattr(triangle, "search_counts", None)
    counts = counts_of() if counts_of is not None else None
    if not counts or not counts.get("calls"):
        return None
    seconds = sum(a.end - a.start for a in tr.under(SPAN)
                  if a.kind == "kernel") / 1e9
    if not seconds:
        return None
    return calls * counts["wedges"] / counts["calls"] / seconds / 1e9
