"""The share of lane passes a lockstep call needed, in %: 100 x
``lanes_live`` / ``lanes_computed`` of the program's counter
(``green_marl_tpu_torch.lang.lower.lane_pass_counts()``, summed over the
process's calls): each pass of a compiled ``While`` whose predicate is a
lane value computes every lane, and only the lanes whose predicate held
needed it; a stopped lane keeps its state.  None where the program has no
such counter or ran no such pass."""


def read(rec):
    from green_marl_tpu_torch.lang import lower
    counts_of = getattr(lower, "lane_pass_counts", None)
    counts = counts_of() if counts_of is not None else None
    if not counts or not counts.get("lanes_computed"):
        return None
    return 100.0 * counts["lanes_live"] / counts["lanes_computed"]
