"""Device kernels by group, by name and by the operator that launched them.

Frozen from ``green_marl_tpu_torch/probes/profile_apps.py`` (``GROUPS``,
``group_of``): PyTorch runs ``index_select``, ``gather`` and the
``scatter`` family through one device kernel
(``_scatter_gather_elementwise_kernel``), so that kernel goes by the
operator that launched it.
"""

from __future__ import annotations

GATHERS, SCATTERS = "gathers", "scatters"
SHARED = "scatter_gather"     # in the name of torch's kernel for both kinds
UNSPLIT = "gathers or scatters"
GATHER_KEYS = ("indexselect", "index_select", "gather", "take")
SCATTER_KEYS = ("scatter", "index_put", "indexput", "index_copy",
                "index_add", "indexfuncsmall", "indexfunclarge")

# (group, substrings of the kernel's name, lower case); the first match wins
GROUPS = (
    ("segment reduce", ("segment_reduce_kernel", "segment_reduce_lanes_kernel",
                        "tile_rows_kernel")),
    ("prefix sum", ("scan_kernel",)),
    ("copies and memsets", ("memcpy", "memset")),
    (GATHERS, GATHER_KEYS),
    (SCATTERS, SCATTER_KEYS),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "fill", "arange",
                     "where")),
)


def group_of(kernel_name: str, op_name: str = "") -> str:
    """The group of a device kernel (``other`` if none)."""
    low = kernel_name.lower()
    if SHARED in low:
        op = op_name.lower()
        if any(k in op for k in SCATTER_KEYS):
            return SCATTERS
        if any(k in op for k in GATHER_KEYS):
            return GATHERS
        return UNSPLIT
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"
