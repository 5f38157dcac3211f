"""``gm_format_converter`` equivalent: text graph + schema -> binary.

Mirrors ``apps/output_cpp/gm_graph/src/gm_format_converter.cc`` — the
tool that produced ``soc-LiveJournal1.bin`` from the SNAP edge list
(reference ``README.md:28-33``)::

    python -m green_marl_tpu_torch.cli.format_converter in.txt out.bin schema \
        -GMInputFormat=EDGE [-GMOutputFormat=EBIN]

Schema file format (``gm_format_converter.cc:8-37``)::

    NODE: <type> <type> ...
    EDGE: <type> ...

with types in {bool,int,long,float,double,node,edge}; both lines
optional (empty schema = plain graph).

Counterpart of ``green_marl_tpu/cli/format_converter.py`` over the port's
own graph modules: the same bytes out, all of the work on the host.
"""

import sys
from typing import List, Tuple

from ..graph import binary_io as bio
from ..graph import edge_list as el
from ..graph.csr import from_edges
from .useropt import UserOpt

_NAME_TO_TYPE = {
    "bool": bio.GMTYPE_BOOL, "int": bio.GMTYPE_INT,
    "long": bio.GMTYPE_LONG, "float": bio.GMTYPE_FLOAT,
    "double": bio.GMTYPE_DOUBLE, "node": bio.GMTYPE_NODE,
    "edge": bio.GMTYPE_EDGE,
}


def parse_schema(path: str) -> Tuple[List[int], List[int]]:
    nprops: List[int] = []
    eprops: List[int] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(":")
            types = [_NAME_TO_TYPE[t.lower()] for t in rest.split()]
            if key.strip().upper() == "NODE":
                nprops = types
            elif key.strip().upper() == "EDGE":
                eprops = types
            else:
                raise ValueError(f"bad schema line: {line}")
    return nprops, eprops


def main(argv=None) -> int:
    O = UserOpt("gm_format_converter", __doc__)
    O.add_option("GMInputFormat", str, "EDGE", "EDGE|ADJ")
    O.add_option("GMOutputFormat", str, None,
                 "BIN|EBIN (default: EBIN when schema has properties)")
    O.add_argument("InputName", "input text graph")
    O.add_argument("OutputName", "output binary")
    O.add_argument("SchemaName", "[optional] schema file")
    if not O.parse(list(sys.argv[1:] if argv is None else argv)):
        return 1
    if O.num_args < 2:
        O.print_help()
        return 1
    inp, out = O.get_arg(0), O.get_arg(1)
    nprops, eprops = ([], [])
    if O.get_arg(2):
        nprops, eprops = parse_schema(O.get_arg(2))

    fmt = O.get_option("GMInputFormat").upper()
    if fmt == "EDGE":
        res = el.load_edge_list(inp, nprops, eprops)
        g, eprop_arrays = res.freeze()
        nodekey = res.nodekey
        nprop_arrays = res.node_props
    elif fmt == "ADJ":
        src, dst = el.load_adjacency_list(inp)
        g, _ = from_edges(src, dst)
        nodekey, nprop_arrays, eprop_arrays = None, [], []
    else:
        print(f"unknown input format {fmt}", file=sys.stderr)
        return 1

    out_fmt = O.get_option("GMOutputFormat")
    extended = (out_fmt or "").upper() == "EBIN" or (
        out_fmt is None and (nprop_arrays or eprop_arrays
                             or nodekey is not None))
    begin = g.begin.numpy()
    node_idx = g.node_idx[: g.num_edges].numpy()
    if extended:
        bio.store_binary(out, begin, node_idx, nodekey=nodekey,
                         node_props=list(nprop_arrays),
                         edge_props=list(eprop_arrays), extended=True)
    else:
        bio.store_binary(out, begin, node_idx)
    print(f"converted {inp} ({fmt}) -> {out} "
          f"(N={g.num_nodes} M={g.num_edges} extended={extended})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
