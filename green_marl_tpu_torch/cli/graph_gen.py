"""``graph_gen`` CLI: synthetic graph generator.

Mirrors the reference tool (``apps/output_cpp/gm_graph/src/
graph_gen_main.cc``): uniform or RMAT, fixed seed, binary output.

    python -m green_marl_tpu_torch.cli.graph_gen N M out.bin \
        [-type=uniform|rmat|uniform_nonmulti] [-seed=0] \
        [-a=0.45 -b=0.22 -c=0.22] [-nopermute]

Counterpart of ``green_marl_tpu/cli/graph_gen.py`` over the port's
own graph modules: the same bytes out, all of the work on the host.
"""

import sys

from ..graph import binary_io as bio
from ..graph import generate as gen
from ..graph.csr import from_edges
from .useropt import UserOpt


def main(argv=None) -> int:
    O = UserOpt("graph_gen", __doc__)
    O.add_option("type", str, "uniform", "uniform|rmat|uniform_nonmulti")
    O.add_option("seed", int, "0", "RNG seed")
    O.add_option("a", float, "0.45", "RMAT a")
    O.add_option("b", float, "0.22", "RMAT b")
    O.add_option("c", float, "0.22", "RMAT c")
    O.add_option("nopermute", bool, "0", "RMAT: skip vertex permutation")
    O.add_argument("N", "number of nodes")
    O.add_argument("M", "number of edges")
    O.add_argument("OutputName", "output .bin path")
    if not O.parse(list(sys.argv[1:] if argv is None else argv)):
        return 1
    if O.num_args < 3:
        O.print_help()
        return 1
    n, m, out = int(O.get_arg(0)), int(O.get_arg(1)), O.get_arg(2)
    kind = O.get_option("type")
    seed = O.get_option("seed")
    if kind == "uniform":
        src, dst = gen.uniform_random_edges(n, m, seed)
    elif kind == "uniform_nonmulti":
        src, dst = gen.uniform_random_nonmulti_edges(n, m, seed)
    elif kind == "rmat":
        src, dst = gen.rmat_edges(
            n, m, seed, O.get_option("a"), O.get_option("b"),
            O.get_option("c"), permute=not O.get_option("nopermute"))
    else:
        print(f"unknown -type={kind}", file=sys.stderr)
        return 1
    g, _ = from_edges(src, dst, n)
    begin = g.begin.numpy()
    node_idx = g.node_idx[: g.num_edges].numpy()
    bio.store_binary(out, begin, node_idx)
    print(f"generated {kind} graph: N={n} M={m} seed={seed} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
