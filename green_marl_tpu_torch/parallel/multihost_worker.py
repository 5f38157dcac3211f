"""One process of a multi-process vertex-sharded PageRank.

    python -m green_marl_tpu_torch.parallel.multihost_worker PID NPROCS PORT

Runs ``pagerank_vsharded`` (e=1e-9, d=0.85, 30 iterations) on a 400-node
RMAT graph (seed 7) over a mesh of NPROCS processes with two CPU shards
each, joined by gloo at ``127.0.0.1:PORT``; each process prints one line
``MH pid=<pid> it=<iterations> base=<first owned node> local=[...]`` with
every rank its shards own, in node order.
"""

import sys


def main(argv=None):
    pid, nprocs, port = (int(x) for x in (argv or sys.argv[1:])[:3])
    from . import multihost as mh
    mh.init(f"127.0.0.1:{port}", nprocs, pid, local_cpu_devices=2)
    try:
        from ..graph import generate as gen
        from ..graph.csr import from_edges
        from . import vertex_sharded as V

        src, dst = gen.rmat_edges(400, 3000, seed=7)
        g, _ = from_edges(src, dst, 400)
        mesh = mh.global_mesh()
        vsg = mh.place_multihost(V.build_vertex_sharded(g, mesh.size), mesh)
        rank, _, it = V.pagerank_vsharded(vsg, mesh, e=1e-9, d=0.85,
                                          max_iter=30)
        # the process's own rows, in the order of its shards
        first_owned = mesh.local_positions[0] * vsg.L
        vals = " ".join(f"{x:.10e}" for x in rank.tolist())
        print(f"MH pid={pid} it={it} base={first_owned} local=[{vals}]",
              flush=True)
    finally:
        mh.shutdown()


if __name__ == "__main__":
    main()
