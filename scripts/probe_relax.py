#!/usr/bin/env python3
"""Time the relax step of hop_dist and sssp (``models/relax.py``) on an
NVIDIA GPU, at the shapes of the benchmark's graphs.

The graphs are the benchmark's configurations ``lj`` (soc-LiveJournal1's
sizes) and ``g500s24`` (Graph500 scale 24 stored both ways), drawn and
built on the card by the benchmark's own builders (``gmbench/configs``,
``gmbench/graphs``, ``gmbench/csr.py``), so that the step is timed on the
layout the benchmark measures.  From one seeded root with an out-edge it
runs hop_dist (unit weights) and sssp (the configuration's lengths)
superstep by superstep, and at each superstep holds the segment reduce's
gather form (one launch) against the five launches it replaced (two
``index_select``, the add, ``where``, the plain segment min) bit for bit,
times both (``utils.timing.kernel_ms``), and reports the share of the
real CSC slots whose source is updated.  The bound of a step is
``probes/bounds.py`` ``relax``: the ids (and the weights) of the slots in
range once, the offsets, the rows out, and ``dist`` and ``updated`` once
each.  Then one call of each model, its launches and its time.  One JSON
record a line.

Run from the root of a checkout::

    python3 scripts/probe_relax.py [--root DIR]

``--root DIR`` takes the port's package from another checkout (``DIR``
holds ``green_marl_tpu_torch/``), the graphs still from this one's
``gmbench/``.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("lj", "g500s24")           # gmbench/configs/<name>.json
SEED = 20260418                      # the labels of the graphs and the root
CALLS, GROUPS = 3, 3                 # a superstep of g500s24 takes ~2-14 ms


def relax_run(torch, K, record, g, root, weights, what):
    """hop_dist (``weights`` None) or sssp from ``root`` superstep by
    superstep: the gather form against the five launches it replaced, bit
    for bit, each timed; the share of real slots whose source is set."""
    from green_marl_tpu_torch.probes import bounds
    from green_marl_tpu_torch.utils.timing import kernel_ms
    ids, dst, off, n_pad = g.r_node_idx, g.r_node_idx_dst, g.r_begin, g.n_pad
    inf = torch.tensor(torch.iinfo(torch.int32).max, dtype=torch.int32,
                       device=ids.device)
    w = weights if weights is not None else torch.ones_like(inf)
    dist = torch.full((n_pad,), int(inf), dtype=torch.int32,
                      device=ids.device)
    dist[root] = 0
    updated = torch.zeros(n_pad, dtype=torch.bool, device=ids.device)
    updated[root] = True

    def fused():
        return K.segment_reduce_sorted(ids, dst, off, n_pad, "min",
                                       node_vals=dist, node_mask=updated,
                                       add=weights)

    def five():
        cand = torch.where(updated.index_select(0, ids),
                           dist.index_select(0, ids) + w, inf)
        return K.segment_reduce_sorted(cand, dst, off, n_pad, "min")

    steps = []
    while bool(updated.any()):
        best = fused()
        if not torch.equal(best, five()):
            raise SystemExit(f"probe_relax: {what} superstep {len(steps)}: "
                             "the gather form differs from the five launches")
        share = float(updated.index_select(0, ids[:g.num_edges])
                      .float().mean())
        f_ms = kernel_ms(fused, CALLS, GROUPS)[0]
        p_ms = kernel_ms(five, CALLS, GROUPS)[0]
        steps.append((share, f_ms, p_ms))
        new = torch.minimum(dist, best)
        updated = new < dist
        dist = new
    nbytes = bounds.relax(int(off[-1]) - int(off[0]), off.numel(), n_pad,
                          weights is not None)
    bound = bounds.bound_ms(nbytes)
    fused_ms = sum(f for _, f, _ in steps)
    five_ms = sum(p for _, _, p in steps)
    record(what=f"relax {what}", ok=True, root=root, supersteps=len(steps),
           set_share=[round(x, 6) for x, _, _ in steps],
           fused_ms=[round(f, 4) for _, f, _ in steps],
           five_ms=[round(p, 4) for _, _, p in steps],
           fused_ms_sum=fused_ms, five_ms_sum=five_ms,
           bound_ms_step=bound, bytes_step=nbytes,
           bound_share=bound * len(steps) / fused_ms)
    return dist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_relax: needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.append(REPO)                                  # gmbench/
    from gmbench import csr as bench_csr
    from green_marl_tpu_torch.models import hop_dist, sssp
    from green_marl_tpu_torch.ops import kernels as K
    from green_marl_tpu_torch.utils.timing import card as card_of
    from green_marl_tpu_torch.utils.timing import timed

    dev = torch.device("cuda")
    card = card_of(dev)

    def record(**kw):
        print(json.dumps({"root": args.root, "card": card, **kw}),
              flush=True)

    for name in SHAPES:
        with open(os.path.join(REPO, "gmbench", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        gen = __import__(f"gmbench.graphs.{cfg['generator']}",
                         fromlist=["draw"])
        edges = gen.draw(cfg, SEED, dev)
        g, (lens,) = bench_csr.build(edges.src, edges.dst, edges.num_nodes,
                                     [edges.lens])
        del edges
        starts = torch.nonzero(g.begin.diff() > 0).flatten()
        pick = torch.Generator().manual_seed(SEED)
        root = int(starts[int(torch.randint(starts.numel(), (1,),
                                            generator=pick))])
        record(what=f"relax {name}: graph", n=g.num_nodes, e=g.num_edges,
               e_pad=g.e_pad, n_pad=g.n_pad,
               max_in_degree=int(g.r_begin.diff().max()))
        weights = lens.index_select(0, g.e_rev2idx)        # CSC order
        for kind, wt, model in (
                ("hop_dist", None, lambda: hop_dist.hop_dist(g, root)),
                ("sssp", weights, lambda: sssp.sssp(g, root, lens))):
            dist = relax_run(torch, K, record, g, root, wt, f"{name} {kind}")
            model()                                        # warm
            before = K.launch_counts()
            res, _, ms = timed(model, dev)
            counts = K.launch_counts()
            record(what=f"relax {name} {kind}: model",
                   ms=ms, iterations=res.iterations,
                   gather_launches=counts["segment_reduce_sorted[gather]"]
                   - before["segment_reduce_sorted[gather]"],
                   launches=counts["segment_reduce_sorted"]
                   - before["segment_reduce_sorted"],
                   equal_to_steps=bool(torch.equal(res.dist, dist)))
        del g, lens, weights, dist
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
