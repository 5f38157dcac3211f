"""Each reference against the port at a small size on the CPU, on the
benchmark's own graphs."""

import pytest
import torch

from gmbench import csr, spec
from gmbench.reference import bfs, pagerank, sssp
from green_marl_tpu_torch.models import bfs as port_bfs
from green_marl_tpu_torch.models import hop_dist as port_hop
from green_marl_tpu_torch.models import pagerank as port_pr
from green_marl_tpu_torch.models import sssp as port_sssp

CFGS = {"lj": dict(spec.load_json("configs", "lj"), nodes=2000, edges=16000),
        "g500s24": dict(spec.load_json("configs", "g500s24"), scale=10)}


@pytest.fixture(scope="module", params=sorted(CFGS))
def graph(request):
    cfg = CFGS[request.param]
    e = spec.load_module("graphs", cfg["generator"]).draw(cfg, 5, "cpu")
    g, (w,) = csr.build(e.src, e.dst, e.num_nodes, [e.lens])
    roots = torch.nonzero(g.begin.diff() > 0).flatten()[:4].tolist()
    return e, g, w, roots


def test_pagerank(graph):
    e, g, _, _ = graph
    res = port_pr.pagerank(g)
    ranks, diffs = pagerank.pagerank(e.src, e.dst, e.num_nodes, 0.001, 0.85,
                                     [res.iterations])
    want = ranks[res.iterations]
    got = res.rank[:e.num_nodes].double()
    assert float(((got - want).abs() / want).max()) < 1e-5
    assert pagerank.admissible(res.iterations, diffs, 0.001, 100, 0.01)
    assert not pagerank.admissible(res.iterations + 1, diffs, 0.001, 100,
                                   0.01)


def test_levels(graph):
    e, g, _, roots = graph
    for r in roots:
        want = bfs.levels(e.src, e.dst, e.num_nodes, r)
        lv = port_bfs.bfs(g, r).level[:e.num_nodes].long()
        assert torch.equal(lv, want)
        hop = port_hop.hop_dist(g, r).dist[:e.num_nodes].long()
        hop[hop == 2**31 - 1] = -1
        assert torch.equal(hop, want)


def test_sssp(graph):
    e, g, w, roots = graph
    for r in roots:
        want = sssp.distances(e.src, e.dst, e.lens, e.num_nodes, r)
        got = port_sssp.sssp(g, r, w).dist[:e.num_nodes].long()
        got[got == 2**31 - 1] = sssp.UNREACHED
        assert torch.equal(got, want)


def test_stop_rule():
    diffs = [0.5, 0.01, 0.001005, 0.0005]
    assert pagerank.admissible(3, diffs, 0.001, 100, 0.01)   # within 1%
    assert pagerank.admissible(4, diffs, 0.001, 100, 0.01)
    assert not pagerank.admissible(2, diffs, 0.001, 100, 0.01)
    assert pagerank.admissible(2, diffs, 0.001, 2, 0.01)      # the cap
