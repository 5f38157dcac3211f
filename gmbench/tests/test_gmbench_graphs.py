"""The generators' counts and rules, and the traffic plan's roots."""

import pytest
import torch

from gmbench import draw, spec

LJ = dict(spec.load_json("configs", "lj"), nodes=3000, edges=20000)
G5 = dict(spec.load_json("configs", "g500s24"), scale=10)
BIG_SEED = 2**31 + 12345


def _draw(cfg, seed):
    return spec.load_module("graphs", cfg["generator"]).draw(cfg, seed, "cpu")


def test_rmat_counts_and_rules():
    e = _draw(LJ, BIG_SEED)
    assert e.num_nodes == 3000 and e.num_edges == 20000
    assert e.src.dtype == e.dst.dtype == e.lens.dtype == torch.int32
    assert 0 <= int(e.src.min()) and int(e.src.max()) < 3000
    assert 0 <= int(e.dst.min()) and int(e.dst.max()) < 3000
    assert not (e.src == e.dst).any()               # self-loops drawn again
    assert 1 <= int(e.lens.min()) and int(e.lens.max()) <= 100
    deg = torch.bincount(e.src, minlength=3000)
    assert int(deg.max()) > 20 * 20000 // 3000      # skewed, not uniform


def test_kronecker_counts_and_rules():
    e = _draw(G5, BIG_SEED)
    m = 16 * 1024
    assert e.num_nodes == 1024 and e.num_edges == 2 * m
    assert torch.equal(e.src[m:], e.dst[:m])        # stored both ways
    assert torch.equal(e.dst[m:], e.src[:m])
    assert torch.equal(e.lens[m:], e.lens[:m])
    assert int(e.src.max()) < 1024 and int(e.src.min()) >= 0
    assert int(e.lens.min()) >= 1 and int(e.lens.max()) <= 2**24
    assert (e.src == e.dst).any()                   # self-loops kept
    assert int(e.lens.max()) > 2**23                # the range is used


@pytest.mark.parametrize("cfg", [LJ, G5], ids=["rmat", "kronecker"])
def test_same_seed_same_graph(cfg):
    a, b, c = _draw(cfg, 77), _draw(cfg, 77), _draw(cfg, 78)
    for f in ("src", "dst", "lens"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.src, c.src)
    # the same graph up to its labels: the same sorted degrees
    for f in ("src", "dst"):
        deg = lambda e: torch.bincount(getattr(e, f), minlength=e.num_nodes)
        assert torch.equal(deg(a).sort().values, deg(c).sort().values)
    assert torch.equal(a.lens, c.lens)      # lengths go with the structure


def test_stream_seeds_differ_and_fit():
    seeds = {draw.stream_seed(s, k) for s in (0, 1, BIG_SEED, 2**40)
             for k in ("graph", "labels", "lengths", "traffic")}
    assert len(seeds) == 16 and all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize("name", ["reference_apps", "graph500_kernels"])
def test_plan_roots_kinds_and_checks(name):
    traffic = dict(spec.load_json("traffic", name), queries=768)
    deg = torch.zeros(500, dtype=torch.int32)
    deg[::7] = 3
    labels = torch.arange(500, dtype=torch.int32)
    p = draw.plan(traffic, deg, labels, 1, BIG_SEED)
    kinds = [k["kind"] for k in traffic["kinds"]]
    count = traffic["roots"]["count"]
    assert len(p.kinds) == len(p.roots) == len(p.checked) == 768
    assert all(deg[r] >= 1 for r in p.roots + [r for _, r in p.warmup])
    assert [k for k, _ in p.warmup] == kinds * traffic["warmup"]
    for k in kinds:
        assert p.kinds.count(k) == 768 // len(kinds)
        assert p.checked[p.kinds.index(k)]           # first of each kind
        mine = [r for kk, r in zip(p.kinds, p.roots) if kk == k]
        assert len(set(mine[:count])) == count        # each root once a cycle
        assert mine[count:2 * count] == mine[:count]
    if traffic["order"] == "alternating":
        assert p.kinds[:4] == (kinds * 2)[:4]
    else:   # every block of len(kinds) holds each kind once
        for b in range(0, 768, len(kinds)):
            assert sorted(p.kinds[b:b + len(kinds)]) == sorted(kinds)
        assert p.kinds[:30] != (kinds * 10)[:30]
    assert 0 < sum(p.checked) <= traffic["check"]["max"]
    again = draw.plan(traffic, deg, labels, 1, BIG_SEED)
    assert (again.kinds, again.roots, again.checked) == \
        (p.kinds, p.roots, p.checked)


def test_every_seed_has_the_same_root_set_under_its_labels():
    """The roots are drawn in the structure's ids: relabelled by a seed's
    permutation, the set is the same nodes of the structure."""
    rule = {"min_out_degree": 1, "count": 16}
    deg = torch.zeros(400, dtype=torch.int32)
    deg[::3] = 2
    base = set(draw.root_set(rule, deg, torch.arange(400), 5))
    perm = torch.randperm(400, generator=torch.Generator().manual_seed(3))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(400)
    got = draw.root_set(rule, deg.index_select(0, inv), perm, 5)
    assert {int(inv[r]) for r in got} == base and len(base) == 16
