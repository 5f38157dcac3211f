"""The program's profiler spans (``utils.timing.span``) on the four query
kinds of the benchmark: ``gm:setup`` once a call, ``gm:superstep`` once a
pass of the host loop, ``gm:sync:<site>`` around each host wait, each as
many times as the loop's iteration count fixes; nothing recorded and
``record_function`` never called with no profiler running.

The ``cuda`` test holds every synchronizing op on the four paths against a
``gm:sync:*`` span on the card (``torch.cuda.set_sync_debug_mode``).  This
file imports neither JAX nor ``green_marl_tpu``::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_spans.py
"""

import collections
import os
import traceback
import warnings

import numpy as np
import pytest
import torch

from green_marl_tpu_torch.engine.superstep import converge_loop, while_loop
from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.graph.generate import rmat_edges
from green_marl_tpu_torch.models import bfs, hop_dist, pagerank, sssp

# e_pad // 2 > 4096: BFS has a push tier, so it reads its direction a level
N, M = 3000, 24000
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def graph():
    src, dst = rmat_edges(N, M, seed=5)
    g, _ = from_edges(src, dst, N)
    lens = torch.from_numpy(np.random.default_rng(5).integers(
        1, 101, g.e_pad, dtype=np.int32))
    deg = g.out_degree()[:N]
    roots = {"hub": int(deg.argmax()),
             "leaf": int(torch.nonzero(deg == 1)[0, 0])}
    return g, lens, roots


def _call(kind, g, lens, root, **kw):
    """One call of a kind and its loop's ``(loop, iterations, max_iter)``."""
    if kind == "pagerank":
        res = pagerank.pagerank(g, **kw)
        return res, ("converge", res.iterations, kw.get("max_iter", 100))
    if kind == "bfs":
        res = bfs.bfs(g, root, **kw)
        return res, ("while", res.levels_run, kw.get("max_iter", N + 1))
    res = (hop_dist.hop_dist(g, root, **kw) if kind == "hop_dist"
           else sssp.sssp(g, root, lens, **kw))
    return res, ("while", res.iterations, kw.get("max_iter", N + 1))


def _spans(prof):
    """``(start, end, name)`` of every ``gm:`` span in the profile."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.name.startswith("gm:")]


def _profiled(kind, g, lens, root, **kw):
    with torch.profiler.profile(activities=CPU) as prof:
        res, loop = _call(kind, g, lens, root, **kw)
    return res, loop, _spans(prof)


def loop_spans(loop, k, max_iter):
    """``(gm:superstep, gm:sync:predicate)`` of a loop that stepped ``k``
    times: a pass a step, and one more whose read ends the loop unless the
    cap did; ``converge_loop`` reads no predicate before its first step."""
    passes = k + (k < max_iter)
    return passes, passes - (loop == "converge")


def _push_levels(g, res):
    """The levels BFS expanded top-down: those whose frontier's out-edges
    fit its largest push tier."""
    tiers = [c for c in bfs.PUSH_TIERS if c < g.e_pad // 2]
    deg = g.out_degree().to(res.level.device)
    return sum(int(deg[res.level == k].sum()) <= max(tiers, default=-1)
               for k in range(res.levels_run))


def expected(g, kind, res, loop):
    """Each span's count in one call of ``kind``."""
    passes, reads = loop_spans(*loop)
    want = {"gm:setup": 1, "gm:superstep": passes,
            "gm:sync:predicate": reads}
    if kind == "pagerank":
        want["gm:sync:upload"] = 3          # 1/N, e, d
    elif kind == "bfs":
        want["gm:sync:bfs_direction"] = res.levels_run
        want["gm:sync:bfs_push_mark"] = _push_levels(g, res)
        want["gm:sync:bfs_reached"] = 1
    else:
        want["gm:sync:upload"] = 1          # the dtype's infinity
    return want


KINDS = ("pagerank", "hop_dist", "sssp", "bfs")


@pytest.mark.parametrize("kind,root,kw", [
    ("pagerank", "hub", {}), ("pagerank", "hub", {"e": 1e-7}),
    ("hop_dist", "hub", {}), ("hop_dist", "leaf", {}),
    ("sssp", "hub", {}), ("sssp", "leaf", {}),
    ("bfs", "hub", {}), ("bfs", "leaf", {})], ids=str)
def test_span_counts_follow_the_loop(graph, kind, root, kw):
    g, lens, roots = graph
    res, loop, spans = _profiled(kind, g, lens, roots[root], **kw)
    assert loop[1] >= 1
    got = collections.Counter(n for _, _, n in spans)
    assert got == expected(g, kind, res, loop)


@pytest.mark.parametrize("kind,cap", [("pagerank", 3), ("hop_dist", 2),
                                      ("bfs", 2)])
def test_span_counts_when_the_cap_ends_the_loop(graph, kind, cap):
    g, lens, roots = graph
    res, loop, spans = _profiled(kind, g, lens, roots["hub"], max_iter=cap)
    assert loop[1] == cap
    got = collections.Counter(n for _, _, n in spans)
    assert got == expected(g, kind, res, loop)
    assert got["gm:superstep"] == cap


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("kind", KINDS)
def test_each_sync_sits_in_its_phase(graph, kind):
    """Predicate reads and BFS's direction reads inside a superstep, the
    uploads inside the set-up, and set-up and supersteps apart."""
    g, lens, roots = graph
    _, _, spans = _profiled(kind, g, lens, roots["hub"])
    steps = [s for s in spans if s[2] == "gm:superstep"]
    setup = [s for s in spans if s[2] == "gm:setup"]
    for s in spans:
        if s[2] in ("gm:sync:predicate", "gm:sync:bfs_direction",
                    "gm:sync:bfs_push_mark"):
            assert any(_inside(s, p) for p in steps), s
        elif s[2] == "gm:sync:upload":
            assert _inside(s, setup[0]), s
    assert all(p[0] >= setup[0][1] for p in steps)


@pytest.mark.parametrize("kind", KINDS)
def test_no_profiler_no_record_function(graph, kind, monkeypatch):
    g, lens, roots = graph
    want, _ = _call(kind, g, lens, roots["hub"])

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    res, _ = _call(kind, g, lens, roots["hub"])
    for a, b in zip(res, want):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    with pytest.raises(AssertionError, match="no profiler"):
        with torch.profiler.profile(activities=CPU):
            _call(kind, g, lens, roots["hub"])


def test_nested_loops_give_nested_supersteps():
    """An outer ``while_loop`` whose step runs an inner one to its end (as
    delta_stepping's buckets do)."""
    def outer(st):
        n, inner_total = st
        _, stats = while_loop(lambda s: (s[0] - 1, s[0] > 1),
                              lambda s: s[1], (n, torch.tensor(True)), 100)
        return n - 1, inner_total + stats.iterations

    with torch.profiler.profile(activities=CPU) as prof:
        (_, inner_total), stats = while_loop(
            outer, lambda st: st[0] > 0, (torch.tensor(3), 0), 100)
    spans = _spans(prof)
    steps = sorted(s for s in spans if s[2] == "gm:superstep")
    assert stats.iterations == 3 and inner_total == 3 + 2 + 1
    # 3 outer passes that step and the one that ends the loop; the inner
    # loops' k + 1 passes each
    assert len(steps) == 4 + (4 + 3 + 2)
    outer_steps = [s for s in steps
                   if not any(_inside(s, o) and s != o for o in steps)]
    assert len(outer_steps) == 4
    reads = [s for s in spans if s[2] == "gm:sync:predicate"]
    assert len(reads) == len(steps)


def test_a_host_predicate_is_no_sync():
    """A plain bool predicate (``models/scc.py``'s) opens no sync span."""
    with torch.profiler.profile(activities=CPU) as prof:
        state, stats = converge_loop(lambda s: (s[0] + 1, s[0] + 1 < 4),
                                     lambda s: s[1], (0, True), 10)
    names = collections.Counter(n for _, _, n in _spans(prof))
    assert stats.iterations == 4 and state[0] == 4
    assert names == {"gm:superstep": 5}


def _synced(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``, and the Python stack
    of each synchronizing op it ran."""
    stacks = []

    def keep(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stacks.append(traceback.extract_stack()[:-1])

    # switching the mode on warns once of itself, so it is not recorded
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, stacks


def _site(stack):
    """The innermost frame of a sync, and the innermost in the port."""
    def at(f):
        return f"{os.path.basename(f.filename)}:{f.lineno}"
    port = [f for f in stack if "green_marl_tpu_torch" in f.filename]
    return f"{at(stack[-1])} ({at(port[-1]) if port else 'not the port'})"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_every_sync_on_the_card_has_its_span(graph, kind):
    """One call of each kind on the card under ``set_sync_debug_mode
    ("warn")``: as many synchronizing ops as ``gm:sync:*`` spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    g, lens, roots = graph
    g, lens = g.to("cuda"), lens.to("cuda")
    _call(kind, g, lens, roots["hub"])      # builds and loads the kernels
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=CPU) as prof:
        (res, loop), stacks = _synced(
            lambda: _call(kind, g, lens, roots["hub"]))
    syncs = collections.Counter(_site(s) for s in stacks)
    spans = collections.Counter(n for _, _, n in _spans(prof)
                                if n.startswith("gm:sync:"))
    print(f"{kind}: {loop[1]} steps, syncs {sorted(syncs.items())}, "
          f"spans {sorted(spans.items())}")
    assert sum(syncs.values()) == sum(spans.values())
    assert spans == {k: v for k, v in expected(g, kind, res, loop).items()
                     if k.startswith("gm:sync:")}
