"""The port's batched compiled programs (``CompiledProc.batch``) held
against the JAX package's (``jax.vmap`` over the compiled program) on the
CPU, lane for lane.

The same inline source, graph and ``over=`` arrays go through both
``batch``; the JAX outputs cross into the port's types whole
(``graph.csr.outputs_from_arrays``).  Integers and bools must agree bit for
bit, floats within rtol 1e-6 (a lane's float sums may add in another order
than JAX's batched reductions).  Each lane must also equal the port's own
single run on it (floats bit for bit: a lane's reductions are those of the
single run).  What JAX's batch refuses, the port refuses with
``LowerError`` ("... cannot batch"); what JAX runs host-eager once for every
lane (a DFS, a collection Items loop, a priority-map While whose host reads
do not depend on the lanes), the port runs too.  The lane-batched plain versions of the segment-reduce and
prefix-sum kernels must equal the 1-D ones row by row.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from green_marl_tpu.graph import binary_io as jbio
from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import from_edges as jax_from_edges
from green_marl_tpu.lang import lower as JL

from green_marl_tpu_torch.graph.csr import (ARRAY_FIELDS, from_edges,
                                            graph_from_arrays,
                                            outputs_from_arrays)
from green_marl_tpu_torch.lang import lower as TL
from green_marl_tpu_torch.ops import kernels as K
from green_marl_tpu_torch.ops import segment as S
from green_marl_tpu_torch.runtime import collections as TC

import test_torch_lower as TLT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAGERANK_GM = """
Procedure pagerank(G: Graph, e,d: Double, max: Int;
                   pg_rank: Node_Prop<Double>)
{
    Double diff;
    Int cnt = 0;
    Double N = G.NumNodes();
    G.pg_rank = 1 / N;
    Do {
        diff = 0.0;
        Foreach (t: G.Nodes) {
            Double val = (1-d) / N + d*
                Sum(w: t.InNbrs) { w.pg_rank / w.OutDegree() };
            diff += | val - t.pg_rank |;
            t.pg_rank <= val @ t;
        }
        cnt++;
    } While ((diff > e) && (cnt < max));
}
"""

HOP_DIST_GM = """
Procedure hop_dist(G:Graph, dist:N_P<Int>, root: Node)
{
    N_P<Bool> updated;
    N_P<Bool> updated_nxt;
    N_P<Int>  dist_nxt;
    Bool fin = False;
    G.dist = (G == root) ? 0 : +INF;
    G.updated = (G == root) ? True: False;
    G.dist_nxt = G.dist;
    G.updated_nxt = G.updated;
    While(!fin) {
        fin = True;
        Foreach(n: G.Nodes)(n.updated) {
            Foreach(s: n.Nbrs) {
                <s.dist_nxt; s.updated_nxt> min= <n.dist + 1; True>;
            }
        }
        G.dist = G.dist_nxt;
        G.updated = G.updated_nxt;
        G.updated_nxt = False;
        fin = ! Exist(n: G.Nodes){n.updated};
    }
}
"""

SSSP_GM = HOP_DIST_GM.replace(
    "hop_dist(G:Graph, dist:N_P<Int>, root: Node)",
    "sssp(G:Graph, dist:N_P<Int>, len:E_P<Int>, root: Node)").replace(
    "<s.dist_nxt; s.updated_nxt> min= <n.dist + 1; True>;",
    "Edge e = s.ToEdge();\n"
    "                <s.dist_nxt; s.updated_nxt> min= <n.dist + e.len; True>;")

# avg_teen_cnt.gm with its band's lower bound as an argument
BAND_CNT_GM = """
Procedure band_cnt(G: Graph, age, cnt: N_P<Int>, lo: Int, K: Int) : Float {
    Foreach(n: G.Nodes) {
        n.cnt = Count(t: n.InNbrs)(t.age >= lo && t.age < lo + 10);
    }
    Float avg = (Float) Avg(n: G.Nodes)(n.age > K){ n.cnt };
    Return avg;
}
"""

# an int32 Min pull and a float Max pull of values shifted by a lane scalar
MINMAX_GM = """
Procedure minmax(G: Graph, A: N_P<Int>, s: Int, f: Float;
                 B: N_P<Int>, F: N_P<Float>) {
    Foreach(t: G.Nodes) {
        t.B = Min(w: t.InNbrs) { w.A - s };
        t.F = Max(w: t.InNbrs) { (Float) w.A * f };
    }
}
"""

# an If on a lane value: both branches run, merged lane by lane
IF_GM = """
Procedure iflane(G: Graph, k: Int; P: N_P<Int>) : Int {
    Int x = 0;
    If (k % 2 == 0) {
        G.P = k;
        x = k * 10;
    } Else {
        Foreach(n: G.Nodes)(n % 3 == 0) { n.P = -k; }
        x = -1;
    }
    Return x + Count(n: G.Nodes)(n.P > 1);
}
"""

# the masked per-slot While (tests/test_torch_lower.py SPIN) with a lane
# bound on the tokens
SPIN_GM = """
Procedure spin(G: Graph, m: Int; acc: N_P<Int>) {
    N_P<Int> c;
    Foreach(n: G.Nodes) { n.c = (Int)(n % m); }
    Foreach(n: G.Nodes) {
        While (n.c > 0) {
            n.acc += n.c;
            n.c = n.c - 1;
        }
    }
}
"""

BFS_GM = """
Proc bfsnav(G: Graph, root: Node, ok: N_P<Bool>;
            lev: N_P<Int>, sigma: N_P<Float>, delta: N_P<Float>) {
    G.lev = -1;
    G.sigma = 0;
    root.sigma = 1;
    InBFS(v: G.Nodes From root)[v.ok](v != root) {
        v.sigma = Sum(w: v.UpNbrs){ w.sigma };
        v.lev = Count(w: v.UpNbrs);
    } InReverse(v != root) {
        v.delta = Sum(w: v.DownNbrs){ w.delta + w.sigma };
    }
}
"""

BFS_T_GM = """
Proc revreach(G: Graph, root: Node; vis: N_P<Int>) {
    G.vis = 0;
    InBFS(v: G^.Nodes From root) {
        v.vis = 1;
    }
}
"""

# draws outside and inside a While whose predicate depends on the lane
DRAWS_GM = """
Proc draws(G: Graph, k: Int; P: N_P<Double>) : Double {
    Foreach(v: G.Nodes) { v.P = Uniform() * k; }
    Int i = 0;
    Double acc = 0.0;
    While (i < k) {
        acc += Uniform();
        i++;
    }
    Return acc + Uniform();
}
"""

# a Return in each branch of an If on a lane value (JAX's merge of a traced
# If takes a Return in one branch alone as taken in every lane)
RETURN_GM = """
Procedure ret(G: Graph, r: Node) : Int {
    Int d = Sum(n: G.Nodes)(n < r){ n.Degree() };
    If (d > 500) { Return d; } Else { Return -d; }
}
"""

# two over= arguments at once: a root and a weight scale
TWO_GM = """
Procedure two(G: Graph, root: Node, w: Int; dist: N_P<Int>) {
    N_P<Int> nxt;
    G.dist = (G == root) ? 0 : +INF;
    Int i = 0;
    While (i < 4) {
        G.nxt = G.dist;
        Foreach(n: G.Nodes)(n.dist < +INF) {
            Foreach(s: n.Nbrs) { s.nxt min= n.dist + w; }
        }
        G.dist = G.nxt;
        i++;
    }
}
"""

# communities.gm with a lane-dependent histogram weight: a Map declared in
# a node loop, fed lane values
COMMUNITIES_GM = """
Procedure communities(G: Graph, q: Int; Comm: N_P<Node>) {
    Foreach(x: G.Nodes) { x.Comm = x; }
    Bool finished = False;
    Do {
        finished = True;
        Foreach(x: G.Nodes) {
            Map<Node, Int> T;
            Foreach(y: x.Nbrs) {
                Node source = y.Comm;
                T[source] += (source < q) ? 1 : 2;
            }
            If (!T.HasMaxValue(x.Comm)) {
                x.Comm <= T.GetMaxKey();
                finished = False;
            }
        }
    } While (!finished);
}
"""

DIJKSTRA_GM = """
Procedure dijk(G: Graph, Len: E_P<Int>, src, dst: Node;
               Parent: N_P<Node>) : Int {
    N_P<Int> Dist;
    N_P<Bool> Done;
    Map<Node, Int> Q;
    G.Dist = +INF;
    G.Done = False;
    G.Parent = NIL;
    src.Dist = 0;
    Q[src] = 0;
    While (Q.Size() > 0) {
        Node u = Q.GetMinKey();
        Q.Remove(u);
        If (!u.Done) {
            u.Done = True;
            For (v: u.Nbrs) {
                Edge e = v.ToEdge();
                Int nd = u.Dist + e.Len;
                If (nd < v.Dist) {
                    v.Dist = nd;
                    v.Parent = u;
                    Q[v] = nd;
                }
            }
        }
    }
    Return dst.Dist;
}
"""

DFS_GM = """
Proc dfs(G: Graph, s: Node; A: N_P<Int>) {
    Int t = 0;
    G.A = -1;
    InDFS(v: G.Nodes From s) {
        v.A = t;
        t++;
    }
}
"""


def _compile(mod, text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod.compile_source(text)


@pytest.fixture(scope="module")
def g100():
    src, dst = gen.rmat_edges(100, 600, seed=5)
    gj, _ = jax_from_edges(src, dst, 100)
    gt, _ = from_edges(src, dst, 100)
    return gj, gt


@pytest.fixture(scope="module")
def parity10k():
    path = os.path.join(REPO, "data", "parity", "parity10k.bin")
    gj, _ = jbio.load_binary(path).freeze()
    gt = graph_from_arrays({f: np.asarray(getattr(gj, f))
                            for f in ARRAY_FIELDS}, gj.num_nodes,
                           gj.num_edges)
    return gj, gt


def _check_batch(text, graphs, over, rtol=1e-6, unlike_single=(), **fixed):
    """The port's batch against JAX's vmap, and each lane against the
    port's single run on it (but the outputs named in ``unlike_single``,
    where JAX's batch differs from its own single runs); returns the port's
    batched outputs."""
    gj, gt = graphs
    jo = outputs_from_arrays(_compile(JL, text).batch(
        gj, over={k: jnp.asarray(v) for k, v in over.items()}, **fixed))
    cp = _compile(TL, text)
    to = cp.batch(gt, over=over, **fixed)
    b = len(next(iter(over.values())))
    assert set(to) == set(jo)
    for k in jo:
        for x, y in zip(TC.tree_leaves(jo[k]), TC.tree_leaves(to[k])):
            assert type(y) is torch.Tensor, k
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert y.shape[0] == b, k
            if x.dtype.is_floating_point:
                np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=rtol,
                                           atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(y.numpy(), x.numpy(),
                                              err_msg=k)
    for i in range(b):
        kw = dict(fixed)
        kw.update({k: v[i] for k, v in over.items()})
        one = cp(gt, **kw)
        for k in set(one) - set(unlike_single):
            for x, y in zip(TC.tree_leaves(one[k]), TC.tree_leaves(to[k])):
                np.testing.assert_array_equal(y[i].numpy(), x.numpy(),
                                              err_msg=f"{k} lane {i}")
    return to


def _roots(g, k):
    return np.asarray([0, 3, 7, 11, 50, 99][:k], np.int32) % g.num_nodes


def test_hop_dist_over_roots(g100):
    out = _check_batch(HOP_DIST_GM, g100, {"root": _roots(g100[1], 6)})
    assert (out["dist"][:, :100] == 0).sum() == 6


def test_hop_dist_and_sssp_parity10k(parity10k):
    gt = parity10k[1]
    roots = np.asarray([0, 17, 4242, 9999], np.int32)
    _check_batch(HOP_DIST_GM, parity10k, {"root": roots})
    w = np.zeros(gt.e_pad, np.int32)
    w[: gt.num_edges] = np.random.default_rng(1).integers(1, 9,
                                                          gt.num_edges)
    _check_batch(SSSP_GM, parity10k, {"root": roots}, len=w)


def test_sssp_over_roots(g100):
    w = np.random.RandomState(0).randint(1, 10, size=g100[1].e_pad)
    _check_batch(SSSP_GM, g100, {"root": _roots(g100[1], 4)},
                 len=w.astype(np.int32))


@pytest.mark.parametrize("graph", ["g100", "parity10k"])
def test_pagerank_over_damping(graph, request):
    graphs = request.getfixturevalue(graph)
    ds = np.asarray([0.70, 0.78, 0.85, 0.92], np.float32)
    _check_batch(PAGERANK_GM, graphs, {"d": ds}, e=1e-7, max=50)


def test_band_count_over_lo(parity10k):
    gt = parity10k[1]
    age = np.random.default_rng(3).integers(0, 80, gt.n_pad).astype(
        np.int32)
    out = _check_batch(BAND_CNT_GM, parity10k,
                       {"lo": np.asarray([0, 10, 20, 40, 70], np.int32)},
                       age=age, K=30)
    assert out["cnt"].sum() > 0


def test_min_max_pulls_of_lane_values(g100):
    a = ((np.arange(g100[1].n_pad) * 7919) % 1000).astype(np.int32)
    _check_batch(MINMAX_GM, g100, {"s": np.asarray([0, 5, -300], np.int32),
                                   "f": np.asarray([1.0, -0.5, 3.25],
                                                   np.float32)}, A=a)


@pytest.mark.parametrize("text,over", [
    (IF_GM, {"k": np.asarray([2, 3, 8, 5], np.int32)}),
    (SPIN_GM, {"m": np.asarray([1, 3, 5, 9], np.int32)}),
    (RETURN_GM, {"r": np.asarray([0, 10, 40, 90], np.int32)}),
    (TWO_GM, {"root": np.asarray([0, 7, 42], np.int32),
              "w": np.asarray([1, 5, 2], np.int32)}),
    (BFS_T_GM, {"root": np.asarray([0, 5, 9, 64], np.int32)}),
    (COMMUNITIES_GM, {"q": np.asarray([3, 50, 1000], np.int32)}),
], ids=["if", "masked_spin", "return", "two_over", "transposed_bfs",
        "node_loop_map"])
def test_small_programs(g100, text, over):
    _check_batch(text, g100, over)


def test_inbfs_from_lane_roots(g100):
    n_pad = g100[1].n_pad
    _check_batch(BFS_GM, g100, {"root": np.asarray([0, 3, 17, 60],
                                                   np.int32)},
                 ok=(np.arange(n_pad) % 7 != 3))


def test_draws_per_lane(g100):
    """Draws outside a loop are the same bits in every lane (the key does
    not depend on the lanes); inside a While whose lanes run different pass
    counts, each lane draws what its single run draws."""
    out = _check_batch(DRAWS_GM, g100, {"k": np.asarray([1, 4, 2, 4],
                                                        np.int32)},
                       rtol=0.0)
    p = out["P"].numpy()
    np.testing.assert_array_equal(p[1], p[3])
    np.testing.assert_array_equal(p[0] * 4, p[1])


def test_one_lane(g100):
    _check_batch(HOP_DIST_GM, g100, {"root": np.asarray([5], np.int32)})
    _check_batch(PAGERANK_GM, g100, {"d": np.asarray([0.8], np.float32)},
                 e=1e-7, max=30)


# host-eager constructs whose host reads do not depend on the lanes: JAX's
# vmap runs them once for every lane, and so does the port

# a DFS from a fixed root, then a lane-dependent pass
DFS_THEN_LANES_GM = """
Proc dfsk(G: Graph, s: Node, k: Int; A: N_P<Int>) {
    Int t = 0;
    G.A = -1;
    InDFS(v: G.Nodes From s) {
        v.A = t;
        t++;
    }
    Foreach(n: G.Nodes) { n.A = n.A + k; }
}
"""

# tests/test_torch_lower.py's programs with a lane argument of their own
COLLECTIONS_K_GM = TLT.COLLECTIONS.replace(
    "Q: Node_Seq; A: N_P<Int>) : Int",
    "Q: Node_Seq, k: Int; A: N_P<Int>) : Int").replace(
    "Return total * 1000", "Return k + total * 1000")
DFS_K_GM = TLT.DFS.replace("s: Node;", "s: Node, k: Int;").replace(
    "v.A = t;", "v.A = t + k;")
TARJAN_K_GM = TLT.TARJAN_LIKE.replace("(G: Graph; SCC", "(G: Graph, k: Int; SCC")
# the priority-map While, with a Return in each branch of its last If
PRIORITY_ELSE_GM = TLT.DIJKSTRA_GM.replace(
    "If (found) { Return M[dst]; }\n    Return -1;",
    "If (found) { Return M[dst]; } Else { Return -1; }")


def _host_eager_cases(gt):
    nset = np.zeros(gt.n_pad, bool)
    nset[[2, 4, 9]] = True
    ones = np.ones(gt.e_pad, np.int32)
    k = np.asarray([1, 2, 3], np.int32)
    return {
        "indfs_fixed_root": (DFS_THEN_LANES_GM, {"k": k}, dict(s=0)),
        "collection_items": (COLLECTIONS_K_GM,
                             {"k": np.asarray([67, 68], np.int32)},
                             dict(S=[1, 3, 5], O=[7, 3, 7, 8], T=nset)),
        "indfs_post": (DFS_K_GM, {"k": k}, dict(s=0)),
        "tarjan_like": (TARJAN_K_GM, {"k": k}, {}),
        "priority_while_over_dst": (
            PRIORITY_ELSE_GM, {"dst": np.asarray([0, 1, 5, 40], np.int32)},
            dict(src=0, Len=ones)),
        "priority_while_over_src": (
            PRIORITY_ELSE_GM, {"src": np.asarray([0, 1, 3], np.int32)},
            dict(dst=1, Len=ones)),
        "priority_while_both": (
            PRIORITY_ELSE_GM, {"src": np.asarray([0, 3, 7], np.int32),
                               "dst": np.asarray([5, 1, 9], np.int32)},
            dict(Len=(np.arange(gt.e_pad) % 5 + 1).astype(np.int32))),
    }


@pytest.mark.parametrize("case", [
    "indfs_fixed_root", "collection_items", "indfs_post", "tarjan_like",
    "priority_while_over_dst", "priority_while_over_src",
    "priority_while_both"])
def test_host_eager_programs_batch(g100, case):
    text, over, fixed = _host_eager_cases(g100[1])[case]
    _check_batch(text, g100, over, **fixed)


@pytest.mark.parametrize("arg,lanes,fixed,want,single", [
    ("src", [0, 1], dict(dst=1), [0, 0], [-1, 0]),
    ("dst", [0, 1, 5], dict(src=0), [0, 0, 2], [0, -1, 2]),
], ids=["over_src", "over_dst"])
def test_priority_while_matches_jax_return_merge(g100, arg, lanes, fixed,
                                                 want, single):
    """tests/test_torch_lower.py's DIJKSTRA_GM ends in ``If (found) {
    Return M[dst]; } Return -1;``.  JAX's vmap merges a traced If with a
    Return in one branch only as a Return in every lane (ROADMAP Queue 3),
    so a lane whose single run finds no path (-1) returns the map's value
    at dst (0).  The port's batch gives JAX's lanes; its single runs, like
    JAX's, give -1."""
    gt = g100[1]
    ones = np.ones(gt.e_pad, np.int32)
    out = _check_batch(TLT.DIJKSTRA_GM, g100,
                       {arg: np.asarray(lanes, np.int32)},
                       unlike_single=("_return",), Len=ones, **fixed)
    assert out["_return"].tolist() == want
    cp = _compile(TL, TLT.DIJKSTRA_GM)
    assert [int(cp(gt, Len=ones, **{arg: v}, **fixed)["_return"])
            for v in lanes] == single


# a sequence that holds a lane value, then a loop over its items
ITEMS_OF_LANES_GM = """
Proc p(G: Graph, r, q: Node; A: N_P<Int>) : Int {
    Node_Seq Q;
    Int c = 0;
    G.A = 0;
    Q.PushBack(r);
    Q.PushBack(q);
    For (v: Q.Items) { v.A += 1; c += 1; }
    Return c;
}
"""

# a map-driven While (not the priority idiom) fed a lane value
MAP_WHILE_GM = """
Proc mw(G: Graph, a, b: Node, k: Int) : Int {
    Map<Node, Int> M;
    M[a] = k;
    M[b] = 2;
    Int s = 0;
    While (M.Size() > 0) {
        Node u = M.GetMinKey();
        s += M[u] * (u + 1);
        M.Remove(u);
    }
    Return s;
}
"""


@pytest.mark.parametrize("text,over,fixed", [
    (DIJKSTRA_GM, {"src": np.asarray([0, 1], np.int32)}, dict(dst=1)),
    (DFS_GM, {"s": np.asarray([0, 3], np.int32)}, {}),
    (TLT.DFS.replace("s: Node;", "s: Node, k: Int;").replace(
        "[v != s + 7]", "[v != k]"), {"k": np.asarray([7, 9], np.int32)},
     dict(s=0)),
    (ITEMS_OF_LANES_GM, {"r": np.asarray([0, 3], np.int32)}, dict(q=5)),
    (MAP_WHILE_GM, {"k": np.asarray([1, 5], np.int32)}, dict(a=3, b=4)),
    (MAP_WHILE_GM, {"a": np.asarray([1, 5], np.int32)}, dict(k=3, b=4)),
], ids=["dijkstra", "dfs", "dfs_lane_navigator", "items_of_lane_values",
        "map_while_lane_values", "map_while_lane_keys"])
def test_refused_where_jax_refuses(g100, text, over, fixed):
    gj, gt = g100
    if text is DIJKSTRA_GM:
        fixed["Len"] = np.ones(gt.e_pad, np.int32)
    with pytest.raises(Exception):
        _compile(JL, text).batch(
            gj, over={k: jnp.asarray(v) for k, v in over.items()}, **fixed)
    with pytest.raises(TL.LowerError, match="cannot batch"):
        _compile(TL, text).batch(gt, over=over, **fixed)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_foreign_text_under_batch(g100):
    """Foreign C++ runs on the host: over a lane value both refuse, over
    an unbatched one both run it once and agree lane for lane."""
    gj, gt = g100
    text = """
Procedure P(G: Graph, y: Double, k: Int; out: Double) {
    out = [sin($y) / 2] + k;
}"""
    with pytest.raises(Exception):
        _compile(JL, text).batch(gj, over={"y": jnp.asarray([1.0, 2.0])},
                                 k=1)
    with pytest.raises(TL.LowerError, match="host scalar"):
        _compile(TL, text).batch(gt, over={"y": np.asarray([1.0, 2.0],
                                                           np.float32)},
                                 k=1)
    _check_batch(text, g100, {"k": np.asarray([1, 2, 5], np.int32)},
                 y=1.25)


def test_lockstep_pulls_count_the_largest_lane(g100, monkeypatch):
    """A batched pagerank calls the segment reduction once a pass for all
    lanes: as many times as its slowest lane iterates, not the sum."""
    gt = g100[1]
    cp = _compile(TL, PAGERANK_GM)
    calls = []
    real = S.sorted_segment_reduce

    def counting(vals, *a, **kw):
        calls.append(tuple(vals.shape))
        return real(vals, *a, **kw)

    ds = [0.5, 0.7, 0.9]
    iters = []
    monkeypatch.setattr(S, "sorted_segment_reduce", counting)
    for d in ds:
        calls.clear()
        cp(gt, e=1e-6, d=d, max=100)
        iters.append(len(calls))
    calls.clear()
    cp.batch(gt, over={"d": np.asarray(ds, np.float32)}, e=1e-6, max=100)
    assert len(set(iters)) > 1
    assert len(calls) == max(iters)
    # the Do pass before the loop pulls the lane-independent 1/N ranks once
    assert calls[0] == (gt.e_pad,)
    assert set(calls[1:]) == {(3, gt.e_pad)}, calls


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_lane_plain_versions_equal_1d(op, dtype):
    rng = np.random.default_rng(11)
    lens = rng.choice([0, 0, 1, 3, 17], size=300)
    lens[100:180] = 0                      # a run of empty rows
    off = np.zeros(301, np.int64)
    np.cumsum(lens, out=off[1:])
    e = int(off[-1]) + 5
    vals = (torch.from_numpy(rng.integers(-1000, 1000, (4, e)))
            .to(dtype))
    ids = torch.zeros(e, dtype=torch.int32)
    offsets = torch.from_numpy(off.astype(np.int32))
    got = K.segment_reduce_sorted(vals, ids, offsets, 310, op)
    assert got.shape == (4, 310)
    for b in range(4):
        assert torch.equal(got[b], K.segment_reduce_sorted(
            vals[b].contiguous(), ids, offsets, 310, op))
    clipped = offsets[40:250] - offsets[40]    # offsets cut to a slab
    got = K.segment_reduce_sorted(vals, ids, clipped.contiguous(), 260, op)
    for b in range(4):
        assert torch.equal(got[b], K.segment_reduce_sorted(
            vals[b].contiguous(), ids, clipped.contiguous(), 260, op))
    for exclusive in (False, True):
        c = K.plain_cumsum(vals, exclusive=exclusive)
        assert c.shape == (4, e + exclusive)
        for b in range(4):
            assert torch.equal(c[b], K.plain_cumsum(vals[b].contiguous(),
                                                    exclusive=exclusive))
