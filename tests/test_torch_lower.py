"""The port's compiled-.gm executor (``green_marl_tpu_torch.lang``) held
against the JAX package's (``green_marl_tpu.lang``) on the CPU.

The same inline source and the same numpy graph (``generate.rmat_edges``
from a seed) go through both ``compile_source``; the JAX outputs cross into
the port's types whole (``graph.csr.outputs_from_arrays``).  Integers,
bools, sets, sequences and maps must agree bit for bit, draws too; float
sums within rtol 1e-5 (float64: 1e-9).  Errors must be the same class.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax
from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import from_edges as jax_from_edges
from green_marl_tpu.lang import lower as JL
from green_marl_tpu.lang.typecheck import GMTypeError as JGMTypeError

from green_marl_tpu_torch.graph.csr import (from_edges, outputs_from_arrays,
                                            value_from_arrays)
from green_marl_tpu_torch.lang import lower as TL
from green_marl_tpu_torch.lang.typecheck import GMTypeError
from green_marl_tpu_torch.runtime import collections as TC
from green_marl_tpu_torch.runtime import rng as R

HAVE_GXX = shutil.which("g++") is not None
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY10K = os.path.join(REPO, "data", "parity", "parity10k.bin")

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

SSSP_GM = """
Procedure sssp(G:Graph, dist:N_P<Int>, len:E_P<Int>, root: Node)
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
                Edge e = s.ToEdge();
                <s.dist_nxt; s.updated_nxt> min= <n.dist + e.len; True>;
            }
        }
        G.dist = G.dist_nxt;
        G.updated = G.updated_nxt;
        G.updated_nxt = False;
        fin = ! Exist(n: G.Nodes){n.updated};
    }
}
"""

PULL_GM = """
Procedure pull(G: Graph, A: N_P<Int>; B: N_P<Int>, C: N_P<Int>,
               D: N_P<Int>, F: N_P<Double>) {
    G.D = +INF;
    Foreach(t: G.Nodes) {
        t.B = Min(w: t.InNbrs) { w.A };
        t.C = Sum(w: t.InNbrs) { w.A };
        t.F = Max(w: t.InNbrs) { (Double) w.A / 3.0 };
        Foreach(w: t.InNbrs) { t.D min= w.A + 1; }
    }
}
"""

DIJKSTRA_GM = """
Procedure dijk(G: Graph, Len: E_P<Int>, src, dst: Node;
               Parent: N_P<Node>) : Int {
    N_P<Bool> Settled;
    N_P<Int> Dist;
    Map<Node, Int> M;
    G.Settled = False;
    G.Parent = NIL;
    G.Dist = +INF;
    Bool failed = False;
    Bool found = False;
    M[src] = 0;
    While (!failed && !found) {
        If (M.Size() == 0) { failed = True; }
        Else {
            Node next = M.GetMinKey();
            If (next == dst) { found = True; }
            Else {
                next.Settled = True;
                Int dist = M[next];
                M.Remove(next);
                For (v: next.Nbrs)(!v.Settled) {
                    Edge e = v.ToEdge();
                    If (!M.HasKey(v)) {
                        M[v] = dist + e.Len;
                        v.Parent = next;
                    } Else If (M[v] > dist + e.Len) {
                        M[v] = dist + e.Len;
                        v.Parent = next;
                    }
                }
            }
        }
    }
    If (found) { Return M[dst]; }
    Return -1;
}
"""

BIDIR_GM = """
Procedure bidir(G: Graph, Weight: E_P<Int>, src, dst: Node;
                Parent: N_P<Node>, ParentEdge: N_P<Edge>) : Bool {
    If (src == dst) Return True;
    N_P<Node> RParent;
    N_P<Edge> RParentEdge;
    N_P<Bool> FFinalized;
    N_P<Bool> RFinalized;
    Map<Node, Int> FReachable;
    Map<Node, Int> RReachable;
    N_P<Int> FCost;
    N_P<Int> RCost;
    G.Parent = NIL;
    G.ParentEdge = NIL;
    G.RParent = NIL;
    G.RParentEdge = NIL;
    G.FFinalized = False;
    G.RFinalized = False;
    G.FCost = +INF;
    G.RCost = +INF;
    FReachable[src] = 0;
    RReachable[dst] = 0;
    src.FCost = 0;
    dst.RCost = 0;
    Int curMinFCost = 0;
    Int curMinRCost = 0;
    Int minCost = +INF;
    Node mid = NIL;
    Bool terminate = False;
    While (!terminate && (FReachable.Size() != 0 || RReachable.Size() != 0)) {
        If (FReachable.Size() != 0 && (FReachable.Size() <= RReachable.Size() || RReachable.Size() == 0)) {
            Node fnext = FReachable.GetMinKey();
            FReachable.Remove(fnext);
            fnext.FFinalized = True;
            curMinFCost = fnext.FCost;
            If (curMinFCost + curMinRCost > minCost) {
                terminate = True;
            }
            Int fdist = fnext.FCost;
            For (v: fnext.Nbrs)(!v.FFinalized) {
                Edge e = v.ToEdge();
                If (fdist + e.Weight + curMinRCost <= minCost) {
                    If (v.FCost > fdist + e.Weight) {
                        v.FCost = fdist + e.Weight;
                        FReachable[v] = v.FCost;
                        v.Parent = fnext;
                        v.ParentEdge = e;
                        If (v.RCost != +INF) {
                            Int newCost = v.FCost + v.RCost;
                            <minCost; mid> min= <newCost; v>;
                        }
                    }
                }
            }
        } Else If (RReachable.Size() != 0 && (RReachable.Size() <= FReachable.Size() || FReachable.Size() == 0)) {
            Node rnext = RReachable.GetMinKey();
            RReachable.Remove(rnext);
            rnext.RFinalized = True;
            curMinRCost = rnext.RCost;
            If (curMinFCost + curMinRCost > minCost) {
                terminate = True;
            }
            Int rdist = rnext.RCost;
            For (v: rnext.InNbrs)(!v.RFinalized) {
                Edge e = v.ToEdge();
                If (rdist + e.Weight + curMinFCost <= minCost) {
                    If (v.RCost > rdist + e.Weight) {
                        v.RCost = rdist + e.Weight;
                        RReachable[v] = v.RCost;
                        v.RParent = rnext;
                        v.RParentEdge = e;
                        If (v.FCost != +INF) {
                            Int newCost = v.FCost + v.RCost;
                            <minCost; mid> min= <newCost; v>;
                        }
                    }
                }
            }
        }
    }
    If (mid != NIL) {
        Node cur = mid;
        While (cur != dst) {
            Node prev = cur.RParent;
            prev.Parent = cur;
            prev.ParentEdge = cur.RParentEdge;
            cur = prev;
        }
        Return True;
    }
    Return False;
}
"""


def _graphs(n, m, seed):
    src, dst = gen.rmat_edges(n, m, seed=seed)
    gj, perm = jax_from_edges(src, dst, n)
    gt, _ = from_edges(src, dst, n)
    return gj, gt, perm


@pytest.fixture(scope="module")
def g300():
    return _graphs(300, 2000, 5)


@pytest.fixture(scope="module")
def g100():
    return _graphs(100, 600, 5)


@pytest.fixture(scope="module")
def g50():
    return _graphs(50, 300, 1)


def _compile(mod, text, name=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod.compile_source(text, name=name)


def run_both(text, gj, gt, name=None, **kw):
    oj = _compile(JL, text, name)(gj, **kw)
    ot = _compile(TL, text, name)(gt, **kw)
    return outputs_from_arrays(oj), ot


def assert_same(a, b, rtol=0.0):
    """Output dicts equal leaf for leaf: dtypes and shapes exactly,
    values bit for bit (floats within ``rtol`` where one is given)."""
    assert set(a) == set(b)
    for k in a:
        assert type(a[k]) is type(b[k]), k
        for x, y in zip(TC.tree_leaves(a[k]), TC.tree_leaves(b[k])):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            if rtol and x.dtype.is_floating_point:
                np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=rtol,
                                           atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(y.numpy(), x.numpy(),
                                              err_msg=k)


def check(text, graphs, name=None, rtol=1e-5, **kw):
    gj, gt, _ = graphs
    a, b = run_both(text, gj, gt, name=name, **kw)
    assert_same(a, b, rtol=rtol)
    return b


# --------------------------------------------------------------------------
# The programs of the JAX package's lowering tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prog,kw", [
    (PAGERANK_GM, dict(e=1e-7, d=0.85, max=100)),
    (HOP_DIST_GM, dict(root=0)),
    (HOP_DIST_GM, dict(root=17)),
    (PULL_GM, dict(A=(np.arange(384) * 7919 % 1000).astype(np.int32))),
], ids=["pagerank", "hop_dist", "hop_dist_17", "pull"])
def test_main_programs(g300, prog, kw):
    check(prog, g300, **kw)


def test_sssp(g300):
    wl = np.random.RandomState(0).randint(
        1, 10, size=g300[1].e_pad).astype(np.int32)
    out = check(SSSP_GM, g300, root=0, len=wl)
    assert (out["dist"][:300] < np.iinfo(np.int32).max).any()


def test_pagerank_float64_under_x64(g100):
    """FLOAT/DOUBLE follow the float flag: JAX's x64, the port's default
    dtype."""
    gj, gt, _ = g100
    old = torch.get_default_dtype()
    try:
        with jax.enable_x64(True):
            oj = outputs_from_arrays(_compile(JL, PAGERANK_GM)(
                gj, e=1e-12, d=0.85, max=50))
        torch.set_default_dtype(torch.float64)
        ot = _compile(TL, PAGERANK_GM)(gt, e=1e-12, d=0.85, max=50)
    finally:
        torch.set_default_dtype(old)
    assert ot["pg_rank"].dtype == torch.float64
    assert_same(oj, ot, rtol=1e-9)


RACY = """
Procedure racy(G: Graph, p: N_P<Int>) {
    Foreach(n: G.Nodes) {
        Foreach(s: n.Nbrs) {
            s.p = 1;
        }
    }
}
"""

RACY2 = """
Procedure racy2(G: Graph) : Int {
    Int x = 0;
    Foreach(n: G.Nodes) {
        x = 1;
    }
    Return x;
}
"""


@pytest.mark.parametrize("text", [RACY, RACY2], ids=["prop", "scalar"])
def test_race_warnings(g300, text):
    with pytest.warns(JL.RaceWarning) as wj:
        JL.compile_source(text)
    with pytest.warns(TL.RaceWarning) as wt:
        cp = TL.compile_source(text)
    assert [str(w.message) for w in wj] == [str(w.message) for w in wt]
    assert cp.race_warnings
    check(text, g300)


@pytest.mark.parametrize("text,kw", [
    ("""
Procedure items_loop(G: Graph, A: N_P<Int>, S: Node_Seq) : Int {
    Int total = 0;
    For (v: S.Items) {
        v.A = 7;
        total = total + 1;
    }
    Return total;
}""", dict(S=[1, 3, 5])),
    ("""
Procedure degsum(G: Graph) : Long {
    Long x = 0;
    Foreach(n: G.Nodes) {
        x += n.Degree();
    }
    Return x;
}""", {}),
    ("""
Procedure iterate(G: Graph, k: Int; acc: N_P<Int>) {
    Int i = 0;
    G.acc = 0;
    While (i < k) {
        Foreach(n: G.Nodes) { n.acc += 2; }
        i++;
    }
}""", dict(k=5)),
    ("""
Proc degs(G: Graph; D: N_P<Int>) {
    G.D = G.Degree() + G.InDegree();
}""", {}),
    ("""
Procedure conduct(G: Graph, member: N_P<Int>, num: Int) : Float {
    Int Din, Dout, Cross;
    Din = Sum(u: G.Nodes)(u.member == num){ u.Degree() };
    Dout = Sum(u: G.Nodes)(u.member != num){ u.Degree() };
    Cross = Sum(u: G.Nodes)(u.member == num){
        Count(j: u.Nbrs)(j.member != num) };
    Float m = (Din < Dout) ? Din : Dout;
    If (m == 0) Return (Cross == 0) ? 0.0 : +INF;
    Else Return (Cross / m);
}""", dict(member=(np.arange(384) % 3).astype(np.int32), num=1)),
], ids=["items", "degsum", "while_carry", "degs", "conduct"])
def test_small_programs(g300, text, kw):
    check(text, g300, **kw)


# --------------------------------------------------------------------------
# Maps, masked loops, common neighbours, wedges (test_lower_maps.py)
# --------------------------------------------------------------------------

MTEST = """
Procedure mtest(G: Graph, a, b, c: Node) : Int {
    Map<Node, Int> M;
    M[a] = 7;
    M[b] = 2;
    M[c] = 11;
    M[b] += 4;
    M.Remove(c);
    Int sz = M.Size();
    Node k = M.GetMinKey();
    Node kx = M.GetMaxKey();
    If (!M.HasKey(c) && M.HasMaxValue(a) && M.HasMinValue(b)) {
        Return sz * 100 + (Int) k * 10 + (Int) kx;
    }
    Return -1;
}
"""

SPIN = """
Procedure spin(G: Graph, acc: N_P<Int>) {
    N_P<Int> c;
    Foreach(n: G.Nodes) { n.c = (Int)(n % 5); }
    Foreach(n: G.Nodes) {
        While (n.c > 0) {
            n.acc += n.c;
            n.c = n.c - 1;
        }
    }
}
"""

SPIN2 = """
Procedure spin(G: Graph, tok: N_P<Int>, iters: N_P<Int>) {
    Foreach(n: G.Nodes) { n.tok = (n == 0) ? 2 : 0; }
    Foreach(n: G.Nodes) {
        While (n.tok > 0) {
            n.iters += 1;
            n.tok += -1;
            Foreach(m: n.Nbrs) { m.tok += 1; }
        }
    }
}
"""

AA = """
Procedure aa(G: Graph, aa: E_P<Double>) {
    Foreach(e: G.Edges) {
        Node from = e.FromNode();
        Node to = e.ToNode();
        e.aa = Sum(n: from.CommonNbrs(to)) { 1.0 };
    }
}
"""

CNT = """
Procedure cnt(G: Graph, c: N_P<Int>) {
    Foreach(t: G.Nodes) {
        Foreach(s: t.Nbrs) {
            Foreach(r: t.CommonNbrs(s)) {
                t.c += 1;
            }
        }
    }
}
"""

TWOHOP = """
Procedure twohop(G: Graph, lab: N_P<Node>, outp: N_P<Node>) {
    Foreach(x: G.Nodes) { x.lab = x; }
    Foreach(x: G.Nodes) {
        Map<Node, Int> T;
        Foreach(m: x.Nbrs) {
            Foreach(w: m.Nbrs) {
                T[w.lab] += 1;
            }
        }
        If (!T.HasMaxValue(x.lab)) { x.outp = T.GetMaxKey(); }
    }
}
"""

ADAMIC_ADAR = """
Procedure adamicAdar(G: Graph; aa: E_P<Double>) {
    Foreach(e: G.Edges) {
        Node from = e.FromNode();
        Node to = e.ToNode();
        e.aa = Sum(n: from.CommonNbrs(to)) { 1 / Log(n.NumNbrs()) };
    }
}
"""

COMMUNITIES = """
Procedure communities(G: Graph; Comm: N_P<Node>) {
    Foreach(x: G.Nodes) { x.Comm = x; }
    Bool finished = False;
    Do {
        finished = True;
        Foreach(x: G.Nodes) {
            Map<Node, Int> T;
            Foreach(y: x.Nbrs) {
                Node source = y.Comm;
                T[source] += 1;
            }
            If (!T.HasMaxValue(x.Comm)) {
                x.Comm <= T.GetMaxKey();
                finished = False;
            }
        }
    } While (!finished);
}
"""


@pytest.mark.parametrize("text,kw", [
    (MTEST, dict(a=3, b=5, c=9)),
    (SPIN, {}),
    (SPIN2, {}),
    (AA, {}),
    (CNT, {}),
    (TWOHOP, {}),
    (ADAMIC_ADAR, {}),
    (COMMUNITIES, {}),
], ids=["mtest", "spin", "spin_tokens", "aa", "cnt", "twohop", "adamicAdar",
        "communities"])
def test_map_programs(g100, text, kw):
    out = check(text, g100, **kw)
    if text is MTEST:
        assert int(out["_return"]) == 253


def test_batch_lanes_equal_single_runs(g100):
    gj, gt, _ = g100
    hd = _compile(TL, HOP_DIST_GM)
    roots = [0, 3, 7, 11]
    out = hd.batch(gt, over={"root": np.asarray(roots, np.int32)})
    assert tuple(out["dist"].shape) == (4, gt.n_pad)
    jd = _compile(JL, HOP_DIST_GM).batch(
        gj, over={"root": jax.numpy.asarray(roots, jax.numpy.int32)})
    np.testing.assert_array_equal(out["dist"].numpy(), np.asarray(jd["dist"]))
    for i, r in enumerate(roots):
        np.testing.assert_array_equal(out["dist"][i].numpy(),
                                      hd(gt, root=r)["dist"].numpy())
    pr = _compile(TL, PAGERANK_GM)
    ds = [0.7, 0.85, 0.9]
    outs = pr.batch(gt, over={"d": np.asarray(ds, np.float32)}, e=1e-8,
                    max=20)
    for i, d in enumerate(ds):
        np.testing.assert_allclose(
            outs["pg_rank"][i].numpy(),
            pr(gt, e=1e-8, d=float(np.float32(d)), max=20)["pg_rank"]
            .numpy(), rtol=1e-6)
    # a priority-map While over lane sources runs as JAX's vmap runs it
    # (tests/test_torch_batch.py holds such programs lane for lane); a DFS
    # from lane roots reads a lane value on the host and cannot batch
    ones = np.ones(gt.e_pad, np.int32)
    got = _compile(TL, DIJKSTRA_GM).batch(
        gt, over={"src": np.arange(2, dtype=np.int32)}, dst=1, Len=ones)
    want = _compile(JL, DIJKSTRA_GM).batch(
        gj, over={"src": jax.numpy.arange(2, dtype=jax.numpy.int32)}, dst=1,
        Len=jax.numpy.asarray(ones))
    np.testing.assert_array_equal(got["_return"].numpy(),
                                  np.asarray(want["_return"]))
    np.testing.assert_array_equal(got["Parent"].numpy(),
                                  np.asarray(want["Parent"]))
    with pytest.raises(TL.LowerError, match="cannot batch"):
        _compile(TL, DFS).batch(gt, over={"s": np.arange(2, dtype=np.int32)})


# --------------------------------------------------------------------------
# Draws: JAX's threefry stream, site for site
# --------------------------------------------------------------------------

def test_fold_in_matches_jax():
    import jax.random as jr
    for cnt, site in [(0, 1), (5, 3), (2**32 - 1, 123456)]:
        kj = jr.fold_in(jr.fold_in(jr.PRNGKey(0), np.uint32(cnt)), site)
        kt = R.fold_in(R.fold_in(R.PRNGKey(0), cnt), site)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(R.uniform(kt, (64,)).numpy(),
                                      np.asarray(jr.uniform(kj, (64,))))


DRAW_PROGRAMS = {
    "draws": """
Proc draws(G: Graph; P: N_P<Double>) : Double {
    Foreach(v: G.Nodes) { v.P = Uniform(); }
    Return Uniform();
}""",
    # a traced While whose body draws in both branches of a traced If
    "while_if": """
Proc wdraw(G: Graph; P: N_P<Double>) : Double {
    Int i = 0;
    Double acc = 0.0;
    While (i < 5) {
        If (acc < 1.5) { acc += Uniform(); } Else { acc = acc - Uniform(); }
        Foreach(v: G.Nodes) { v.P += Uniform(); }
        i++;
    }
    Return acc + Uniform();
}""",
    # a do-while: the first pass runs before the loop, outside the trace
    "do_while": """
Proc ddraw(G: Graph; x: Double) : Int {
    Int k = 0;
    Do {
        x += Uniform();
        k++;
    } While (k < 3);
    Return (Int) (Uniform() * 1000.0);
}""",
    # a loop that never runs still numbers its draw sites
    "dead_loop": """
Proc zdraw(G: Graph; x: Double) : Double {
    Int i = 0;
    While (i < 0) { x += Uniform(); i++; }
    Return Uniform();
}""",
    # draws in a traced While's condition: numbered once, their counter
    # bumps dropped with the condition's environment
    "cond_draw": """
Proc cdraw(G: Graph; x: Double) : Int {
    Int i = 0;
    While (Uniform() < 0.9 && i < 20) { x += Uniform(); i++; }
    Return i;
}""",
    # per-slot masked While with a draw per pass
    "masked": """
Proc mdraw(G: Graph; acc: N_P<Double>) {
    N_P<Int> c;
    Foreach(n: G.Nodes) { n.c = (Int)(n % 4); }
    Foreach(n: G.Nodes) {
        While (n.c > 0) {
            n.acc += Uniform();
            n.c = n.c - 1;
        }
    }
}""",
    # host-eager loops renumber their sites on every pass: a map-driven
    # While, an Items loop, a DFS
    "eager_loops": """
Proc edraw(G: Graph, S: Node_Seq, r: Node; P: N_P<Double>) : Double {
    Map<Node, Int> M;
    M[r] = 1;
    Int i = 0;
    Double x = 0.0;
    While (M.Size() > 0 && i < 3) { x += Uniform(); i++; }
    For (v: S.Items) { v.P = Uniform(); x += Uniform(); }
    InDFS(v: G.Nodes From r)[v.P < 0.5] { v.P += Uniform(); }
    Return x;
}""",
    "pick": """
Proc picks(G: Graph; Q: N_P<Node>) : Node {
    Foreach(v: G.Nodes) {
        If (v.Degree() > 0) { v.Q = v.PickRandomNbr(); }
    }
    Return G.PickRandom();
}""",
}


def test_draws_float64_under_x64(g50):
    """With the float flag on, a draw is JAX's float64 uniform (52 bits of
    the 64 a lane), bit for bit."""
    gj, gt, _ = g50
    old = torch.get_default_dtype()
    try:
        with jax.enable_x64(True):
            oj = outputs_from_arrays(_compile(
                JL, DRAW_PROGRAMS["while_if"])(gj))
        torch.set_default_dtype(torch.float64)
        ot = _compile(TL, DRAW_PROGRAMS["while_if"])(gt)
    finally:
        torch.set_default_dtype(old)
    assert ot["P"].dtype == torch.float64
    assert_same(oj, ot)


@pytest.mark.parametrize("name", sorted(DRAW_PROGRAMS))
def test_draws_bit_for_bit(g50, name):
    kw = dict(S=[1, 4, 9], r=2) if name == "eager_loops" else {}
    out = check(DRAW_PROGRAMS[name], g50, rtol=0.0, **kw)
    if "P" in out:
        p = out["P"][:50].numpy()
        assert len(np.unique(p)) > 25


# --------------------------------------------------------------------------
# Collections, BFS, DFS, priority maps
# --------------------------------------------------------------------------

COLLECTIONS = """
Proc colls(G: Graph, S: Node_Seq, O: Node_Order, T: Node_Set,
           Q: Node_Seq; A: N_P<Int>) : Int {
    Int total = 0;
    For (v: S.Items) { v.A += 1; total += 1; Q.PushBack(v); }
    For (w: O.Items) { w.A += 10; Q.PushFront(w); }
    For (u: T.Items) { u.A += 100; }
    Foreach (n: G.Nodes)(n.A > 5) { T.Add(n); }
    Return total * 1000 + Q.Size() * 10 + T.Size();
}
"""

CHAIN = """
Proc chain(G: Graph, b, e: Node, prev: N_P<Node>, Q: Node_Seq) {
    Node t = e;
    While (t != b) {
        Q.PushFront(t);
        t = t.prev;
    }
    Q.PushFront(b);
}
"""

ARGMIN = """
Proc best(G: Graph, A: N_P<Int>; x: Int, who: Node, big: Bool) {
    x = +INF;
    Foreach(n: G.Nodes)(n.Degree() > 0) {
        <x; who, big> min= <n.A; n, n.A > 10>;
    }
}
"""

BFS_NAV = """
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

BFS_T = """
Proc revreach(G: Graph, root: Node; vis: N_P<Int>) {
    G.vis = 0;
    InBFS(v: G^.Nodes From root) {
        v.vis = 1;
    }
}
"""

DFS = """
Proc dfs(G: Graph, s: Node; A: N_P<Int>, B: N_P<Int>) {
    Int t = 0;
    G.A = -1;
    G.B = -1;
    InDFS(v: G.Nodes From s)[v != s + 7] {
        v.A = t;
        t++;
    } InPost {
        v.B = t;
        t++;
    }
}
"""


def test_collections(g100):
    gj, gt, _ = g100
    nset = np.zeros(gt.n_pad, bool)
    nset[[2, 4, 9]] = True
    check(COLLECTIONS, g100, S=[1, 3, 5], O=[7, 3, 7, 8], T=nset)


def test_collection_values_cross_whole(g100):
    """A JAX output's NodeSeq, NodeOrder, NodeSet and DenseNodeMap cross
    into the port's types with every field."""
    from green_marl_tpu.runtime import collections as JC
    seq = JC.NodeSeq.empty(8).push_back(3).push_front(5)
    order = JC.NodeOrder.empty(8, 16).push_back(2).push_back(2)
    m = JC.DenseNodeMap.empty(16).set(4, 9).add(6, 2)
    s = JC.NodeSet.empty(16).add(7)
    tseq = TC.NodeSeq.empty(8).push_back(3).push_front(5)
    torder = TC.NodeOrder.empty(8, 16).push_back(2).push_back(2)
    tm = TC.DenseNodeMap.empty(16).set(4, 9).add(6, 2)
    ts = TC.NodeSet.empty(16).add(7)
    a = outputs_from_arrays(dict(q=seq, o=order, m=m, s=s))
    assert_same(a, dict(q=tseq, o=torder, m=tm, s=ts))
    assert value_from_arrays(np.int32(3)).dtype == torch.int32
    np.testing.assert_array_equal(tseq.items()[:2].numpy(), [5, 3])
    assert int(tm.min_key()) == 6 and int(torder.seq.count) == 1


def test_traced_sequence_carry(g100):
    prev = np.full(g100[1].n_pad, -1, np.int32)
    prev[9] = 7
    prev[7] = 5
    out = check(CHAIN, g100, b=5, e=9, prev=prev)
    q = out["Q"]
    np.testing.assert_array_equal(q.items()[: int(q.count)].numpy(),
                                  [5, 7, 9])


def test_traced_if_merges_sequences(g100):
    """A traced If that pushes onto a sequence merges both branches'
    sequences leaf by leaf."""
    out = check("""
Proc seqif(G: Graph, a, b: Node, Q: Node_Seq, O: Node_Order) : Int {
    Int i = 0;
    While (i < 6) {
        If (i % 2 == 0) { Q.PushBack(a); O.PushBack(b); }
        Else { Q.PushFront(b); O.PushBack(a); }
        i++;
    }
    Return Q.Size();
}""", g100, a=3, b=8, Q=[], O=[])
    assert int(out["_return"]) == 6


def test_scalar_argmin_payload(g100):
    check(ARGMIN, g100, A=((np.arange(128) * 37) % 101).astype(np.int32))


@pytest.mark.parametrize("text,kw", [
    (BFS_NAV, "nav"),
    (BFS_T, "root"),
    (DFS, "dfs"),
], ids=["inbfs_navigator_inreverse", "transposed_bfs", "dfs"])
def test_bfs_and_dfs(g100, text, kw):
    n_pad = g100[1].n_pad
    args = {"nav": dict(root=0, ok=(np.arange(n_pad) % 7 != 3)),
            "root": dict(root=5), "dfs": dict(s=0)}[kw]
    out = check(text, g100, **args)
    if text is DFS:
        assert (out["A"][:100] >= 0).sum() > 1


def _dijkstra_host(g, w, src):
    import heapq
    begin = g.begin.numpy()
    d_ = g.node_idx.numpy()
    dist = np.full(g.num_nodes, np.inf)
    dist[src] = 0
    pq = [(0, src)]
    while pq:
        du, u = heapq.heappop(pq)
        if du > dist[u]:
            continue
        for k in range(begin[u], begin[u + 1]):
            nd = du + w[k]
            if nd < dist[d_[k]]:
                dist[d_[k]] = nd
                heapq.heappush(pq, (nd, d_[k]))
    return dist


@pytest.mark.parametrize("src,dst", [(0, 37), (1, 7), (2, 99)])
def test_priority_while_matches_jax_and_dijkstra(g100, src, dst):
    gt = g100[1]
    w = np.zeros(gt.e_pad, np.int32)
    w[: gt.num_edges] = np.random.default_rng(3).integers(
        1, 9, gt.num_edges)
    out = check(DIJKSTRA_GM, g100, Len=w, src=src, dst=dst)
    dist = _dijkstra_host(gt, w, src)
    want = -1 if np.isinf(dist[dst]) else int(dist[dst])
    assert int(out["_return"]) == want


@pytest.mark.parametrize("src,dst", [(0, 37), (3, 3), (1, 99)])
def test_bidir_while_matches_jax(g100, src, dst):
    gt = g100[1]
    w = np.zeros(gt.e_pad, np.int32)
    w[: gt.num_edges] = np.random.default_rng(4).integers(
        1, 9, gt.num_edges)
    check(BIDIR_GM, g100, Weight=w, src=src, dst=dst)


# --------------------------------------------------------------------------
# What JAX refuses, the port refuses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("text,kw,frag", [
    ("""
Proc r(G: Graph) : Int {
    Int i = 0;
    While (i < 3) { i++; If (i == 2) { Return i; } }
    Return 0;
}""", {}, "Return inside While"),
    ("""
Proc r(G: Graph, S: Node_Seq; A: N_P<Int>) {
    Int i = 0;
    While (i < 2) { For (v: S.Items) { v.A += 1; } i++; }
}""", dict(S=[1, 2]), "traced loop"),
    ("""
Proc r(G: Graph; c: N_P<Int>) {
    Int i = 0;
    While (i < 2) {
        Foreach(n: G.Nodes) { Foreach(s: n.Nbrs) {
            Foreach(w: s.Nbrs) { n.c += 1; } } }
        i++;
    }
}""", {}, "traced loop"),
], ids=["return_in_while", "items_in_traced_loop", "wedge_in_traced_loop"])
def test_same_lower_errors(g100, text, kw, frag):
    gj, gt, _ = g100
    with pytest.raises(JL.LowerError, match=frag):
        _compile(JL, text)(gj, **kw)
    with pytest.raises(TL.LowerError, match=frag):
        _compile(TL, text)(gt, **kw)


def test_nil_and_out_of_range_ids(g100):
    """Reads through NIL wrap to the last padded row and clamp, writes and
    reductions to NIL or past the rows are dropped, as JAX's gathers and
    scatters do."""
    n_pad = g100[1].n_pad
    p = np.where(np.arange(n_pad) % 4 == 0, -1,
                 (np.arange(n_pad) * 7) % (n_pad + 9)).astype(np.int32)
    check("""
Proc nil(G: Graph, p: N_P<Node>, A: N_P<Int>, S: Node_Set;
         B: N_P<Int>, C: N_P<Int>, D: N_P<Int>) {
    Foreach(n: G.Nodes) {
        Node q = n.p;
        n.B = q.A;
        q.C = 1;
        q.D += n.A;
        S.Add(q);
    }
}""", g100, p=p, A=(np.arange(n_pad) % 11).astype(np.int32))


def test_node_set_property_cap():
    """N_P<Node_Set> is a bit matrix of at most 8192 nodes, in both."""
    from green_marl_tpu.graph.binary_io import load_graph as jload
    from green_marl_tpu_torch.graph.binary_io import load_graph
    text = """
Proc pf(G: Graph; F: N_P<Node_Set>) {
    Foreach(v: G.Nodes) { Foreach(u: v.Nbrs) { v.F.Add(u); } }
}"""
    gj = jload(PARITY10K)[0]
    gt = load_graph(PARITY10K)[0]
    with pytest.raises(JL.LowerError, match="8192"):
        _compile(JL, text)(gj)
    with pytest.raises(TL.LowerError, match="8192"):
        _compile(TL, text)(gt)


def test_node_set_property_small(g100):
    check("""
Proc pf(G: Graph; F: N_P<Node_Set>) {
    Foreach(v: G.Nodes) { Foreach(u: v.Nbrs)(u != v) { v.F.Add(u); } }
}""", g100)


def test_typecheck_errors_match(g100):
    bad = "Procedure foo(G: Graph) { Int x; x = True; }"
    with pytest.raises(JGMTypeError) as ej:
        JL.compile_source(bad)
    with pytest.raises(GMTypeError) as et:
        TL.compile_source(bad)
    assert ej.value.errors == et.value.errors


def test_eager_scalar_neighbor_loop_snapshot(g100):
    """An order-dependent body over a scalar node's neighbours retries
    eagerly from the snapshot: the += before the failing statement counts
    once."""
    text = """
Proc seqfold(G: Graph, r: Node, Q: Node_Seq) : Int {
    Int k = 0;
    For (w: r.Nbrs) {
        k += 1;
        Q.PushBack(w);
    }
    Return k + Q.Size() * 1000;
}"""
    out = check(text, g100, r=0, Q=[])
    deg = int(g100[1].begin[1] - g100[1].begin[0])
    assert deg > 0 and int(out["_return"]) == deg * 1001


# --------------------------------------------------------------------------
# Foreign [ C++ ] escapes (test_foreign.py, inline)
# --------------------------------------------------------------------------

FOREIGN = {
    "expr_math": ("""
Procedure P(G: Graph, y: Double; out: Double) {
    out = [sin($y) / 2];
}""", dict(y=1.25)),
    "stmt_mutation": ("""
Procedure P(G: Graph, y: Double; x: Double) {
    [$x = $y * 3.0 + 1.0] ::[x];
}""", dict(y=2.0)),
    "int_types": ("""
Procedure P(G: Graph, k: Int; r: Int) {
    [$r = ($k << 3) | 5] ::[r];
}""", dict(k=9)),
    "field_ref_sequential": ("""
Procedure P(G: Graph, A: N_P<Int>, n: Node; x: Double, B: N_P<Int>) {
    [$x = (double)$n.A] ::[x];
    [$n.B = 777] ::[n.B];
}""", dict(A=np.arange(128, dtype=np.int32) * 3, n=7)),
    "b9_like": ("""
Procedure b9(G: Graph, s: Node, k: Double, A: N_P<Int>) {
    Double z = [sin(k) / 2];
    [printf("")];
    [$s.A = printf("%d", (int)($z * 0))] ::[s.A];
}""", dict(s=3, k=1.0)),
    "stmt_in_foreach": ("""
Procedure Q(G: Graph, A: N_P<Int>; B: N_P<Int>, total: Double) {
    total = 0.0;
    Foreach (t: G.Nodes) {
        [$t.B = $t.A * 2 + 1] ::[t.B];
        [$total += (double)$t.A] ::[total];
    }
}""", dict(A=(np.arange(128, dtype=np.int32) * 5) % 17)),
    "expr_in_foreach": ("""
Procedure R(G: Graph, A: N_P<Int>; B: N_P<Double>) {
    Foreach (t: G.Nodes) {
        t.B = [cos((double)$t.A) + 1.0];
    }
}""", dict(A=np.arange(128, dtype=np.int32) % 7)),
    "nested_neighbor": ("""
Procedure S(G: Graph, A: N_P<Int>; C: N_P<Int>, tot: Long) {
    tot = 0;
    Foreach (n: G.Nodes) {
        Foreach (s: n.Nbrs) {
            [$tot += $s.A + ($n == $s ? 1 : 0)] ::[tot];
        }
    }
}""", dict(A=np.arange(128, dtype=np.int32) % 11)),
    "refs_survive_optimizer": ("""
Procedure P(G: Graph; y: Double) {
    Double x;
    x = 5.0;
    y = 2.0 * [1.0 + $x];
    x = 9.0;
}""", {}),
    "wedge": ("""
Procedure W(G: Graph, A: N_P<Int>; y: Double) {
    y = 0.0;
    Foreach (n: G.Nodes) {
        Foreach (s: n.Nbrs) {
            Foreach (w: s.Nbrs) {
                [$y += (double)$w.A] ::[y];
            }
        }
    }
}""", dict(A=np.arange(128, dtype=np.int32) % 5)),
}


@pytest.mark.skipif(not HAVE_GXX, reason="no g++")
@pytest.mark.parametrize("name", sorted(FOREIGN))
def test_foreign(g50, name):
    text, kw = FOREIGN[name]
    check(text, g50, rtol=1e-6, **kw)


@pytest.mark.skipif(not HAVE_GXX, reason="no g++")
def test_foreign_printf(g50, capfd):
    _compile(TL, """
Procedure P(G: Graph) {
    [printf("gm foreign hello %d\\n", 42)];
}""")(g50[1])
    assert "gm foreign hello 42" in capfd.readouterr().out


@pytest.mark.skipif(not HAVE_GXX, reason="no g++")
@pytest.mark.parametrize("text,frag", [
    ("""
Procedure P(G: Graph, y: Double; x: Double) {
    [$x = my_undefined_function($y)] ::[x];
}""", "compile"),
    ("""
Procedure M(G: Graph, A: N_P<Int>; B: N_P<Int>) {
    Foreach (t: G.Nodes) {
        Int x;
        x = t.A;
        [$t.B = 1] ::[x];
    }
}""", "not supported|not a host"),
], ids=["compile_error", "bad_mutation_target"])
def test_foreign_errors(g50, text, frag):
    gj, gt, _ = g50
    kw = {"y": 1.0} if "y: Double" in text else {
        "A": np.zeros(64, np.int32)}
    with pytest.raises(JL.LowerError, match=frag):
        _compile(JL, text)(gj, **kw)
    with pytest.raises(TL.LowerError, match=frag):
        _compile(TL, text)(gt, **kw)


# --------------------------------------------------------------------------
# The CLI: make_custom, adamicAdar and b2, the literal routes
# --------------------------------------------------------------------------

def _cli(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return [ln for ln in out.splitlines() if "time=" not in ln]


def test_make_custom_local_clustering(capsys):
    from green_marl_tpu.cli import apps as japps
    from green_marl_tpu_torch.cli import apps
    gm = os.path.join(REPO, "doc", "examples", "local_clustering.gm")
    want = _cli(capsys, japps.main, [gm, PARITY10K])
    got = _cli(capsys, apps.main, [gm, "-GMDevice=cpu", PARITY10K])
    assert got == want and any(ln.startswith("CRC C ") for ln in got)


def test_make_custom_multi_device_not_ported(monkeypatch, capsys):
    """make_custom -GMNumChips=2 (the vertex-sharded lowering) as the JAX
    CLI runs it: the same lines, or, where the program is infeasible
    sharded (local_clustering's two-hop body), the same LowerError."""
    from green_marl_tpu.cli import apps as japps
    from green_marl_tpu_torch.cli import apps
    monkeypatch.setenv("GM_TORCH_VIRTUAL_DEVICES", "2")
    gm = os.path.join(REPO, "doc", "examples", "local_clustering.gm")
    outcomes = []
    for main, dev in ((japps.main, []), (apps.main, ["-GMDevice=cpu"])):
        try:
            outcomes.append(("ok", _cli(capsys, main, [gm] + dev + [
                "-GMNumChips=2", PARITY10K])))
        except (JL.LowerError, TL.LowerError) as e:
            capsys.readouterr()
            outcomes.append(("LowerError", str(e)))
    assert outcomes[1] == outcomes[0]


def test_make_custom_ebin_input_property(tmp_path, capsys):
    from green_marl_tpu.cli import apps as japps
    from green_marl_tpu.graph import binary_io as jbio
    from green_marl_tpu_torch.cli import apps
    raw = jbio.load_binary(PARITY10K)
    lens = np.random.default_rng(5).integers(1, 40, raw.num_edges) \
        .astype(np.int32)
    graph = str(tmp_path / "w.ebin")
    jbio.store_binary(graph, raw.begin, raw.node_idx, edge_props=[lens])
    gm = str(tmp_path / "sssp.gm")
    with open(gm, "w") as f:
        f.write(SSSP_GM.replace("dist:N_P<Int>, len:E_P<Int>, root: Node)",
                                "len:E_P<Int>, root: Node; dist:N_P<Int>,"
                                " tot: Long)")
                .replace("        fin = ! Exist(n: G.Nodes){n.updated};\n"
                         "    }\n",
                         "        fin = ! Exist(n: G.Nodes){n.updated};\n"
                         "    }\n    tot = Sum(n: G.Nodes)(n.dist < +INF)"
                         "{ n.dist };\n"))
    argv = ["-GMInputFormat=EBIN", "-root=3", graph]
    want = _cli(capsys, japps.main, [gm] + argv)
    got = _cli(capsys, apps.main, [gm, "-GMDevice=cpu"] + argv)
    assert got == want and any(ln.startswith("tot = ") for ln in got)
    with pytest.raises(SystemExit, match="'len' is not present"):
        apps.main([gm, "-GMDevice=cpu", PARITY10K])


@pytest.mark.parametrize("app", ["adamicAdar", "b2"])
def test_reference_apps_absent_source_fails(app, tmp_path, monkeypatch):
    """Without the reference's source both CLIs fail on the missing file
    (the port names the path it looked for) and run nothing else."""
    from green_marl_tpu_torch.cli import apps
    monkeypatch.setattr(apps, "REFERENCE_APPS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=f"{app}.gm"):
        apps.main([app, "-GMDevice=cpu", PARITY10K])
    monkeypatch.setattr(apps, "REFERENCE_APPS", "")
    with pytest.raises(FileNotFoundError, match="GM_REFERENCE_APPS"):
        apps.main([app, "-GMDevice=cpu", PARITY10K])


def _small_bin(tmp_path):
    from green_marl_tpu.graph import binary_io as jbio
    gj, gt, _ = _graphs(100, 600, 5)
    path = str(tmp_path / "g100.bin")
    jbio.store_binary(path, np.asarray(gj.begin),
                      np.asarray(gj.node_idx)[: gj.num_edges])
    return path, gj


TARJAN_LIKE = """
Procedure tarjan_scc(G: Graph; SCC: N_P<Node>) {
    N_P<Bool> InStack;
    N_P<Int> LowLink;
    N_P<Int> Index;
    Node_Seq Stack;
    Int n = 0;
    G.SCC = NIL;
    G.InStack = False;
    G.Index = -1;
    For (t: G.Nodes)(t.Index == -1) {
        InDFS(v: G.Nodes From t)[v.Index == -1] {
            v.Index = n;
            v.LowLink = n;
            n++;
            Stack.PushBack(v);
            v.InStack = True;
        } InPost {
            For (w: v.Nbrs)(w.InStack) {
                v.LowLink = (v.LowLink < w.LowLink) ? v.LowLink
                                                    : w.LowLink;
            }
            If (v.LowLink == v.Index) {
                Node w = Stack.PopBack();
                w.InStack = False;
                w.SCC = v;
                While (w != v) {
                    w = Stack.PopBack();
                    w.InStack = False;
                    w.SCC = v;
                }
            }
        }
    }
}
"""


def test_literal_tarjan_route(tmp_path, monkeypatch, capsys):
    from green_marl_tpu_torch.cli import apps
    graph, gj = _small_bin(tmp_path)
    src = tmp_path / "tarjan_scc.gm"
    src.write_text(TARJAN_LIKE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(JL.compile_file(str(src))(gj)["SCC"])[:100]
    monkeypatch.setattr(apps, "REFERENCE_APPS", str(tmp_path))
    ran = []
    real = apps._compile_reference
    monkeypatch.setattr(apps, "_compile_reference",
                        lambda app: ran.append(app) or real(app))
    lines = _cli(capsys, apps.main, ["tarjan_scc", "-GMDevice=cpu",
                                     "-GMDumpValues=100", graph])
    assert ran == ["tarjan_scc"]
    assert f"num_membership = {len(np.unique(want))}" in lines
    got = [int(ln.split(" = ")[1]) for ln in lines if ln.startswith("mem[")]
    np.testing.assert_array_equal(got, want)


def test_literal_bidir_route(tmp_path, monkeypatch, capsys):
    from green_marl_tpu_torch.cli import apps
    graph, gj = _small_bin(tmp_path)
    src = tmp_path / "bidir_dijkstra.gm"
    src.write_text(BIDIR_GM.replace("Procedure bidir(",
                                    "Procedure bidir_dijkstra("))
    monkeypatch.setattr(apps, "REFERENCE_APPS", str(tmp_path))
    ran = []
    real = apps._compile_reference
    monkeypatch.setattr(apps, "_compile_reference",
                        lambda app: ran.append(app) or real(app))
    for s, t in ((0, 37), (2, 99)):
        argv = [f"-src={s}", f"-dst={t}", graph]
        lines = _cli(capsys, apps.main, ["bidir_dijkstra", "-GMDevice=cpu"]
                     + argv)
        # the JAX package's compile_file of the same file gives the path
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            w = np.zeros(gj.e_pad, np.int32)
            from green_marl_tpu.utils.gm_rand import sssp_edge_lengths
            w[: gj.num_edges] = sssp_edge_lengths(gj.num_edges)
            out = JL.compile_file(str(src))(gj, Weight=w, src=s, dst=t)
        weight = lines[-1].split()[1]
        if bool(out["_return"]):
            par = np.asarray(out["Parent"])
            hops, cur = [t], t
            while cur != s:
                cur = int(par[cur])
                hops.append(cur)
            assert lines[-1].endswith(
                "".join(f"v{v}=>" for v in hops[::-1]))
        else:
            assert "NO_PATH_EXISTS" in lines[-1]
        # the fallback route (no source) finds the same path weight
        monkeypatch.setattr(apps, "REFERENCE_APPS", "")
        fb = _cli(capsys, apps.main, ["bidir_dijkstra", "-GMDevice=cpu"]
                  + argv)
        assert fb[-1].split()[1] == weight
        monkeypatch.setattr(apps, "REFERENCE_APPS", str(tmp_path))
    assert ran == ["bidir_dijkstra", "bidir_dijkstra"]
