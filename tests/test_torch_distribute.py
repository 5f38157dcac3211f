"""The port's vertex-sharded compiled path (``lang.lower_vertex``, the
``distribute`` placement) held against the JAX package's on the CPU, and a
two-process gloo run of ``parallel.multihost``.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``, the
port on 1, 3 or 8 CPU shards (threads of one process).  Both compile the
same inline ``.gm`` sources and run them on the same numpy graph; integers,
bools and bit planes must agree bit for bit, float sums within rtol 1e-5,
and every rejection raises the same ``LowerError`` text.  A JAX sharded run
costs seconds of tracing, so the port's runs at every shard count are held
against one JAX run: the JAX package's vertex-sharded run at 8 shards for
hop_dist, its single-device lowering (which its own tests hold its sharded
runs to) for the rest.  The edge-sharded path and the CLI are
in ``tests/test_torch_distribute_replicate.py``.
"""

import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from green_marl_tpu.graph import generate as gen
from green_marl_tpu.graph.csr import from_edges as jax_from_edges
from green_marl_tpu.lang import lower as JL
from green_marl_tpu.lang import lower_vertex as JLV

from green_marl_tpu_torch.graph import generate as tgen
from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.lang import lower as TL
from green_marl_tpu_torch.lang import lower_vertex as TLV
from green_marl_tpu_torch.models.pagerank import pagerank
from green_marl_tpu_torch.parallel import comm

from test_lower import HOP_DIST_GM, PAGERANK_GM
from test_torch_lower import SSSP_GM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY10K = os.path.join(REPO, "data", "parity", "parity10k.bin")
SHARDS = [1, 3, 8]

CONDUCT_GM = """
Procedure conduct(G: Graph, member: N_P<Int>, num: Int) : Float {
    Int Din, Dout, Cross;
    Din = Sum(u: G.Nodes)(u.member == num){ u.Degree() };
    Dout = Sum(u: G.Nodes)(u.member != num){ u.Degree() };
    Cross = Sum(u: G.Nodes)(u.member == num){
        Count(j: u.Nbrs)(j.member != num) };
    Float m = (Din < Dout) ? Din : Dout;
    If (m == 0) Return (Cross == 0) ? 0.0 : +INF;
    Else Return (Cross / m);
}
"""

AVG_TEEN_CNT_GM = """
Procedure avg_teen_cnt(G: Graph, age, teen_cnt: N_P<Int>, K: Int) : Float {
    Foreach(n: G.Nodes) {
        n.teen_cnt = Count(t: n.InNbrs)(t.age >= 10 && t.age < 20);
    }
    Float avg = (Float) Avg(n: G.Nodes)(n.age > K){ n.teen_cnt };
    Return avg;
}
"""

PATHS_GM = """
Procedure paths(G: Graph, root: Node, sigma: N_P<Float>,
                delta: N_P<Float>)
{
    G.sigma = 0;
    root.sigma = 1;
    InBFS(v: G.Nodes From root)(v != root) {
        v.sigma = Sum(w: v.UpNbrs){ w.sigma };
    } InReverse(v != root) {
        v.delta = Sum(w: v.DownNbrs){ w.delta + w.sigma };
    }
}
"""

REVREACH_GM = """
Procedure revreach(G: Graph, root: Node, vis: N_P<Int>)
{
    G.vis = 0;
    InBFS(v: G^.Nodes From root) {
        v.vis = 1;
    }
}
"""

FUSE3_GM = """
Procedure fuse3(G: Graph, A: N_P<Float>, B: N_P<Float>, C: N_P<Int>;
                OutP: N_P<Float>) {
  Foreach (t: G.Nodes) {
    t.OutP = Sum(w: t.InNbrs){ w.A + w.B * (Float) w.C };
  }
}
"""

FUSE4_GM = """
Procedure fuse4(G: Graph, A: N_P<Float>, M: N_P<Bool>;
                OutP: N_P<Float>, Cnt: N_P<Int>) {
  Foreach (t: G.Nodes) {
    t.OutP = Sum(w: t.InNbrs)(w.M){ w.A };
    t.Cnt = Count(w: t.InNbrs)(w.M);
  }
}
"""

ARGPICK_GM = """
Procedure argpick(G: Graph, w: N_P<Int>; best: Int, who: Node) {
    best = +INF;
    Foreach(n: G.Nodes) {
        <best; who> min= <n.w; n>;
    }
}
"""

PUSH_GM = """
Procedure push(G: Graph, A: N_P<Int>; S: N_P<Int>, X: N_P<Int>) {
    Foreach(n: G.Nodes) {
        Foreach(t: n.Nbrs) {
            n.S += t.A;
            n.X max= t.A;
        }
    }
}
"""


@pytest.fixture(scope="module")
def graphs():
    src, dst = gen.rmat_edges(200, 1200, seed=3)
    gj, _ = jax_from_edges(src, dst, 200)
    gt, _ = from_edges(src, dst, 200)
    return gj, gt


def _jmesh(S):
    return JMesh(np.asarray(jax.devices()[:S]), ("v",))


def _tmesh(S):
    return comm.Mesh([torch.device("cpu")] * S)


@pytest.fixture(scope="module", params=SHARDS, ids=[f"S{s}" for s in SHARDS])
def scheds(request, graphs):
    S = request.param
    gj, gt = graphs
    js = JLV.place_schedule(JLV.build_schedule(gj, S), _jmesh(S))
    ts = TLV.place_schedule(TLV.build_schedule(gt, S), _tmesh(S))
    return S, js, ts


def _args(g_pad_n, g_pad_e, name):
    rng = np.random.default_rng(0)
    if name == "pagerank":
        return dict(e=0.0, d=0.85, max=5)
    if name == "hop_dist":
        return dict(root=3)
    if name == "sssp":
        return dict(root=0, len=rng.integers(1, 10, g_pad_e).astype(np.int32))
    if name == "conduct":
        return dict(member=rng.integers(0, 3, g_pad_n).astype(np.int32),
                    num=1)
    return dict(K=4, age=rng.integers(5, 40, g_pad_n).astype(np.int32))


PROGRAMS = {"pagerank": PAGERANK_GM, "hop_dist": HOP_DIST_GM,
            "sssp": SSSP_GM, "conduct": CONDUCT_GM,
            "avg_teen_cnt": AVG_TEEN_CNT_GM}


def _compile(L, text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return L.compile_source(text)


def _match(want, got):
    assert set(want) == set(got)
    for k in want:
        a, b = np.asarray(want[k]), got[k].cpu().numpy()
        if a.ndim:
            b = b[: a.shape[0]]
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

def test_build_schedule_matches_jax(scheds):
    S, js, ts = scheds
    for f in TLV._SCHED_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("num_nodes", "num_edges", "num_shards", "L", "E_s", "cap",
              "ghost_total", "G", "Lh"):
        assert getattr(ts, f) == getattr(js, f), f
    pl = {"A": "replicate", "B": "distribute"}
    assert TLV.placement_report(ts) == JLV.placement_report(js)
    assert TLV.placement_report(ts, placements=pl) == \
        JLV.placement_report(js, placements=pl)


# ---------------------------------------------------------------------------
# run_vertex_sharded
# ---------------------------------------------------------------------------

_REF = {}


def jax_reference(graphs, key, text, sharded=None, **kw):
    """The JAX package's outputs of ``text`` (cached by ``key``): its
    single-device lowering, or ``sharded(cp, g, mesh=8 devices, **kw)``."""
    if key not in _REF:
        gj, _ = graphs
        cp = _compile(JL, text)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _REF[key] = (cp(gj, **kw) if sharded is None
                         else sharded(cp, gj, mesh=_jmesh(8), **kw))
    return _REF[key]


JAX_SHARDED = ("hop_dist",)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_run_vertex_sharded_matches_jax(scheds, graphs, name):
    S, js, ts = scheds
    gj, gt = graphs
    kw = _args(gj.n_pad, gj.e_pad, name)
    want = jax_reference(
        graphs, ("distribute", name), PROGRAMS[name],
        JLV.run_vertex_sharded if name in JAX_SHARDED else None, **kw)
    got = TLV.run_vertex_sharded(_compile(TL, PROGRAMS[name]), gt,
                                 mesh=_tmesh(S), sched=ts, **kw)
    _match(want, got)


def test_vertex_sharded_pagerank_equals_one_device(graphs):
    """Destination-owner placement keeps each vertex's in-edges in one
    slice: fixed-iteration ranks equal the single-device lowering's bit for
    bit, as in the JAX package."""
    _, gt = graphs
    cp = _compile(TL, PAGERANK_GM)
    ref = cp(gt, e=0.0, d=0.85, max=5)["pg_rank"]
    got = TLV.run_vertex_sharded(cp, gt, mesh=_tmesh(8), e=0.0, d=0.85,
                                 max=5)["pg_rank"]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("S", [3, 8])
@pytest.mark.parametrize("text", [PATHS_GM, REVREACH_GM],
                         ids=["inbfs", "transposed_inbfs"])
def test_inbfs_vertex_sharded_matches_jax(graphs, text, S):
    """InBFS (forward + InReverse, UpNbrs/DownNbrs) and the BFS over G^:
    the level-sync expansion with one exchange (or reverse combine) per
    level, then the per-level replay over [L] owned contexts."""
    _, gt = graphs
    want = jax_reference(graphs, ("single", text), text, root=0)
    got = TLV.run_vertex_sharded(_compile(TL, text), gt, root=0,
                                 mesh=_tmesh(S))
    _match(want, got)


@pytest.mark.parametrize("text", [ARGPICK_GM, PUSH_GM],
                         ids=["scalar_argmin_agreement", "reverse_combine"])
def test_winner_agreement_and_reverse_combine(graphs, text):
    """A scalar argmin's payload is agreed across shards; reductions into a
    loop's ghost endpoint go back to their owner (the message combiner)."""
    gj, gt = graphs
    rng = np.random.default_rng(4)
    name = "w" if text is ARGPICK_GM else "A"
    kw = {name: rng.integers(0, 7, gj.n_pad).astype(np.int32)}
    want = jax_reference(graphs, ("single", text), text, **kw)
    got = TLV.run_vertex_sharded(_compile(TL, text), gt, mesh=_tmesh(8),
                                 **kw)
    _match(want, got)


# ---------------------------------------------------------------------------
# Fused halo exchanges and per-array placements
# ---------------------------------------------------------------------------

def _fuse_inputs(gj, seed, names):
    rng = np.random.default_rng(seed)
    out = {}
    for n in names:
        if n == "C":
            out[n] = rng.integers(0, 5, gj.n_pad).astype(np.int32)
        elif n == "M":
            out[n] = rng.integers(0, 2, gj.n_pad).astype(bool)
        else:
            out[n] = rng.random(gj.n_pad).astype(np.float32)
    return out


def test_fused_halo_exchange_counts(graphs):
    """k properties read at the ghost endpoint of one superstep ride ONE
    exchange (the congruent-message merge): the JAX package's count,
    through ``stats``."""
    gj, gt = graphs
    kw = _fuse_inputs(gj, 11, "ABC")
    js, ts = {}, {}
    want = JLV.run_vertex_sharded(_compile(JL, FUSE3_GM), gj,
                                  mesh=_jmesh(8), stats=js, **kw)
    got = TLV.run_vertex_sharded(_compile(TL, FUSE3_GM), gt, mesh=_tmesh(8),
                                 stats=ts, **kw)
    _match(want, got)
    assert ts["exchanges"] == js["exchanges"] == 1


def test_fused_halo_exchange_foreach_stmt(graphs):
    """The statement form, mixed dtypes (Bool on the wire as an int32):
    the second reduce finds M's halo fresh, so one exchange in all (the
    count the JAX package's test asserts)."""
    gj, gt = graphs
    kw = _fuse_inputs(gj, 12, "AM")
    want = jax_reference(graphs, ("single", FUSE4_GM), FUSE4_GM, **kw)
    ts = {}
    got = TLV.run_vertex_sharded(_compile(TL, FUSE4_GM), gt, mesh=_tmesh(8),
                                 stats=ts, **kw)
    _match(want, got)
    assert ts["exchanges"] == 1


def test_placement_overrides(graphs):
    """Replicated read-only inputs are filled at bind time and never ride
    the exchange (0 exchanges); a partial pin still fuses the rest into
    one; the outputs do not change."""
    gj, gt = graphs
    kw = _fuse_inputs(gj, 13, "ABC")
    cp = _compile(TL, FUSE3_GM)
    base = TLV.run_vertex_sharded(cp, gt, mesh=_tmesh(8), **kw)["OutP"]
    for pl, n in (({"A": "replicate", "B": "replicate", "C": "replicate"},
                   0), ({"A": "replicate", "B": "distribute"}, 1)):
        ts = {}
        got = TLV.run_vertex_sharded(cp, gt, mesh=_tmesh(8), stats=ts,
                                     placements=pl, **kw)["OutP"]
        assert torch.equal(got, base) and ts["exchanges"] == n, pl


# ---------------------------------------------------------------------------
# Rejections: the same LowerError text as the JAX package
# ---------------------------------------------------------------------------

REJECTED_VERTEX = {
    "collections": ("""
Procedure colls(G: Graph, root: Node; cnt: Int) {
    Node_Set S;
    S.Add(root);
    cnt = S.Size();
}""", dict(root=0)),
    "nested_neighbors": ("""
Procedure tri(G: Graph) : Long {
    Long T = 0;
    Foreach(v: G.Nodes) {
        Foreach(u: v.Nbrs)(u > v) {
            Foreach(w: u.Nbrs)(w > u) { T += 1; }
        }
    }
    Return T;
}""", {}),
    "random_scatter": ("""
Procedure rs(G: Graph; m: N_P<Int>) {
    Foreach(n: G.Nodes) {
        Foreach(t: n.Nbrs) { t.m = 1; }
    }
}""", {}),
    "enclosing_local": ("""
Procedure loc(G: Graph; out: N_P<Int>) {
    Foreach(n: G.Nodes) {
        Int c = 0;
        Foreach(t: n.InNbrs) { c += 1; }
        n.out = c;
    }
}""", {}),
    "rng": ("""
Procedure rnd(G: Graph; x: N_P<Double>) {
    Foreach(n: G.Nodes) { n.x = Uniform(); }
}""", {}),
    "dfs": ("""
Procedure dfs(G: Graph, root: Node; x: N_P<Int>) {
    InDFS(v: G.Nodes From root) { v.x = 1; }
}""", dict(root=0)),
    "random_read": ("""
Procedure hr(G: Graph, root: Node; x: N_P<Bool>) {
    Foreach(n: G.Nodes) { n.x = n.HasEdgeTo(root); }
}""", dict(root=0)),
}


def same_error(jrun, trun):
    with pytest.raises(JL.LowerError) as je:
        jrun()
    with pytest.raises(TL.LowerError) as te:
        trun()
    assert str(te.value) == str(je.value)
    return str(te.value)


@pytest.mark.parametrize("name", list(REJECTED_VERTEX))
def test_vertex_rejections_match_jax(graphs, name):
    gj, gt = graphs
    text, kw = REJECTED_VERTEX[name]
    assert same_error(
        lambda: JLV.run_vertex_sharded(_compile(JL, text), gj,
                                       mesh=_jmesh(8), **kw),
        lambda: TLV.run_vertex_sharded(_compile(TL, text), gt,
                                       mesh=_tmesh(8), **kw))


@pytest.mark.parametrize("pl,frag", [
    ({"len": "hugepage"}, "unknown placement policy"),
    ({"nope": "replicate"}, "unknown array"),
    ({"len": "replicate"}, "cannot be replicated")])
def test_placement_override_rejections(graphs, pl, frag):
    gj, gt = graphs
    w = (np.arange(gj.e_pad) % 9 + 1).astype(np.int32)
    msg = same_error(
        lambda: JLV.run_vertex_sharded(_compile(JL, SSSP_GM), gj, root=0,
                                       len=w, mesh=_jmesh(8),
                                       placements=pl),
        lambda: TLV.run_vertex_sharded(_compile(TL, SSSP_GM), gt, root=0,
                                       len=w, mesh=_tmesh(8),
                                       placements=pl))
    assert frag in msg


def test_written_property_cannot_be_replicated(graphs):
    gj, gt = graphs
    src = """
Procedure wrt(G: Graph, A: N_P<Int>; OutP: N_P<Int>) {
  Foreach (t: G.Nodes) { t.A = 1; t.OutP = t.A; }
}
"""
    a = np.zeros(gj.n_pad, np.int32)
    msg = same_error(
        lambda: JLV.run_vertex_sharded(_compile(JL, src), gj, A=a,
                                       mesh=_jmesh(8),
                                       placements={"A": "replicate"}),
        lambda: TLV.run_vertex_sharded(_compile(TL, src), gt, A=a,
                                       mesh=_tmesh(8),
                                       placements={"A": "replicate"}))
    assert "is written" in msg


# ---------------------------------------------------------------------------
# Two processes over gloo
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pagerank_matches_single_host():
    """2 processes x 2 CPU shards run pagerank_vsharded over one global
    mesh (gloo collectives); every row each process owns equals the JAX
    package's single-device pagerank on the same graph, within rtol 1e-5."""
    from green_marl_tpu.models.pagerank import pagerank as jax_pagerank

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "green_marl_tpu_torch.parallel."
         "multihost_worker", str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    n = 400
    src, dst = gen.rmat_edges(n, 3000, seed=7)
    gj, _ = jax_from_edges(src, dst, n)
    ref = jax_pagerank(gj, e=1e-9, d=0.85, max_iter=30)
    ref_rank = np.asarray(ref.rank)[:n]
    rows = 0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"MH pid={pid}")]
        assert line, out[-2000:]
        it = int(line[0].split("it=")[1].split()[0])
        base = int(line[0].split("base=")[1].split()[0])
        got = np.array([float(x) for x in
                        line[0].split("local=[")[1].rstrip("]").split()])
        assert it == int(ref.iterations)
        assert base == pid * len(got)
        owned = got[:n - base]      # rows past N are the mesh's padding
        np.testing.assert_allclose(owned, ref_rank[base:base + len(owned)],
                                   rtol=1e-5, atol=0.0)
        assert not got[len(owned):].any()
        rows += len(owned)
    assert rows == n
