"""The ports of the hot-path probes (``probes.twitter_scale``,
``probes.bfs``, ``probes.prep``) against the JAX package on the CPU.

* ``probes.twitter_scale --smoke`` (N=2^15, E=2^18, B=1024,
  plane_bits=8): the fused and the paged bit BFS agree, and both equal the
  JAX package's ``multi_source_bfs_bits`` on the same schedule and roots,
  levels and each instance's ``traversed`` exactly.
* ``probes.bfs`` at a small size: the pull sweep equals JAX's
  ``segment_sum_by_offsets(...) > 0``, ``_push_expand`` at each cap equals
  JAX's bit for bit, and the auto BFS's levels and reached count equal
  JAX's ``bfs``.
* ``probes.prep`` at a small size prints every stage; ``to_binned(deg)``
  equals JAX's.
* Asked for ``cuda`` without a card, each exits non-zero.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from green_marl_tpu.graph.csr import from_edges as jax_from_edges
from green_marl_tpu.models import batched as JB
from green_marl_tpu.models import bfs as JBFS
from green_marl_tpu.ops import binned as JBIN
from green_marl_tpu.ops import scan_reduce as JSR

from green_marl_tpu_torch.graph import native
from green_marl_tpu_torch.models import bfs as TBFS
from green_marl_tpu_torch.probes import bfs as PB
from green_marl_tpu_torch.probes import prep as PP
from green_marl_tpu_torch.probes import twitter_scale as TW

CPU = torch.device("cpu")
BFS_N, BFS_E = 20_000, 200_000


# -- the Twitter-class bit BFS -----------------------------------------------

@pytest.fixture(scope="module")
def twitter_smoke():
    n, e = TW.SMOKE
    bp, deg_rows, out_deg, _ = TW.prepare(n, e)
    roots = TW.top_roots(out_deg)
    keep = {}
    res = TW.run(bp, deg_rows, roots, CPU, reps=1, keep=keep)
    return bp, deg_rows, out_deg, roots, res, keep


def test_twitter_smoke_fused_equals_paged(twitter_smoke):
    *_, res, keep = twitter_smoke
    assert res["equal"]
    assert res["fused"]["levels"] == res["paged"]["levels"] > 1
    assert res["fused"]["traversed"] == res["paged"]["traversed"] > 0
    lf, tf, rf, vf = keep["fused"]
    lp, tp, rp, vp = keep["paged"]
    assert lf == lp and np.array_equal(tf, tp) and np.array_equal(rf, rp)
    assert torch.equal(vf, vp) and vf.shape[1] == TW.B // TW.PLANE_BITS


def test_twitter_smoke_equals_jax(twitter_smoke):
    from green_marl_tpu.graph import generate as jgen
    bp, deg_rows, out_deg, roots, _, keep = twitter_smoke
    n, e = TW.SMOKE
    src, dst = jgen.uniform_random_edges(n, e, seed=TW.SEED)
    jg, _ = jax_from_edges(src.astype(np.int32), dst.astype(np.int32), n)
    jbp = JBIN.build_binned(np.asarray(jg.r_begin),
                            np.asarray(jg.r_node_idx)[:e], n, jg.e_pad)
    np.testing.assert_array_equal(np.asarray(jbp.slot_src),
                                  bp.slot_src.numpy())
    jdeg = np.zeros(jbp.n_rows, np.int32)
    jdeg[: jbp.n_nodes] = np.asarray(jbp.to_binned(
        jnp.asarray(np.bincount(src, minlength=n).astype(np.int32))))
    np.testing.assert_array_equal(jdeg, deg_rows)
    res = JB.multi_source_bfs_bits(jbp, jnp.asarray(roots), jnp.asarray(jdeg),
                                   plane_bits=TW.PLANE_BITS)
    levels, trav, _, _ = keep["fused"]
    assert int(res.levels_run) == levels
    np.testing.assert_array_equal(np.asarray(res.traversed).astype(np.int64),
                                  trav)


def test_twitter_probe_main_smoke(capsys):
    assert TW.main(["--smoke", "--device", "cpu", "--variants",
                    "fused,paged"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# card: ")
    rec = json.loads(out[-1])
    assert rec["equal"] and rec["b"] == 1024 and rec["plane_bits"] == 8
    for v in TW.VARIANTS:
        assert {"levels", "traversed", "time_ms", "agg_gteps",
                "run_times_ms", "device_ms", "peak_gb"} <= set(rec[v])
        assert rec[v]["device_ms"] is None and rec[v]["peak_gb"] is None


def test_twitter_probe_wants_past_2_24():
    with pytest.raises(SystemExit) as e:
        TW.main(["1000", "5000", "--device", "cpu"])
    assert "2^24" in str(e.value.code)


# -- the single-source BFS phases -------------------------------------------

@pytest.fixture(scope="module")
def bfs_graphs():
    src, dst = native.rmat_edges(BFS_N, BFS_E, seed=PB.LJ_SEED)
    g, out_deg, _ = PB.host_graph(BFS_N, BFS_E)
    jg, _ = jax_from_edges(src, dst, BFS_N)
    np.testing.assert_array_equal(np.asarray(jg.r_node_idx),
                                  g.r_node_idx.numpy())
    return g, out_deg, jg


def test_pull_sweep_equals_jax(bfs_graphs):
    g, _, jg = bfs_graphs
    fr = PB.pull_frontier(g)
    got = PB.pull(g, fr).numpy()
    jfr = jnp.asarray(fr.numpy())
    vals = jfr[jg.r_node_idx].astype(jnp.int32)
    want = np.asarray(JSR.segment_sum_by_offsets(vals, jg.r_begin,
                                                  jg.n_pad) > 0)
    assert g.n_pad == jg.n_pad and got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", PB.PUSH_CAPS)
def test_push_expand_equals_jax(bfs_graphs, cap):
    g, out_deg, jg = bfs_graphs
    fr = PB.push_frontier(g, out_deg, cap)
    assert int(fr.sum()) == min(max(1, cap // 32), -(-BFS_N // 4))
    got = TBFS._push_expand(g, fr, g.begin, g.node_idx, cap).numpy()
    want = np.asarray(JBFS._push_expand(jg, jnp.asarray(fr.numpy()),
                                        jg.begin, jg.node_idx, cap))
    np.testing.assert_array_equal(got, want)


def test_auto_bfs_equals_jax(bfs_graphs):
    g, out_deg, jg = bfs_graphs
    rec = PB.measure(g, out_deg, CPU, log=lambda m: None)
    roots = PB.bfs_roots(out_deg)
    assert rec["bfs"]["roots"] == roots.tolist()
    for i, r in enumerate(roots):
        want = JBFS.bfs(jg, int(r))
        levels = rec["bfs"]["levels"] if i == 0 else \
            rec["bfs"]["timed_levels"][i - 1]
        reached = rec["bfs"]["reached"] if i == 0 else \
            rec["bfs"]["timed_reached"][i - 1]
        assert (levels, reached) == (int(want.levels_run),
                                     int(want.reached))
    for k in ("pull", *(f"push_{c}" for c in PB.PUSH_CAPS)):
        assert rec[k]["ms"] is None and rec[k]["host_ms"] > 0


def test_bfs_probe_main(capsys):
    assert PB.main(["--device", "cpu", "--nodes", "4000", "--edges",
                    "40000"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# card: ")
    rec = json.loads(out[-1])
    assert rec["bfs"]["levels"] > 0 and rec["bfs"]["reached"] > 1
    assert set(rec) >= {"pull", "push_4096", "push_65536", "push_1048576"}


# -- the preprocessing stages -----------------------------------------------

def test_prep_stages_and_to_binned_equal_jax():
    n, e = 4000, 40000
    src, dst = native.rmat_edges(n, e, seed=PB.LJ_SEED)
    lines = []
    rec = PP.stages(src, dst, n, CPU, log=lines.append)
    names = list(rec["stages"])
    assert names == ["from_edges", "binned_in",
                     *(f"upload {f}" for f in PP.UPLOADS),
                     "to_binned(deg) device"]
    assert len(lines) == len(names)
    jg, _ = jax_from_edges(src, dst, n)
    jbp = JBIN.binned_in(jg)
    assert rec["stages"]["binned_in"]["slot_src_bytes"] == \
        jbp.slot_src.shape[0] * 4
    deg = np.bincount(src, minlength=n).astype(np.int32)
    want = np.asarray(jbp.to_binned(jnp.asarray(deg)))
    np.testing.assert_array_equal(rec["deg_binned"].numpy(), want)


def test_prep_probe_main(capsys):
    assert PP.main(["--device", "cpu", "--nodes", "4000", "--edges",
                    "40000"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# card: ")
    rec = json.loads(out[-1])
    assert rec["upload slot_src"]["gb_per_s"] is None   # no rate on the CPU
    assert rec["from_edges"]["s"] > 0


# -- the device rule ---------------------------------------------------------

@pytest.mark.parametrize("module,argv", [(TW, ["--smoke"]), (PB, []),
                                         (PP, [])])
def test_probes_need_a_card_for_cuda(module, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        module.main(argv + ["--device", "cuda"])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert "# card" not in capsys.readouterr().out
