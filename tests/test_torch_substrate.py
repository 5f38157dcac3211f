"""The rest of the port's substrate against green_marl_tpu's on the CPU:
``GraphBuilder``, ``degrees_np``, ``load_graph``, ``load_snap_edge_list``,
the AVRO codec and ``graph.fs``, the ``graph_gen`` and
``format_converter`` tools, the CLI's output path (``-GMDumpGraph`` in all
six formats) and ``-GMProfile``, ``min_relax(dist_dtype=float32)`` and
``bfs_many_sequential``.

Files the two packages write must be equal byte for byte (AVRO outside its
random 16-byte sync marker); arrays, counts and result lines bit for bit,
PageRank ranks within rtol 1e-4 (float sums in another order).
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from green_marl_tpu.cli import apps as japps
from green_marl_tpu.cli import format_converter as jconv
from green_marl_tpu.cli import graph_gen as jgen_cli
from green_marl_tpu.graph import avro_io as javro
from green_marl_tpu.graph import binary_io as jbio
from green_marl_tpu.graph import csr as jcsr
from green_marl_tpu.graph import edge_list as jel
from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.models import bfs as jbfs
from green_marl_tpu.models import relax as jrelax
from green_marl_tpu.utils import timing as jtiming
from green_marl_tpu_torch.cli import apps
from green_marl_tpu_torch.cli import format_converter as tconv
from green_marl_tpu_torch.cli import graph_gen as tgen_cli
from green_marl_tpu_torch.graph import avro_io as tavro
from green_marl_tpu_torch.graph import binary_io as tbio
from green_marl_tpu_torch.graph import csr as tcsr
from green_marl_tpu_torch.graph import edge_list as tel
from green_marl_tpu_torch.graph import fs as tfs
from green_marl_tpu_torch.models import bfs as tbfs
from green_marl_tpu_torch.models import pagerank as tpr
from green_marl_tpu_torch.models import relax as trelax
from green_marl_tpu_torch.utils import timing as ttiming

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "parity", "parity10k.bin")


def run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out.splitlines()


def results(lines):
    """The protocol lines that carry results (no timings)."""
    return [ln for ln in lines if "time=" not in ln]


def avro_canonical(path):
    """An Avro container's bytes with its random 16-byte sync marker (the
    16 bytes after the header's metadata map, repeated after each block)
    zeroed: two writers of the same data agree on the rest."""
    data = open(path, "rb").read()
    meta_end = data.index(b"\x00", data.index(b"avro.codec")) + 1
    sync = data[meta_end:meta_end + 16]
    return data.replace(sync, bytes(16))


def same_graph(jg, tg):
    for f in tcsr.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).cpu().numpy(),
                                      np.asarray(getattr(jg, f)))
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges)


def test_graph_builder_keys_and_freeze():
    jb, tb = jcsr.GraphBuilder(), tcsr.GraphBuilder()
    rng = np.random.default_rng(4)
    keys = rng.integers(10 ** 9, 10 ** 12, 60)
    for b in (jb, tb):
        for s, d in rng.integers(0, 60, (200, 2)):
            b.add_keyed_edge(int(keys[s]), int(keys[d]))
        b.add_nodes(3)                 # isolated nodes past the keyed ones
        b.add_edge(b.add_node(), 0)
        b.add_edges(np.array([1, 2, 3]), np.array([4, 4, 4]))
        rng = np.random.default_rng(4)
        keys = rng.integers(10 ** 9, 10 ** 12, 60)
    assert tb.nodekeys == jb.nodekeys
    for k in (int(keys[0]), int(keys[7]), 12345):
        assert tb.find_nodekey(k) == jb.find_nodekey(k)
    for nid in (0, 5, tb.find_nodekey(int(keys[9])), 10 ** 6, -1):
        assert tb.find_nodeid(nid) == jb.find_nodeid(nid)
    (jg, jperm), (tg, tperm) = jb.freeze(), tb.freeze()
    same_graph(jg, tg)
    np.testing.assert_array_equal(tperm, jperm)
    # thaw, mutate, freeze again
    jt, tt = jcsr.GraphBuilder.thaw(jg), tcsr.GraphBuilder.thaw(tg)
    for b in (jt, tt):
        b.add_edge(2, b.add_node())
    same_graph(jt.freeze()[0], tt.freeze()[0])
    assert tcsr.degrees_np(tg) == jcsr.degrees_np(jg)
    empty = tcsr.GraphBuilder().freeze()[0]
    assert empty.num_nodes == 0 and empty.num_edges == 0


def test_degrees_and_load_graph():
    jg, jraw, jperm = jbio.load_graph(FIXTURE)
    tg, traw, tperm = tbio.load_graph(FIXTURE)
    same_graph(jg, tg)
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(traw.node_idx, jraw.node_idx)
    assert tcsr.degrees_np(tg) == jcsr.degrees_np(jg)


def test_load_snap_edge_list(tmp_path):
    path = str(tmp_path / "snap.txt")
    src, dst = jgen.rmat_edges(300, 2000, seed=8)
    with open(path, "w") as f:
        f.write("# Directed graph\n# FromNodeId\tToNodeId\n")
        for s, d in zip(src, dst):
            f.write(f"{s}\t{d}\n")
    got, want = tel.load_snap_edge_list(path), jel.load_snap_edge_list(path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], src)


def avro_inputs():
    raw = jbio.load_binary(FIXTURE)
    rng = np.random.default_rng(2)
    nprops = [rng.random(raw.num_nodes).astype(np.float32),
              rng.integers(0, 9, raw.num_nodes).astype(np.int64),
              rng.random(raw.num_nodes) < 0.3]
    eprops = [rng.integers(1, 50, raw.num_edges).astype(np.int32),
              rng.random(raw.num_edges)]
    return raw, nprops, eprops


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_avro_round_trip_across_packages(writer, tmp_path):
    raw, nprops, eprops = avro_inputs()
    path = str(tmp_path / "g.avro")
    w, r = (javro, tavro) if writer == "jax" else (tavro, javro)
    w.store_avro(path, raw.begin, raw.node_idx, node_props=nprops,
                 edge_props=eprops)
    got, want = tavro.load_avro(path), javro.load_avro(path)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2] + got[3], nprops + eprops):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert got[4:] == want[4:] and got[6] == raw.num_nodes
    other = str(tmp_path / "other.avro")
    r.store_avro(other, raw.begin, raw.node_idx, node_props=nprops,
                 edge_props=eprops)
    assert avro_canonical(other) == avro_canonical(path)


def test_fs_local_paths(tmp_path):
    assert tfs.is_remote("hdfs://nn/x.bin") and tfs.is_remote("gs://b/x")
    assert not tfs.is_remote(FIXTURE)
    assert tfs.fetch(FIXTURE) == FIXTURE
    dest = str(tmp_path / "copy.bin")
    tfs.publish(FIXTURE, dest)
    assert filecmp.cmp(FIXTURE, dest, shallow=False)


@pytest.mark.parametrize("args", [
    ["1000", "5000"], ["1000", "5000", "-type=rmat", "-seed=3"],
    ["800", "3000", "-type=uniform_nonmulti", "-seed=5"],
    ["512", "4000", "-type=rmat", "-nopermute", "-a=0.5", "-b=0.2",
     "-c=0.2"]])
def test_graph_gen_matches_jax_tool(args, tmp_path, capsys):
    outs = [str(tmp_path / f"{k}.bin") for k in ("jax", "port")]
    for main, out in zip((jgen_cli.main, tgen_cli.main), outs):
        assert main(args[:2] + [out] + args[2:]) == 0
    assert open(outs[1], "rb").read() == open(outs[0], "rb").read()
    assert capsys.readouterr().out.count("generated ") == 2


@pytest.mark.parametrize("case", ["edge+schema", "edge->BIN", "adj"])
def test_format_converter_matches_jax_tool(case, tmp_path, capsys):
    raw = jbio.load_binary(FIXTURE)
    rng = np.random.default_rng(6)
    src = np.repeat(np.arange(raw.num_nodes), np.diff(raw.begin))
    keys = rng.permutation(10 ** 6)[: raw.num_nodes] + 7
    inp = str(tmp_path / "in.txt")
    schema = str(tmp_path / "schema")
    argv = []
    if case == "adj":
        with open(inp, "w") as f:
            for u in range(raw.num_nodes):
                f.write(" ".join(map(str, [u, *raw.node_idx[
                    raw.begin[u]:raw.begin[u + 1]]])) + "\n")
        argv = ["-GMInputFormat=ADJ"]
    else:
        jel.store_edge_list(
            inp, src, raw.node_idx, nodekey=keys,
            node_props=[rng.integers(0, 5, raw.num_nodes).astype(np.int32),
                        rng.random(raw.num_nodes)],
            edge_props=[rng.random(raw.num_edges).astype(np.float32)])
        with open(schema, "w") as f:
            f.write("NODE: int double\nEDGE: float\n")
        if case == "edge->BIN":
            argv = ["-GMOutputFormat=BIN"]
    outs = [str(tmp_path / f"{k}.bin") for k in ("jax", "port")]
    for main, out in zip((jconv.main, tconv.main), outs):
        extra = [schema] if case != "adj" else []
        assert main(argv + [inp, out] + extra) == 0
    assert open(outs[1], "rb").read() == open(outs[0], "rb").read()
    assert capsys.readouterr().out.count("converted ") == 2


@pytest.mark.parametrize("fmt", ["BIN", "NULL", "EBIN", "EDGE", "NODE_PROP",
                                 "AVRO"])
def test_dump_graph_matches_jax_cli(fmt, tmp_path, capsys):
    """hop_dist on parity10k with -GMDumpGraph=1: the same file."""
    outs = [str(tmp_path / f"{k}.{fmt}") for k in ("jax", "port")]
    got = {}
    for k, main, dev, out in (("jax", japps.main, [], outs[0]),
                              ("port", apps.main, ["-GMDevice=cpu"],
                               outs[1])):
        got[k] = run(capsys, main, ["hop_dist"] + dev + [
            "-GMDumpGraph=1", f"-GMOutputFormat={fmt}", FIXTURE, out])
    assert results(got["port"]) == results(got["jax"])
    if fmt == "AVRO":
        assert avro_canonical(outs[1]) == avro_canonical(outs[0])
    else:
        assert open(outs[1], "rb").read() == open(outs[0], "rb").read()
    assert os.path.getsize(outs[1]) > 0


def test_dump_graph_round_trips_through_each_input_format(tmp_path, capsys):
    """What -GMDumpGraph writes as BIN, EBIN and AVRO reads back through
    -GMInputFormat into the same hop_dist lines (an EDGE file carries the
    output property as a node column, which hop_dist's EDGE schema, with
    no node property, refuses, in the JAX CLI too)."""
    want = results(run(capsys, apps.main, ["hop_dist", "-GMDevice=cpu",
                                           FIXTURE]))
    for fmt in ("BIN", "EBIN", "AVRO"):
        out = str(tmp_path / f"g.{fmt}")
        run(capsys, apps.main, ["hop_dist", "-GMDevice=cpu",
                                "-GMDumpGraph=1", f"-GMOutputFormat={fmt}",
                                FIXTURE, out])
        got = run(capsys, apps.main, ["hop_dist", "-GMDevice=cpu",
                                      f"-GMInputFormat={fmt}", out])
        assert results(got) == want, fmt


def test_pagerank_profile_matches_jax_cli(capsys):
    """-GMProfile on pagerank: as many supersteps as the JAX CLI, the same
    ranks (rtol 1e-4), and bit for bit the port's own unprofiled run."""
    want = run(capsys, japps.main, ["pagerank", "-GMProfile=1", FIXTURE])
    got = run(capsys, apps.main, ["pagerank", "-GMDevice=cpu",
                                  "-GMProfile=1", FIXTURE])
    fused = run(capsys, apps.main, ["pagerank", "-GMDevice=cpu", FIXTURE])
    steps = [[ln.split(" ")[0] for ln in lines
              if ln.startswith("superstep[")] for lines in (want, got)]
    assert steps[0] == steps[1] and len(steps[1]) > 1
    assert all(ln.split("=")[1].strip().endswith("ms")
               for ln in got if ln.startswith("superstep["))

    def ranks(lines):
        return [float(ln.split(" = ")[1]) for ln in lines
                if ln.startswith("rank[")]

    np.testing.assert_allclose(ranks(got), ranks(want), rtol=1e-4, atol=0)
    assert results(got) == results(fused)


def test_profiled_models_equal_fused():
    raw = jbio.load_binary(FIXTURE)
    g, _ = raw.freeze()
    tg = tbio.load_graph(FIXTURE)[0]
    a = tpr.pagerank(tg)
    b = tpr.pagerank_profiled(tg)
    assert torch.equal(a.rank, b.rank) and a.iterations == b.iterations
    c = trelax.min_relax(tg, 5)
    d = trelax.min_relax_profiled(tg, 5)
    assert torch.equal(c.dist, d.dist) and d.iterations == 0
    assert int(jrelax.min_relax_profiled(g, 5).iterations) == 0
    assert ttiming.graph_placement_report(
        tg) == jtiming.graph_placement_report(g)


def test_profile_supersteps_lines(capsys):
    state = ttiming.profile_supersteps(lambda s: s + 1, torch.tensor(0),
                                       lambda s: s < 3)
    lines = capsys.readouterr().out.splitlines()
    assert int(state) == 3 and [ln.split(" ")[0] for ln in lines] == [
        "superstep[0]", "superstep[1]", "superstep[2]"]
    assert ttiming.profile_supersteps(lambda s: s + 1, 7, lambda s: s < 9,
                                      max_iter=1) == 8


@pytest.mark.parametrize("weights", [None, "random"])
def test_min_relax_float32_matches_jax(weights):
    src, dst = jgen.rmat_edges(1500, 9000, seed=12)
    jg, _ = jcsr.from_edges(src, dst, 1500)
    tg = tcsr.graph_from_arrays({f: np.asarray(getattr(jg, f))
                                 for f in tcsr.ARRAY_FIELDS}, 1500,
                                jg.num_edges)
    w = None
    if weights:
        w = np.random.default_rng(1).random(jg.e_pad).astype(np.float32)
    for root in (0, 17):
        want = jrelax.min_relax(jg, root, None if w is None
                                else jnp.asarray(w), dist_dtype=jnp.float32)
        got = trelax.min_relax(tg, root, None if w is None
                               else torch.from_numpy(w),
                               dist_dtype=torch.float32)
        assert got.dist.dtype == torch.float32
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
        assert got.iterations == int(want.iterations)
        assert np.isinf(got.dist.numpy()[1500:]).all()


def test_bfs_many_sequential_matches_jax():
    src, dst = jgen.rmat_edges(2000, 14_000, seed=21)
    jg, _ = jcsr.from_edges(src, dst, 2000)
    tg = tcsr.graph_from_arrays({f: np.asarray(getattr(jg, f))
                                 for f in tcsr.ARRAY_FIELDS}, 2000,
                                jg.num_edges)
    roots = np.array([0, 5, 1999, 77, 5], np.int32)
    want = jbfs.bfs_many_sequential(jg, jnp.asarray(roots))
    got = tbfs.bfs_many_sequential(tg, roots)
    assert got[0] == int(want[0]) and got[1] == int(want[1])
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
