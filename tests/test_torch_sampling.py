"""The port's threefry, sampling builtins, sampling models and the four
sampling apps, against green_marl_tpu's on the CPU.

``runtime.rng`` must draw JAX's own bits: keys, bits, uniforms and ints
equal ``jax.random``'s bit for bit, and so every sampled set, walk,
trajectory and matching equals the JAX version's on the same graph (an RMAT
of 2,000 nodes and ``data/parity/parity10k.bin``).  The apps' stdout result
lines must equal the JAX CLI's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from green_marl_tpu.cli import apps as japps
from green_marl_tpu.graph import binary_io as jbio
from green_marl_tpu.graph import generate as jgen
from green_marl_tpu.graph.csr import from_edges as jfrom_edges
from green_marl_tpu.models import sampling as jsamp
from green_marl_tpu.runtime import rng as jrng
from green_marl_tpu_torch.cli import apps
from green_marl_tpu_torch.graph.csr import ARRAY_FIELDS, graph_from_arrays
from green_marl_tpu_torch.models import sampling as tsamp
from green_marl_tpu_torch.runtime import rng

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "parity", "parity10k.bin")
SEEDS = [0, 7, 2 ** 33 + 5]


def run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out.splitlines()


def results(lines):
    """The protocol lines that carry results (no timings)."""
    return [ln for ln in lines if "time=" not in ln]


def jax_key(seed):
    """JAX's key of a 64-bit seed (``PRNGKey`` under jax_enable_x64)."""
    return jax.random.wrap_key_data(
        np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32))


def words(x):
    return np.asarray(x).astype(np.int64)


def test_jax_draws_partitionable_threefry():
    """The stream the port reproduces: a JAX upgrade that changes it fails
    here rather than drifting."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    with jax.enable_x64(True):
        want = words(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(rng.PRNGKey(seed).numpy(), want)
    np.testing.assert_array_equal(rng.PRNGKey(seed).numpy(),
                                  words(jax.random.key_data(jax_key(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (1000,), (17, 33)])
def test_threefry_draws_equal_jax(seed, shape):
    jk, tk = jax_key(seed), rng.PRNGKey(seed)
    for num in (2, 4):
        np.testing.assert_array_equal(
            rng.split(tk, num).numpy(),
            words(jax.random.key_data(jax.random.split(jk, num))))
    np.testing.assert_array_equal(
        rng.random_bits(tk, shape).numpy(),
        words(jax.random.bits(jk, shape, np.uint32)))
    got = rng.uniform(tk, shape).numpy()
    want = np.asarray(jax.random.uniform(jk, shape))
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for span in (1, 3, 12345, 2 ** 31 - 1):
        got = rng.randint(tk, shape, 0, span).numpy()
        want = np.asarray(jax.random.randint(jk, shape, 0, span, jnp.int32))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # a batch of keys draws as each key alone
    keys = rng.split(tk, 3)
    batch = rng.uniform(keys, shape)
    for i in range(3):
        np.testing.assert_array_equal(batch[i].numpy(),
                                      rng.uniform(keys[i], shape).numpy())


def test_randint_with_an_offset_and_an_empty_span():
    jk, tk = jax_key(11), rng.PRNGKey(11)
    for lo, hi in ((-50, 77), (5, 5), (9, 3), (-(2 ** 31), 2 ** 31 - 1)):
        np.testing.assert_array_equal(
            rng.randint(tk, (500,), lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, (500,), lo, hi, jnp.int32)))


def test_key_chain_equals_repeated_split():
    key = jax_key(3)
    chain = rng.key_chain(rng.PRNGKey(3), 6).numpy()
    for i in range(6):
        np.testing.assert_array_equal(chain[i],
                                      words(jax.random.key_data(key)))
        key = jax.random.split(key, 4)[0]


def pair(src, dst, n):
    jg, _ = jfrom_edges(src, dst, n)
    tg = graph_from_arrays({f: np.asarray(getattr(jg, f))
                            for f in ARRAY_FIELDS}, n, jg.num_edges)
    return jg, tg


@pytest.fixture(scope="module", params=["rmat2000", "parity10k"])
def graphs(request):
    """(JAX graph, port graph) of one edge list; the RMAT has dead ends
    (out-degree 0) and nodes with no edges at all."""
    if request.param == "rmat2000":
        src, dst = jgen.rmat_edges(2000, 12_000, seed=3)
        return pair(src, dst, 2000)
    raw = jbio.load_binary(FIXTURE)
    src = np.repeat(np.arange(raw.num_nodes), np.diff(raw.begin))
    return pair(src, raw.node_idx, raw.num_nodes)


def test_pick_random_builtins(graphs):
    jg, tg = graphs
    n = tg.num_nodes
    deg = np.diff(np.asarray(jg.begin))
    dead = np.flatnonzero(deg == 0)
    v = np.concatenate([np.arange(0, n, 7), dead[:50], [n]]).astype(np.int32)
    for seed in (0, 5):
        jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        for shape in ((), (300,)):
            np.testing.assert_array_equal(
                rng.pick_random_nodes(tk, tg, shape).numpy(),
                np.asarray(jrng.pick_random_nodes(jk, jg, shape)))
        got = rng.pick_random_nbr(tk, tg, torch.from_numpy(v)).numpy()
        want = np.asarray(jrng.pick_random_nbr(jk, jg, jnp.asarray(v)))
        np.testing.assert_array_equal(got, want)
        assert (got[np.isin(v, dead) | (v == n)] == n).all()
        np.testing.assert_array_equal(
            rng.uniform(tk, (9,)).numpy(), np.asarray(jrng.uniform(jk, (9,))))
    if graphs[1].num_nodes == 2000:
        assert dead.size > 0


@pytest.mark.parametrize("n", [1, 100, 1000])
def test_node_samplings(graphs, n):
    jg, tg = graphs
    for seed in (0, 7):
        jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        for jf, tf in ((jsamp.random_node_sampling,
                        tsamp.random_node_sampling),
                       (jsamp.random_degree_node_sampling,
                        tsamp.random_degree_node_sampling)):
            want = np.asarray(jf(jg, jk, jnp.asarray(n, jnp.int32)))
            got = tf(tg, tk, n).numpy()
            np.testing.assert_array_equal(got, want)


def test_random_walk_with_jump(graphs):
    jg, tg = graphs
    for seed, steps, c, start in ((0, 2000, 0.15, None), (9, 700, 0.05, 3),
                                  (4, 300, 1.0, None), (2, 1, 0.15, None)):
        jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        want = np.asarray(jsamp.random_walk_with_jump(
            jg, jk, steps=steps, c=c,
            start=None if start is None else jnp.int32(start)))
        got = tsamp.random_walk_with_jump(tg, tk, steps, c, start).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() <= steps


def test_parallel_random_walks(graphs):
    jg, tg = graphs
    starts = (np.arange(96, dtype=np.int32) * 13) % tg.num_nodes
    for seed, steps, c in ((0, 40, 0.15), (1, 25, 0.0)):
        jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        jc, jt = jsamp.parallel_random_walks(jg, jk, jnp.asarray(starts),
                                             steps=steps, c=c)
        tc, tt = tsamp.parallel_random_walks(tg, tk, torch.from_numpy(starts),
                                             steps, c)
        assert tc.dtype == torch.int32 and tt.shape == (steps, 96)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert int(tc.sum()) == steps * 96


@pytest.mark.parametrize("left", ["out-edges", "even ids"])
def test_random_bipartite_matching(graphs, left):
    jg, tg = graphs
    n = tg.num_nodes
    is_left = np.zeros(tg.n_pad, bool)
    is_left[:n] = (np.diff(np.asarray(jg.begin)) > 0 if left == "out-edges"
                   else np.arange(n) % 2 == 0)
    want = jsamp.random_bipartite_matching(jg, jnp.asarray(is_left))
    got = tsamp.random_bipartite_matching(tg, torch.from_numpy(is_left))
    np.testing.assert_array_equal(got.match.numpy(), np.asarray(want.match))
    assert got.count == int(want.count) > 0
    assert got.iterations == int(want.iterations)
    m = got.match.numpy()[:n]
    paired = np.flatnonzero(m >= 0)
    assert (m[m[paired]] == paired).all()
    assert 2 * got.count == paired.size


@pytest.mark.parametrize("app", [
    "random_node_sampling", "random_degree_node_sampling",
    "random_walk_sampling_with_random_jump", "random_bipartite_matching"])
def test_sampling_apps_match_jax_cli(app, capsys):
    argv = [app, "-n=500", FIXTURE] if app != "random_bipartite_matching" \
        else [app, FIXTURE]
    want = run(capsys, japps.main, argv)
    got = run(capsys, apps.main, argv[:1] + ["-GMDevice=cpu"] + argv[1:])
    assert results(got) == results(want)
    key = "matched = " if app == "random_bipartite_matching" else "CRC16 "
    assert any(ln.startswith(key) for ln in got)


def test_matching_app_reads_is_left_from_ebin(tmp_path, capsys):
    raw = jbio.load_binary(FIXTURE)
    is_left = np.arange(raw.num_nodes) % 3 != 0
    path = str(tmp_path / "left.ebin")
    jbio.store_binary(path, raw.begin, raw.node_idx, node_props=[is_left])
    argv = ["random_bipartite_matching", "-GMInputFormat=EBIN", path]
    want = run(capsys, japps.main, argv)
    got = run(capsys, apps.main, argv[:1] + ["-GMDevice=cpu"] + argv[1:])
    assert results(got) == results(want)
    assert int(got[-1].split(": ")[1]) > 1000
