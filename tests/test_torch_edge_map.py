"""The binned edge map's bitwise OR on the CPU: ``binned.edge_map(...,
"bor")``, ``kernels.edge_map_bor`` and its plain version
``kernels.edge_map_bor_ref`` against an OR over each node's in-neighbours
computed with numpy from the graph's CSC; the rule by which ``edge_map``
takes the kernel; the wrapper's checks.  The bit-BFS level
(``binned.edge_map_level``, ``kernels.edge_map_bor_level`` and its plain
version) against the model's earlier steps, and its wrapper's checks.  The
kernels themselves run on the card (``tests/test_torch_cuda.py``).  This
file imports neither JAX nor ``green_marl_tpu``."""

import numpy as np
import pytest
import torch

from green_marl_tpu_torch.graph.csr import from_edges
from green_marl_tpu_torch.graph.generate import rmat_edges
from green_marl_tpu_torch.ops import binned
from green_marl_tpu_torch.ops import kernels as K

N, M = 1500, 16000
ISOLATED = 40          # node ids past the edges' range: zero in-degree


@pytest.fixture(scope="module")
def graph():
    src, dst = rmat_edges(N, M, seed=23)
    g, _ = from_edges(src, dst, N + ISOLATED)
    return g


def _planes(rng, bp, dtype, lanes):
    """[n_rows, lanes] planes of sparse bits (each set with p = 1/16), pad
    and identity rows 0, as ``make_table`` leaves them."""
    bits = torch.iinfo(dtype).bits
    raw = rng.integers(0, 256, (4, bp.n_nodes, lanes * bits // 8),
                       dtype=np.uint8)
    sparse = raw[0] & raw[1] & raw[2] & raw[3]
    rows = torch.from_numpy(sparse).view(dtype)
    return bp.make_table(rows, 0)


def _oracle(g, bp, table):
    """Per binned row, the OR of the rows of its node's in-neighbours."""
    t = table.view(torch.uint8).numpy()
    e = g.num_edges
    src_rows = bp.inv_perm.numpy()[g.r_node_idx[:e].numpy()]
    per_node = np.zeros((g.num_nodes, t.shape[1]), np.uint8)
    np.bitwise_or.at(per_node, g.r_node_idx_dst[:e].numpy(), t[src_rows])
    out = np.zeros_like(t)
    out[:bp.n_nodes] = per_node[bp.perm.numpy()]
    return torch.from_numpy(out).view(table.dtype)


# (dtype, lanes): rows of 16 to 512 bytes, and rows of 4, 8, 24 and 36
# bytes, which no kernel takes
CASES = [(torch.uint8, 16), (torch.int16, 8), (torch.int32, 4),
         (torch.uint8, 48), (torch.int16, 64), (torch.int32, 128),
         (torch.uint8, 4), (torch.int32, 2), (torch.int16, 12),
         (torch.int32, 9)]


@pytest.mark.parametrize("w_max", [8, 96, binned.W_MAX])
@pytest.mark.parametrize("dtype,lanes", CASES)
def test_bor_equals_the_or_of_in_neighbours(graph, dtype, lanes, w_max):
    bp = binned.binned_in(graph, w_max=w_max)
    assert (bp.n_hub_chunks > 0) == (w_max < binned.W_MAX)
    assert bp.n_nodes > N and bp.n_rows > bp.n_nodes   # isolated and pad
    widths = {w for w, *_ in bp.bins}      # empty ladder classes: no bin
    assert w_max < binned.W_MAX or ({170, 331} <= widths
                                     and not {212, 265} & widths)
    table = _planes(np.random.default_rng(lanes), bp, dtype, lanes)
    want = _oracle(graph, bp, table)
    K.reset_launch_counts()
    got = [binned.edge_map(bp, table, "bor"),
           binned.edge_map(bp, table, "bor", slot_chunk=1000),
           K.edge_map_bor_ref(bp, table, slot_chunk=333)]
    row_bytes = lanes * table.element_size()
    if row_bytes % 16 == 0:
        got.append(K.edge_map_bor(bp, table))
    for out in got:
        assert out.dtype == dtype and torch.equal(out, want)
        assert not bool(out[bp.n_nodes:].any())       # pad rows: 0
    assert K.launch_counts()["edge_map_bor"] == 0     # the CPU: plain
    assert bool(want.any()) and not bool(want.all())


I8, U8, I16, I32, I64 = torch.int8, torch.uint8, torch.int16, torch.int32, \
    torch.int64


@pytest.mark.parametrize(
    "op,device,dtype,contiguous,row_bytes,slot_vals,takes", [
        ("bor", "cuda", I32, True, 512, False, True),
        ("bor", "cuda", U8, True, 16, False, True),
        ("bor", "cuda", I16, True, 128, False, True),
        ("bor", "cuda", I8, True, 48, False, False),
        ("bor", "cuda", I64, True, 256, False, False),
        ("bor", "cpu", I32, True, 512, False, False),
        ("bor", "cuda", I32, False, 512, False, False),
        ("bor", "cuda", I32, True, 1024, False, False),
        ("bor", "cuda", I32, True, 8, False, False),
        ("bor", "cuda", U8, True, 24, False, False),
        ("bor", "cuda", I32, True, 512, True, False),
        ("bor", "cuda", torch.bool, True, 512, False, False),
        ("or", "cuda", torch.float32, True, 512, False, False),
        ("or", "cuda", I32, True, 512, False, False),
        ("sum", "cuda", I32, True, 512, False, False),
        ("min", "cuda", I32, True, 512, False, False),
        ("max", "cuda", I32, True, 512, False, False),
    ])
def test_kernel_rule(op, device, dtype, contiguous, row_bytes, slot_vals,
                     takes):
    assert binned.takes_bor_kernel(op, device, dtype, contiguous, row_bytes,
                                   slot_vals) is takes


def test_wrapper_checks(graph):
    bp = binned.binned_in(graph, w_max=8)
    table = torch.zeros((bp.n_rows, 4), dtype=torch.int32)
    with pytest.raises(ValueError):                 # not an int plane
        K.edge_map_bor(bp, table.float())
    with pytest.raises(ValueError):                 # int64: no caller
        K.edge_map_bor(bp, torch.zeros((bp.n_rows, 2), dtype=torch.int64))
    with pytest.raises(ValueError):                 # not contiguous
        K.edge_map_bor(bp, torch.zeros((bp.n_rows, 8), dtype=torch.int32)
                       [:, ::2])
    with pytest.raises(ValueError):                 # 8-byte rows
        K.edge_map_bor(bp, table[:, :2].contiguous())
    with pytest.raises(ValueError):                 # 1,024-byte rows
        K.edge_map_bor(bp, torch.zeros((bp.n_rows, 256), dtype=torch.int32))
    with pytest.raises(ValueError):                 # not n_rows rows
        K.edge_map_bor(bp, table[1:])
    assert K.edge_map_bor(bp, table).shape == table.shape


def _level_steps(bp, frontier, visited):
    """The bit BFS level as ``multi_source_bfs_bits`` took it before the
    level form: the edge map, ``hit & ~visited`` through ``where`` on the
    node rows, ``visited | newly``; and the nonzero node rows of
    ``newly``."""
    hit = binned.edge_map(bp, frontier, "bor")
    zero = torch.zeros((), dtype=hit.dtype)
    newly = torch.where(bp.node_rows_mask(), hit & ~visited, zero)
    return newly, visited | newly, int((newly != 0).any(1).sum())


def _level_planes(bp, dtype, lanes, seed):
    """A sparse frontier and a denser ``visited`` (each bit set with p =
    1/4), whose pad and identity rows hold bits that a level must leave
    alone."""
    rng = np.random.default_rng(seed)
    frontier = _planes(rng, bp, dtype, lanes)
    raw = rng.integers(0, 256, (2, bp.n_rows, lanes * dtype.itemsize),
                       dtype=np.uint8)
    visited = torch.from_numpy(raw[0] & raw[1]).view(dtype)
    return frontier, visited


@pytest.mark.parametrize("w_max", [8, binned.W_MAX])
@pytest.mark.parametrize("dtype,lanes", CASES)
def test_level_equals_the_steps(graph, dtype, lanes, w_max):
    """The level's plain version, ``binned.edge_map_level`` and the wrapper
    (the plain version on the CPU) give the earlier steps' next frontier
    and ``visited`` bit for bit, update ``visited`` in place, leave its pad
    and identity rows as they were, and count the nonzero node rows."""
    bp = binned.binned_in(graph, w_max=w_max)
    frontier, visited = _level_planes(bp, dtype, lanes, lanes + w_max)
    want, want_vis, want_rows = _level_steps(bp, frontier, visited)
    assert 0 < want_rows < bp.n_nodes
    assert bool((want_vis != visited).any())
    row_bytes = lanes * frontier.element_size()
    runs = [lambda f, v: K.edge_map_bor_level_ref(bp, f, v),
            lambda f, v: K.edge_map_bor_level_ref(bp, f, v, slot_chunk=333),
            lambda f, v: binned.edge_map_level(bp, f, v, slot_chunk=1000)]
    if row_bytes % 16 == 0:
        runs.append(lambda f, v: K.edge_map_bor_level(bp, f, v))
    K.reset_launch_counts()
    for run in runs:
        vis = visited.clone()
        ptr = vis.data_ptr()
        got, rows = run(frontier.clone(), vis)
        assert got.dtype == dtype and torch.equal(got, want)
        assert vis.data_ptr() == ptr and torch.equal(vis, want_vis)
        assert torch.equal(vis[bp.n_nodes:], visited[bp.n_nodes:])
        assert rows.dtype == torch.int32 and rows.dim() == 0
        assert int(rows) == want_rows
    assert K.launch_counts()["edge_map_bor_level"] == 0   # the CPU: plain


def test_level_wrapper_checks(graph):
    """The level wrapper refuses what ``edge_map_bor`` refuses, planes of
    two dtypes or shapes, and a ``visited`` that shares storage with the
    frontier, whichever view of it."""
    bp = binned.binned_in(graph, w_max=8)
    frontier = torch.zeros((bp.n_rows, 4), dtype=torch.int32)
    visited = torch.zeros_like(frontier)
    for f, v in ((frontier.float(), visited.float()),      # not int planes
                 (frontier[:, :2].contiguous(),
                  visited[:, :2].contiguous()),             # 8-byte rows
                 (frontier, visited.view(torch.uint8)),     # two dtypes
                 (frontier, visited[:, :2].contiguous()),   # two shapes
                 (frontier[1:], visited[1:]),               # not n_rows rows
                 (frontier, frontier),                      # one plane
                 (frontier, frontier.view(torch.int16)
                  .view(torch.int32)),                      # one storage
                 ):
        with pytest.raises(ValueError):
            K.edge_map_bor_level(bp, f, v)
    both = torch.zeros((2, bp.n_rows, 4), dtype=torch.int32)
    with pytest.raises(ValueError):                     # one storage
        K.edge_map_bor_level(bp, both[0], both[1])
    got, rows = K.edge_map_bor_level(bp, frontier, visited)
    assert got.shape == frontier.shape and int(rows) == 0
