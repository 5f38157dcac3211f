"""Triangle counting (``apps/src/triangle_counting.gm:1-13``).

Counterpart of ``green_marl_tpu/models/triangle.py``.  Reference semantics
(undirected version)::

    Foreach(v) Foreach(u: v.Nbrs)(u > v) Foreach(w: v.Nbrs)(w > u)
        If (w.HasEdgeTo(u)) T += 1;

so every triangle {a<b<c} is counted once.  The graph is oriented into a DAG
by degree order (ties by id): the count does not depend on the orientation,
and degree order bounds a DAG row at about sqrt(E), which shrinks the wedge
space.  Wedges (b, c) of N+(a) x N+(a) with slot(c) > slot(b) live in one
flat ``torch.int64`` index space; each is tested for c in N+(b); the count
is one ``torch.int64`` sum, read from the device once.

Three ways to test membership (``route``):

* N <= 65,536 and at most 2^25 wedges: the wedges are expanded on the host
  and tested with one word read each against a packed adjacency bitmap;
* otherwise the search: flat wedge index -> (anchor slot, offset) on the
  int64 pair prefix, then a binary search for c in row b; on the card one
  launch of ``ops/kernels.py`` ``triangle_search`` (``csrc/triangle.cu``:
  each wedge's decode and bisection in registers), on the CPU its plain
  version (``torch.searchsorted``, then ``row_contains``'s vectorised
  bisection steps over chunks of wedges);
* the sort-merge join, from ``_HASH_MIN_W`` wedges, which no DAG reaches.
  Rows are laid out by descending pair count, so that wedge (s, s + d) is a
  pair of contiguous slices of the slot axis for every shift d; each
  dispatch packs its wedge keys and all DAG edge keys into int64
  (``rank << 32 | dst * 2 + tag``), sorts them once, and a wedge hits
  where the edge key right below it is present.  The JAX package takes it
  from 2^26 wedges, a boundary set for the TPU.  On an H100 (700 W,
  ``probes/triangle.py --paths sortmerge,search`` and the same count at
  the benchmark's ``lj_undirected`` graph) the search was faster at every
  size measured: 0.110 s against 0.705 at 2^26.0 wedges (N = 2^20, 8M
  edges made undirected), 0.166 against 1.437 at 2^27.1 (N = 2^21, 16M),
  1.042 against 15.333 (and 4.1 s of the join's layout) at 2^30.4
  (1,413,336,439 wedges, lj's 69M edges made undirected).  So the join is
  kept for callers that ask for it (``count_sortmerge``) and for tests,
  which lower ``_HASH_MIN_W`` to force it.

The DAG of a ``Graph`` is built with torch on the graph's device
(``build_dag``: 0.09 s on the card at lj's size, where the host build and
the upload take 11.1 s); ``build_dag_host`` stays for callers that hold a
CSR on the host.  Under a profiler (``utils/timing.py`` ``span``):
``gm:setup`` around the build in ``_dag_of``, ``gm:triangle:count`` around
each ``count_dag`` call, ``gm:triangle:chunk`` around the search's
one launch on the card (all passes of its plain version on the CPU);
:func:`search_counts` counts the search's calls, chunks, wedges and the
plain version's bisection passes.

``triangle_count_literal`` keeps the reference's slot semantics on directed
graphs and multigraphs (parallel edges multiply wedges) and is what the CLI
calls.

Left out on purpose, because they exist in the JAX module only to fit wedge
indices and counters into the TPU's int32 or to feed its gather unit: the
limb counters of ``utils/limbs.py``, ``_anchor_samples``,
``_quantized_windows``, ``_window_bounds``, ``_count_wedges_expand``,
``_wedge_subranges``, ``_class_pad_hints``, ``_count_sub``,
``_SUBRANGE_LIMIT``, the edge hash (``_mix_hash`` to ``build_edge_hash``),
the d-shift probe kernel (``_count_wedges_shift``, ``_count_shift_region``),
the ``GM_TRI_MODE`` switch and the edge-pad sentinel ``_SM_ES`` (edge keys
are made for real slots only).  The JAX module's search and join are
plain XLA; here the join is plain PyTorch on both devices and the search
a hand kernel on the card.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..graph import native
from ..graph.csr import Graph, round_up
from ..ops import kernels as _kernels
from ..ops.segment import has_edge_to
from ..utils.timing import span


class DagContext(NamedTuple):
    """Degree-ordered DAG in CSR form, on one device.  Rows are indexed by
    orientation rank and sorted by destination rank."""
    dag_begin: torch.Tensor   # [N+1] int32
    dag_dst: torch.Tensor     # [D_pad] int32 destination ranks (pad = N)
    pair_cum: torch.Tensor    # [D_pad+1] int64 wedges anchored before a slot
    num_wedges: int
    num_dag_edges: int


def build_dag_host(begin: np.ndarray, node_idx: np.ndarray, N: int):
    """Host DAG build: ``(dag_begin64 [N+1], dag_dst [D_pad], pair_cum64
    [D_pad+1], D)`` as numpy int64.  The native routine (``gm_build_dag``)
    and the numpy form below give the same rank-ordered, deduplicated,
    row-sorted DAG."""
    if native.available():
        dag_begin, dd = native.build_dag(begin, node_idx, N)
        dag_begin64 = dag_begin.astype(np.int64)
        dd = dd.astype(np.int64)
        D = dd.shape[0]
        ds = np.repeat(np.arange(N, dtype=np.int64), np.diff(dag_begin64))
    else:
        dst = node_idx.astype(np.int64)
        deg = np.diff(begin).astype(np.int64)
        src = np.repeat(np.arange(N, dtype=np.int64), deg)
        order = np.lexsort((np.arange(N), deg))      # rank -> node
        rank = np.empty(N, np.int64)
        rank[order] = np.arange(N)
        rs, rd = rank[src], rank[dst]
        keep = rs < rd                  # orient low rank -> high rank
        # parallel edges would over-count; unique codes also sort the rows
        codes = np.unique(rs[keep] * N + rd[keep])
        ds, dd = codes // N, codes % N
        D = ds.shape[0]
        dag_begin64 = np.zeros(N + 1, np.int64)
        np.cumsum(np.bincount(ds, minlength=N), out=dag_begin64[1:])

    d_pad = round_up(max(D, 1))
    dag_dst = np.full(d_pad, N, np.int64)
    dag_dst[:D] = dd
    pairs = dag_begin64[ds + 1] - np.arange(D, dtype=np.int64) - 1
    pair_cum = np.zeros(d_pad + 1, np.int64)
    np.cumsum(pairs, out=pair_cum[1:D + 1])
    pair_cum[D + 1:] = pair_cum[D]
    return dag_begin64, dag_dst, pair_cum, D


def dag_to_device(host_dag, device) -> DagContext:
    """``build_dag_host``'s tuple as a ``DagContext`` on ``device``: for
    callers that hold a symmetric CSR on the host and need no ``Graph``."""
    dag_begin64, dag_dst, pair_cum, D = host_dag
    return DagContext(
        dag_begin=torch.from_numpy(dag_begin64.astype(np.int32)).to(device),
        dag_dst=torch.from_numpy(dag_dst.astype(np.int32)).to(device),
        pair_cum=torch.from_numpy(pair_cum).to(device),
        num_wedges=int(pair_cum[D]),
        num_dag_edges=D)


def build_dag_torch(begin: torch.Tensor, node_idx: torch.Tensor,
                    n: int) -> DagContext:
    """``build_dag_host``'s DAG built with torch on the device of ``begin``
    and ``node_idx`` (the [E] real slots), equal to
    ``dag_to_device(build_dag_host(...))`` bit for bit: ranks by a stable
    sort of degree (ties by id, ``np.lexsort``'s order), each slot oriented
    from the lower rank to the higher, duplicates dropped by sorted int64
    keys ``rank(src) * n + rank(dst)``, ``dag_begin`` and ``pair_cum`` by
    cumulative sums.  Two values are read to the host: D and the wedge
    count."""
    dev = begin.device
    deg = begin[1:].long() - begin[:-1].long()
    order = torch.sort(deg, stable=True).indices           # rank -> node
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    del order
    rs = torch.repeat_interleave(rank, deg, output_size=node_idx.numel())
    rd = rank[node_idx.long()]
    del rank
    keep = rs < rd
    codes = torch.unique(rs[keep] * n + rd[keep])          # sorted rows
    del rs, rd, keep
    D = codes.numel()
    ds = codes // n
    dag_begin = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    dag_begin[1:] = torch.bincount(ds, minlength=n).cumsum(0)
    d_pad = round_up(max(D, 1))
    dag_dst = torch.full((d_pad,), n, dtype=torch.int32, device=dev)
    dag_dst[:D] = codes % n
    del codes
    pairs = dag_begin[ds + 1] - torch.arange(1, D + 1, device=dev)
    pair_cum = torch.zeros(d_pad + 1, dtype=torch.int64, device=dev)
    pair_cum[1:D + 1] = pairs.cumsum(0)
    pair_cum[D + 1:] = pair_cum[D]
    return DagContext(dag_begin=dag_begin.to(torch.int32), dag_dst=dag_dst,
                      pair_cum=pair_cum, num_wedges=int(pair_cum[D]),
                      num_dag_edges=D)


def build_dag(g: Graph) -> DagContext:
    """The DAG of ``g`` (symmetric), built with torch on ``g``'s device
    (``build_dag_torch``): a graph on the card never leaves it."""
    return build_dag_torch(g.begin, g.node_idx[: g.num_edges], g.num_nodes)


# prep cache: id(owner) -> (owner, dict of prepared blobs); the owner is a
# Graph (its DAG, its literal schedule) or a DagContext (its bitmap, its
# join layout).  The reference builds its semi-sort and edge indexes once in
# prepare(), outside the timed region.
_PREP_CACHE: dict = {}


def _prep_of(g) -> dict:
    hit = _PREP_CACHE.get(id(g))
    if hit is not None and hit[0] is g:
        return hit[1]
    if len(_PREP_CACHE) >= 8:
        _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
    d: dict = {}
    _PREP_CACHE[id(g)] = (g, d)
    return d


def _dag_of(g: Graph) -> DagContext:
    prep = _prep_of(g)
    if "dag" not in prep:
        with span("gm:setup"):
            prep["dag"] = build_dag(g)
    return prep["dag"]


# ---------------------------------------------------------------------------
# Small graphs: expanded wedges against a packed adjacency bitmap
# ---------------------------------------------------------------------------

_BITMAP_MAX_N = 1 << 16
_EXPAND_MAX_W = 1 << 25


def _bitword_table(edges_src: np.ndarray, edges_dst: np.ndarray,
                   n: int) -> Tuple[np.ndarray, int]:
    """[n * W] packed adjacency words: bit ``dst % 32`` of word
    ``src * W + dst // 32``.  Returned as int32 (torch shifts no uint32 on
    the CPU; ``(word >> bit) & 1`` is exact under an arithmetic shift)."""
    W = (n + 31) // 32
    word = edges_src.astype(np.int64) * W + edges_dst // 32
    bit = np.uint32(1) << (edges_dst % 32).astype(np.uint32)
    table = np.zeros(n * W, np.uint32)
    np.bitwise_or.at(table, word, bit)
    return table.view(np.int32), W


def _expand_pairs(vals: np.ndarray, base: np.ndarray, cnt: np.ndarray,
                  anchor_vals: np.ndarray):
    """For anchor slot i, the pairs ``(anchor_vals[i], vals[base[i] + t])``
    for t < cnt[i], flattened."""
    rep = np.repeat(np.arange(cnt.shape[0], dtype=np.int64), cnt)
    cum = np.zeros(cnt.shape[0], np.int64)
    np.cumsum(cnt[:-1], out=cum[1:])
    off = np.arange(rep.shape[0], dtype=np.int64) - cum[rep]
    return anchor_vals[rep], vals[base[rep] + off]


def _count_expanded(table: torch.Tensor, u: torch.Tensor, w_arr: torch.Tensor,
                    w: int) -> torch.Tensor:
    """0-d int64: the wedges whose bit ``(u, w_arr)`` is set."""
    word = table[u * w + (w_arr >> 5)]
    return ((word >> (w_arr & 31).to(torch.int32)) & 1).sum()


def _bitmap_blob(src, dst, n, u, w_arr, dev):
    table, W = _bitword_table(src, dst, n)
    return (torch.from_numpy(table).to(dev), W,
            torch.from_numpy(u).to(dev), torch.from_numpy(w_arr).to(dev))


# ---------------------------------------------------------------------------
# The general path: searchsorted decode, binary-search membership
# ---------------------------------------------------------------------------

_SEARCH_KEYS = ("calls", "chunks", "wedges", "steps")
_SEARCH_COUNTS = dict.fromkeys(_SEARCH_KEYS, 0)
_SEARCH_LOCK = threading.Lock()


def reset_search_counts() -> None:
    """Set every count of :func:`search_counts` to 0."""
    with _SEARCH_LOCK:
        _SEARCH_COUNTS.update(dict.fromkeys(_SEARCH_KEYS, 0))


def search_counts() -> dict:
    """Summed over the ``count_search`` calls since the last reset:
    ``calls``, ``chunks`` (device steps: on the card one kernel launch a
    call with a wedge, on the CPU passes of at most ``chunk`` wedges),
    ``wedges`` tested and ``steps``, the plain path's bisection passes
    (each over one chunk's wedges; 0 on the card, whose kernel bisects
    each wedge's row in registers).  Taken from sizes the host already
    holds: counting reads nothing from the device beyond what the search
    reads itself."""
    with _SEARCH_LOCK:
        return dict(_SEARCH_COUNTS)


def count_search(ctx: DagContext, chunk: int = _kernels.SEARCH_CHUNK) -> int:
    """Sum over all wedge ids k of [c in N+(b)]: anchor slot i is the last
    with ``pair_cum[i] <= k``, the wedge is ``(dag_dst[i], dag_dst[i + 1 +
    k - pair_cum[i]])``, membership a binary search in row b.  One call of
    ``kernels.triangle_search`` inside one ``gm:triangle:chunk`` span: on
    the card one launch (``chunk`` unused), on the CPU its plain version,
    ``chunk`` wedges a pass; the count read once."""
    on_card = ctx.dag_dst.device.type == "cuda"
    if on_card:
        chunks, steps = int(ctx.num_wedges > 0), 0
    else:
        chunks = -(-ctx.num_wedges // chunk)
        steps = _kernels.search_steps(ctx.dag_begin)
    with _SEARCH_LOCK:
        _SEARCH_COUNTS["calls"] += 1
        _SEARCH_COUNTS["chunks"] += chunks
        _SEARCH_COUNTS["wedges"] += ctx.num_wedges
        _SEARCH_COUNTS["steps"] += chunks * steps
    if not ctx.num_wedges:
        return 0
    with span("gm:triangle:chunk"):
        total = _kernels.triangle_search(ctx.dag_begin, ctx.dag_dst,
                                         ctx.pair_cum, ctx.num_wedges, chunk)
    return int(total)


# ---------------------------------------------------------------------------
# The sort-merge join
# ---------------------------------------------------------------------------

_HASH_MIN_W = 1 << 63        # wedges from which the join is taken (none)
_SM_DISPATCH_W = 1 << 27     # lanes per sort
_SM_WS = 1 << 29             # b and c of lanes that hold no wedge


def descending_row_layout(dag_begin: np.ndarray, dag_dst: np.ndarray, D: int):
    """Rows reordered by descending pair count (stable), on the host.
    Returns ``(perm_dst [D] int32, cum64 [D+1], starts [N+1])``: the
    permuted destination ranks, the wedge prefix over the permuted slot
    axis and the permuted row offsets."""
    n = dag_begin.shape[0] - 1
    if native.available():
        perm_dst, nb = native.desc_layout(dag_begin, dag_dst, n, D)
        starts = nb.astype(np.int64)
        new_deg = np.diff(starts)
    else:
        begin64 = dag_begin.astype(np.int64)
        order = desc_order(begin64).astype(np.int64)
        new_deg = np.diff(begin64)[order]
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(new_deg, out=starts[1:])
        rep = np.repeat(np.arange(n, dtype=np.int64), new_deg)
        offs = np.arange(rep.shape[0], dtype=np.int64) - starts[rep]
        perm_dst = dag_dst[begin64[order[rep]] + offs]
    total = int(starts[-1])
    rep = np.repeat(np.arange(n, dtype=np.int64), new_deg)
    pairs = starts[rep + 1] - np.arange(total, dtype=np.int64) - 1
    cum = np.zeros(total + 1, np.int64)
    np.cumsum(pairs, out=cum[1:])
    return perm_dst.astype(np.int32), cum, starts


def desc_order(rank_begin: np.ndarray) -> np.ndarray:
    """Rank ids in the row order of ``descending_row_layout`` (stable, pairs
    descending; ties keep ascending rank)."""
    deg = np.diff(rank_begin.astype(np.int64))
    return np.argsort(-(deg * (deg - 1) // 2), kind="stable").astype(np.int32)


def _permuted_ctx(ctx: DagContext) -> DagContext:
    """``ctx`` over the descending-pair layout.  Its ``dag_begin`` indexes
    row positions, not ranks: for the join only, never for the search."""
    D = ctx.num_dag_edges
    dev = ctx.dag_dst.device
    n = ctx.dag_begin.numel() - 1
    perm_dst, cum, starts = descending_row_layout(
        ctx.dag_begin.cpu().numpy(), ctx.dag_dst.cpu().numpy(), D)
    d_pad = ctx.dag_dst.numel()
    out_dst = np.full(d_pad, n, np.int32)
    out_dst[:D] = perm_dst
    pc = np.full(d_pad + 1, cum[-1], np.int64)
    pc[: cum.shape[0]] = cum
    return DagContext(
        dag_begin=torch.from_numpy(starts.astype(np.int32)).to(dev),
        dag_dst=torch.from_numpy(out_dst).to(dev),
        pair_cum=torch.from_numpy(pc).to(dev),
        num_wedges=ctx.num_wedges, num_dag_edges=D)


def _scatter_rows(db: torch.Tensor, vals: torch.Tensor,
                  d_len: int) -> torch.Tensor:
    """[d_len]: ``vals[r]`` forward-filled from row r's first slot (the max
    where empty rows share a slot); rows that start past ``d_len`` drop."""
    starts = db[:-1].long()
    keep = starts < d_len
    out = torch.zeros(d_len, dtype=vals.dtype, device=db.device)
    out.scatter_reduce_(0, starts[keep], vals[keep], "amax")
    return torch.cummax(out, 0).values


def _pairs_on_device(db: torch.Tensor, d_len: int) -> torch.Tensor:
    """Per-slot pair count from the permuted row offsets: each row's end,
    forward-filled, less the slot index.  Padding slots come out negative,
    so no shift is valid for them."""
    rowend = _scatter_rows(db, db[1:], d_len)
    return rowend - torch.arange(d_len, dtype=db.dtype, device=db.device) - 1


def _edge_keys_desc(dd: torch.Tensor, db: torch.Tensor, order: torch.Tensor,
                    num_dag_edges: int) -> torch.Tensor:
    """[D] int64 keys ``rank << 32 | dst * 2`` of the DAG edges, from the
    descending-pair layout: the row of each slot, then its rank id by
    ``order`` (``desc_order`` of the rank-ordered DAG)."""
    D = num_dag_edges
    rows = torch.arange(order.numel(), dtype=torch.int32, device=dd.device)
    rid = _scatter_rows(db, rows, D)
    return (order[rid.long()].long() << 32) | (dd[:D].long() << 1)


def _shift_pieces(dag_begin_np: np.ndarray, s_cut: int, D: int,
                  chunk: int) -> np.ndarray:
    """Host-side ``(d, slot0)`` descriptors of ``chunk`` lanes each that
    cover every wedge anchored at slots ``[s_cut, D)``.  Rows are sorted by
    length, descending, so the slots with at least d pairs all lie below
    ``R_d``, the end of the rows longer than d."""
    lens = np.diff(dag_begin_np.astype(np.int64))
    lens = lens[lens > 0]
    pieces = []
    for d in range(1, int(lens.max(initial=1))):
        r_cnt = int(np.searchsorted(-lens, -(d + 1), side="right"))
        r_d = int(dag_begin_np[r_cnt])
        if r_d <= s_cut:
            continue
        s0 = np.arange(s_cut, r_d, chunk, dtype=np.int64)
        pieces.append(np.stack([np.full_like(s0, d), s0], axis=1))
    if not pieces:
        return np.zeros((0, 2), np.int32)
    return np.concatenate(pieces).astype(np.int32)


def _count_wedges_sortmerge(dd: torch.Tensor, pairs: torch.Tensor,
                            desc: torch.Tensor, ekeys: torch.Tensor,
                            chunk: int) -> torch.Tensor:
    """One dispatch: the descriptors ``desc`` [P, 2] give ``P * chunk``
    lanes; lane ``s = slot0 + t`` holds wedge ``(dd[s], dd[s + d])`` where
    ``pairs[s] >= d``.  Wedge keys are odd, edge keys even, so after one
    sort an edge stands right below the run of its wedges: a wedge hits
    where the last edge key at or before it is its own key less one."""
    d = desc[:, :1]
    s = (desc[:, 1:] + torch.arange(chunk, dtype=torch.int32,
                                    device=dd.device)).reshape(-1)
    valid = (pairs.index_select(0, s).view(-1, chunk) >= d).reshape(-1)
    b = dd.index_select(0, s).long()
    c = dd.index_select(0, (s.view(-1, chunk) + d).reshape(-1)).long()
    invalid = (_SM_WS << 32) | (2 * _SM_WS + 1)
    wkeys = torch.where(valid, (b << 32) | (c << 1) | 1, invalid)
    del s, b, c, valid
    keys = torch.sort(torch.cat([ekeys, wkeys])).values
    is_w = (keys & 1) == 1
    last_edge = torch.cummax(torch.where(is_w, -1, keys), 0).values
    return (is_w & (last_edge == keys - 1)).sum()


def _count_sortmerge_region(perm: DagContext, ekeys: torch.Tensor,
                            dag_begin_np: np.ndarray, s_cut: int,
                            chunk: int = 1 << 17) -> torch.Tensor:
    """0-d int64: the count over all wedges anchored at slots >= ``s_cut``
    of the permuted layout, in dispatches of at most ``_SM_DISPATCH_W``
    lanes."""
    dev = perm.dag_dst.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    D = perm.num_dag_edges
    pieces = _shift_pieces(dag_begin_np, s_cut, D, chunk)
    n_p = pieces.shape[0]
    if n_p == 0:
        return total
    width = _SM_DISPATCH_W
    while width // chunk > n_p * 2 and width > chunk:
        width //= 2                      # small regions: small sorts
    per = max(width // chunk, 1)
    # pad so that a shifted lane never leaves the array; pad pairs < 0
    need = int(pieces[:, 1].max()) + chunk + int(pieces[:, 0].max())
    dd = perm.dag_dst
    if dd.numel() < need:
        dd = torch.nn.functional.pad(dd, (0, need - dd.numel()))
    pairs = _pairs_on_device(perm.dag_begin, dd.numel())
    desc = torch.from_numpy(pieces).to(dev)
    for p0 in range(0, n_p, per):
        total += _count_wedges_sortmerge(dd, pairs, desc[p0:p0 + per], ekeys,
                                         chunk)
    return total


def _sortmerge_prep(ctx: DagContext):
    """``(permuted context, edge keys, permuted row offsets on the host)``
    of ``ctx``, made once: the host layout, then the keys on the device."""
    prep = _prep_of(ctx)
    if "sm" not in prep:
        perm = _permuted_ctx(ctx)
        order = torch.from_numpy(desc_order(ctx.dag_begin.cpu().numpy())) \
            .to(ctx.dag_dst.device)
        ekeys = _edge_keys_desc(perm.dag_dst, perm.dag_begin, order,
                                ctx.num_dag_edges)
        prep["sm"] = (perm, ekeys, perm.dag_begin.cpu().numpy())
    return prep["sm"]


def count_sortmerge(ctx: DagContext, chunk: int = 1 << 17) -> int:
    """The triangle count of the DAG ``ctx`` by the sort-merge join (any
    size)."""
    if ctx.num_wedges == 0:
        return 0
    perm, ekeys, perm_begin_np = _sortmerge_prep(ctx)
    return int(_count_sortmerge_region(perm, ekeys, perm_begin_np, 0, chunk))


def route(ctx: DagContext) -> str:
    """The path ``count_dag`` takes for ``ctx``: ``none`` (no wedge),
    ``bitmap``, ``sortmerge`` or ``search`` (module docstring)."""
    if ctx.num_wedges == 0:
        return "none"
    n = ctx.dag_begin.numel() - 1
    if n <= _BITMAP_MAX_N and ctx.num_wedges <= _EXPAND_MAX_W:
        return "bitmap"
    if ctx.num_wedges >= _HASH_MIN_W:
        return "sortmerge"
    return "search"


def _count_bitmap(ctx: DagContext) -> int:
    """The count of a small DAG by its wedges, expanded on the host once,
    against the packed adjacency bitmap."""
    prep = _prep_of(ctx)
    if "dag_fast" not in prep:
        n = ctx.dag_begin.numel() - 1
        D = ctx.num_dag_edges
        dag_begin = ctx.dag_begin.cpu().numpy().astype(np.int64)
        dag_dst = ctx.dag_dst.cpu().numpy().astype(np.int64)
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(dag_begin))
        slots = np.arange(D, dtype=np.int64)
        b, c = _expand_pairs(dag_dst, slots + 1,
                             dag_begin[src + 1] - slots - 1, dag_dst[:D])
        prep["dag_fast"] = _bitmap_blob(src, dag_dst[:D], n, b, c,
                                        ctx.dag_dst.device)
    table, W, b, c = prep["dag_fast"]
    return int(_count_expanded(table, b, c, W))


def count_dag(ctx: DagContext, chunk: int = 1 << 24) -> int:
    """The triangle count of the DAG ``ctx`` by the path ``route`` gives;
    each call a ``gm:triangle:count`` span."""
    with span("gm:triangle:count"):
        path = route(ctx)
        if path == "bitmap":
            return _count_bitmap(ctx)
        if path == "sortmerge":
            return count_sortmerge(ctx, min(chunk, 1 << 17))
        if path == "search":
            return count_search(ctx, chunk)
        return 0


def triangle_count(g: Graph, chunk: int = 1 << 24,
                   edge_chunk: int = 1 << 17) -> int:
    """Count the triangles of the undirected (symmetric) graph ``g``;
    returns a Python int (the reference prints ``number of triangles: T``).
    ``chunk``: wedges per device step of the search, lanes per descriptor of
    the join (at most 2^17 there).  ``edge_chunk`` is accepted for the JAX
    package's call sites and not used, as there."""
    return count_dag(_dag_of(g), chunk)


def triangle_count_np(begin, node_idx):
    """Host oracle: triangle_counting.gm, transliterated."""
    begin = np.asarray(begin)
    node_idx = np.asarray(node_idx)
    N = begin.shape[0] - 1
    rows = [set(node_idx[begin[v]:begin[v + 1]].tolist()) for v in range(N)]
    T = 0
    for v in range(N):
        nbrs = sorted(rows[v])
        for u in nbrs:
            if u <= v:
                continue
            for w in nbrs:
                if w <= u:
                    continue
                if u in rows[w]:
                    T += 1
    return T


# ---------------------------------------------------------------------------
# Literal semantics (directed graphs, multigraph slot counting)
# ---------------------------------------------------------------------------

class LiteralCtx(NamedTuple):
    f_dst: torch.Tensor     # [F_pad] int32 dst of the slots with dst > src
    jbase: torch.Tensor     # [F_pad] int64 first slot strictly greater
    pair_cum: torch.Tensor  # [F_pad+1] int64
    num_wedges: int
    cum64: np.ndarray       # [F_pad+1] the same prefix on the host


def build_literal(g: Graph) -> LiteralCtx:
    """Host-side wedge schedule for the literal semantics:
    ``Foreach(u: v.Nbrs)(u > v) Foreach(w: v.Nbrs)(w > u)`` walks CSR
    *slots* with strict value order, so parallel edges multiply the wedges
    as the reference's generated loops do."""
    begin = g.begin.cpu().numpy()
    dst = g.node_idx[: g.num_edges].cpu().numpy().astype(np.int64)
    N = g.num_nodes
    src = np.repeat(np.arange(N, dtype=np.int64),
                    np.diff(begin).astype(np.int64))
    keep = dst > src                     # a suffix of each sorted row
    f_dst_np = dst[keep]
    f_src = src[keep]
    f_begin = np.zeros(N + 1, np.int64)
    np.cumsum(np.bincount(f_src, minlength=N), out=f_begin[1:])
    F = int(f_dst_np.shape[0])

    # pairs start past the run of equal (row, value) slots that holds i
    if F:
        same_next = np.zeros(F, bool)
        same_next[:-1] = (f_dst_np[1:] == f_dst_np[:-1]) & \
            (f_src[1:] == f_src[:-1])
        brk = np.nonzero(~same_next)[0]          # last slot of each run
        run_id = np.zeros(F, np.int64)
        run_id[1:] = (~same_next[:-1]).cumsum()
        jbase_np = brk[run_id] + 1
    else:
        jbase_np = np.zeros(0, np.int64)
    pairs = np.maximum(f_begin[f_src + 1] - jbase_np, 0)

    f_pad = round_up(max(F, 1))
    pair_cum = np.zeros(f_pad + 1, np.int64)
    np.cumsum(pairs, out=pair_cum[1:F + 1])
    pair_cum[F + 1:] = pair_cum[F]
    f_dst_pad = np.full(f_pad, N, np.int32)
    f_dst_pad[:F] = f_dst_np
    jbase_pad = np.zeros(f_pad, np.int64)
    jbase_pad[:F] = jbase_np
    dev = g.device
    return LiteralCtx(
        f_dst=torch.from_numpy(f_dst_pad).to(dev),
        jbase=torch.from_numpy(jbase_pad).to(dev),
        pair_cum=torch.from_numpy(pair_cum).to(dev),
        num_wedges=int(pair_cum[F]), cum64=pair_cum)


def _count_wedges_literal(g: Graph, ctx: LiteralCtx,
                          chunk: int) -> torch.Tensor:
    """0-d int64: sum over wedges k of ``HasEdgeTo(w_k, u_k)`` in the
    graph's own directed CSR."""
    dev = g.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    last = ctx.f_dst.numel() - 1
    for k0 in range(0, ctx.num_wedges, chunk):
        k = torch.arange(k0, min(k0 + chunk, ctx.num_wedges), device=dev)
        i = torch.searchsorted(ctx.pair_cum, k, right=True) - 1
        j = ctx.jbase[i] + k - ctx.pair_cum[i]
        total += has_edge_to(g, ctx.f_dst[j.clamp(max=last)],
                             ctx.f_dst[i]).sum()
    return total


def triangle_count_literal(g: Graph, chunk: int = 1 << 24) -> int:
    """The reference's semantics on any graph (directed, multi-): the entry
    point of the CLI.  ``triangle_count`` is the fast path for symmetric
    simple graphs, where both agree."""
    prep = _prep_of(g)
    if "lit" not in prep:
        prep["lit"] = build_literal(g)
    ctx = prep["lit"]
    if ctx.num_wedges == 0:
        return 0
    n = g.num_nodes
    if n <= _BITMAP_MAX_N and ctx.num_wedges <= _EXPAND_MAX_W:
        if "lit_fast" not in prep:
            e = g.num_edges
            f_dst = ctx.f_dst.cpu().numpy().astype(np.int64)
            u, w_arr = _expand_pairs(f_dst, ctx.jbase.cpu().numpy(),
                                     np.diff(ctx.cum64), f_dst)
            # hit = HasEdgeTo(w, u): the edge (w -> u) of the CSR
            prep["lit_fast"] = _bitmap_blob(
                g.node_idx_src[:e].cpu().numpy().astype(np.int64),
                g.node_idx[:e].cpu().numpy().astype(np.int64), n, w_arr, u,
                g.device)
        table, W, ww, uu = prep["lit_fast"]
        return int(_count_expanded(table, ww, uu, W))
    return int(_count_wedges_literal(g, ctx, chunk))
