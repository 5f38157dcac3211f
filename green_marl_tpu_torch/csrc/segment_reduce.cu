// Sorted-segment reduction: out[v] = op-reduce(vals[offsets[v] : offsets[v+1]]).
//
// Replaces the TPU kernel `_seg_scan_kernel` (green_marl_tpu/ops/pallas_kernels.py,
// reached through `segmented_scan` and `segment_reduce_sorted`).  The TPU
// kernel scans every edge slot with a cross-chunk carry and its caller then
// gathers each segment's tail; every caller only ever reads those tails, so
// this kernel reduces each run [offsets[v], offsets[v+1]) directly.  No chunk
// padding, no -2 pad ids, no full scan written back to memory, and the ids
// are never read.
//
// Bound on an H100: device-memory bandwidth.  Each edge value is read once
// (4 B) and each segment reads an offset and writes a result; there is no
// arithmetic to speak of.  What decides the time is how many bytes a block
// keeps in flight.  One warp per segment (the first design) had a warp wait
// for two dependent loads of 56 bytes at the LiveJournal-scale graph's mean
// in-degree of 14: latency, not bandwidth, bound it at 7.5x the bytes' time.
//
// The design, two launches (a small one for the row bounds, then the tiles):
//   - a block owns a tile of kTile consecutive edge slots, not a set of
//     rows, and copies it into shared memory with 16-byte `cp.async`
//     requests: every lane carries bytes whatever the degrees are, and no
//     registers hold them meanwhile;
//   - blocks are persistent: a grid of G blocks, as many as the card holds
//     at once, of which block b takes tiles b, b + G, b + 2G, ..., so that
//     the tiles in work at any moment are neighbours.  While a block works
//     on one tile, the next one's values and offsets are already on their
//     way into a second buffer, and the row bounds of the one after are
//     being read: no tile starts with a chain of dependent loads;
//   - row v belongs to the tile that holds its last slot, so each row has
//     one owner; an empty row belongs to the tile that holds the slot before
//     its position (tile 0 for position 0).  `tile_rows_kernel` finds each
//     tile's first row by a 32-way search of `offsets`, one warp per tile
//     (five rounds of one probe per lane at 4.8M rows);
//   - a tile first goes over its rows, 512 offsets at a time through
//     shared memory: an empty row gets the identity, any other sets a bit at
//     the slot where it ends and leaves its number there.  Every block also
//     writes the identity to its share of rows n_seg..n_out-1;
//   - runs of empty rows: the rows fall into chunks of kRowChunk at fixed
//     places (chunk j holds rows [512 j, 512 j + 512)).  A chunk whose first
//     and last offsets are equal holds only empty rows.  Warps of
//     `tile_rows_kernel` beside those of the search test every chunk, one
//     lane a chunk, and write the identity to each empty one; at the first
//     empty chunk of a run (the chunk before it is not empty) the warp
//     searches `offsets` for the end of the run and leaves, for that chunk,
//     the first row after the run's last whole chunk.  A tile whose row
//     pass meets 512 empty rows in a row finds that bound at one of the two
//     chunks nearest, writes the rows before the run's first whole chunk
//     and goes on after its last.  Before this, a shard's edge slab whose
//     offsets are clipped to the slab (3.9M empty rows at slot 0 and at the
//     end) had one block walk all of them, 512 rows and two barriers at a
//     time: 3.6 ms where the rest of the slab takes 0.06.  The tile kernel
//     keeps only a comparison a row load and two loads at a run for this:
//     with the fill and the search inside it, int32 min at the
//     LiveJournal-scale shape took 8% longer on an H100 80GB HBM3 at 700 W
//     (more registers spilled), with the search a call 17-19%; the chunk
//     tests in the search warps added 2.4 us to that launch.  The other
//     design, a pass that writes every empty row, reads every offset a
//     second time (19 MB more at that shape, where no chunk is empty);
//   - then the tile goes over its slots: each thread takes kPer consecutive
//     slots out of shared memory into registers (16-byte loads from a
//     rotated layout, free of bank conflicts) and walks them in order.  A
//     row that starts and ends among them is complete at once.  The part
//     before the thread's first row end and the part after its last go
//     through one block-wide scan of (ended, value) pairs, which completes
//     the rows that span threads.  Every thread does the same work whatever
//     the degrees are: a hub costs what as many short rows cost;
//   - the rows' results meet in shared memory and leave together, one
//     coalesced store per 256 rows (a tile of more than 512 rows, all short
//     or empty, writes each result on its own);
//   - a row cut by a tile edge (every hub, and one short row at nearly every
//     edge) is combined across tiles by look-back: the scan's total is the
//     part of the row still open at the tile's end, published in the tile's
//     status word (lookback.cuh), state 2 if the row starts in this tile,
//     state 1 if the tile lies wholly inside it.  Only the tile that holds
//     the row's end needs the carry, and it does not wait for it: the block
//     reads the status words at the start of its next tile and finishes the
//     cut row at that tile's end, when the words have long arrived.  Tiles
//     inside a hub never wait, so the set of words that is combined, and
//     their order, depend on the data alone: float32 add gives the same
//     bits from run to run.  The price is that the end tile of a row that
//     spans T tiles reads T status words, 32 at a time.
// The grid is launched cooperatively, so the runtime guarantees that all G
// blocks run together (or refuses the launch): the block that a look-back
// waits for is always running, works through its tiles in rising order, and
// the lowest unfinished tile never waits.  (Tile numbers drawn from a
// counter, as cumsum.cu draws them, would give the same guarantee, but a
// block that holds three drawn tiles at once, one in work and two on their
// way, makes the block with the tile after them wait for all three: 7 ms.)
//
// What was measured on the way, on an NVIDIA H100 80GB HBM3 at 700 W at the
// LiveJournal-scale pull shape (PERF.md has the runs).  One tile per block,
// a group of 1..32 lanes per row sized from the tile's mean row length:
// 0.201-0.231 ms, the lanes of a warp waiting for its longest row (two
// thirds of the rows have under 8 slots, one in nine over 32).  One tile per
// block with the slot walk above: 0.221.  Persistent blocks with the next
// tile on its way: 0.225, of which waiting for the cut row's carry at each
// tile's end took 0.077, the pass over the rows 0.047, and storing each
// result on its own 0.05 (each timed by leaving it out).  With the carry put
// off by a tile and the results leaving together: 0.186-0.190.
//
// Lanes: vals [B, n_vals] and out [B, n_out] with one offsets array for all
// of them go to a kernel of their own (segment_reduce_lanes_kernel below),
// which shares the row-bounds launch and gives each lane the bits of the
// one-row launch on its row.
//
// The gather form (kGather; replaces no TPU kernel: the JAX package's
// min-relaxation, green_marl_tpu/models/relax.py, gathers, masks and adds in
// XLA before its segment min) is the superstep of hop_dist and sssp in one
// launch, min only: vals holds each slot's source id, and slot i contributes
//   node_vals[vals[i]] + add[i]  (1 without add)  where node_mask[vals[i]],
//   the identity where not,
// the add done as PyTorch does it (uint32 for int32, one IEEE add for
// float32), so the result has the bits of gather, gather, where and the
// plain reduce.  The tile's `cp.async` stage brings in the ids, the slot
// pass is the one above.  Bound by bytes: the ids (and the weights)
// streamed once, 4-8 bytes a slot where the five PyTorch passes moved ~40.
// What bounds it in fact is random reads, one of the flags a slot and one
// of node_vals a slot whose source is set, each a 32-byte sector: at
// 4.8M nodes both tables stay in the L2, at 16.8M node_vals misses it.
//   - Each thread requests its slots' flags right after the tile's ids
//     arrive, before the pass over the rows, and the values (and the
//     weights of the vectors of slots with a set source) as soon as the
//     flags are in, all before the first use.  The reads go to the L2 only
//     (`ld.global.cg`): nothing of the tables is read twice by one SM.
//   - Two blocks an SM (kGatherBlocksPerSM): no registers spilled, and the
//     L1 keeps room for the reads in flight.
//   - A summary of the flags, one bit for 2^shift nodes, built by
//     mask_summary_kernel before the tiles and held whole in each block's
//     shared memory (kSummaryWords): a slot whose source's bit is clear
//     reads no flag.  Most supersteps set few sources (a BFS wave's head
//     and tail), and there the flags' reads were most of the time: at a
//     share of 0 of the sources set, 0.68 -> 0.35 ms at the
//     soc-LiveJournal1 shape, 4.9 -> 2.3 ms at Graph500 scale 24.
//   - Four instantiations: int32 (hop_dist, and sssp with add) and float32
//     (min_relax's float distances, with and without add).  ids and add
//     must be 16-byte aligned, so the stage is always the 16-byte one
//     (the wrapper copies a view that is not aligned).
//
// Empty segments and rows v >= n_seg get the op's identity: 0, INT32_MAX,
// INT32_MIN for int32 and 0, +inf, -inf for float32.  Slots outside
// [offsets[0], offsets[n_seg]) count as the identity.  Integer add wraps mod
// 2^32.  Float add differs from a sequential sum only by rounding; its order
// is fixed: a thread's slots in order, the threads' parts by the scan's
// tree, for a cut row the farther tiles' parts first.  A `vals` pointer that
// is not 16-byte aligned takes the same kernel with 4-byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lookback.cuh"

namespace {

using gm::kFull;
using gm::Red;

// The gather form's node tables: values and flags by node id, a value by
// slot to add (null: 1), and the flags' summary: bit g of `summary` is set
// where a node of [g << shift, (g + 1) << shift) is (shift 0: the flags).
template <typename T>
struct NodeTables {
  const T* vals;
  const uint8_t* mask;
  const T* add;
  const uint32_t* summary;
  int64_t summary_words;
  int shift;
};

// x + w as PyTorch adds two tensors of the type: int32 wraps mod 2^32,
// float32 rounds once (no contraction into a neighbouring operation).
__device__ __forceinline__ int32_t torch_add(int32_t x, int32_t w) {
  return (int32_t)((uint32_t)x + (uint32_t)w);
}
__device__ __forceinline__ float torch_add(float x, float w) {
  return __fadd_rn(x, w);
}

// Measured on an NVIDIA H100 80GB HBM3 at 700 W, LiveJournal-scale pull
// shape (PERF.md): 4 vectors with the registers capped for 4 blocks per SM
// 0.186-0.190 ms; capped for 3 blocks 0.195; capped for 1 (79 registers or
// more) 0.236; 8 vectors (2 blocks) 0.206; 2 vectors 0.33-0.35.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;            // 16-byte vectors (4 slots each) per thread
constexpr int kBlocksPerSM = 4;     // blocks per SM that the registers must allow
// The gather form's, measured at the benchmark's graph shapes on the same
// card (PERF.md), ms at a share of 0 and 1 of the sources set, lj then
// g500s24: 4 blocks (64 registers, 132-180 bytes spilled) 0.88, 2.17 and
// 9.34, 27.7; 3 blocks (80 registers) 0.77, 1.34 and 5.40, 13.6; 2 blocks
// (no spills) 0.67, 1.25 and 5.07, 12.9.  Fewer blocks leave more of the
// SM's 256 KB to the L1, which holds the random reads in flight.
constexpr int kGatherBlocksPerSM = 2;
constexpr int kPer = 4 * kVecs;                    // consecutive slots a thread
constexpr int kTile = kThreads * kPer;             // edge slots per tile
constexpr int kRowChunk = 512;                     // rows per offsets load
static_assert(kVecs == 2 || kVecs == 4 || kVecs == 8, "see phys_vec");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where vector m of thread t (slots [kPer*t + 4*m, +4) of the tile) lies in
// shared memory.  A thread reads its kVecs vectors with 16-byte loads; eight
// neighbouring threads are served together, and the rotation by t spreads
// their vectors over all eight 16-byte bank groups.
__device__ __forceinline__ int phys_vec(int t, int m) {
  return kVecs * t + ((m + t / (8 / kVecs)) & (kVecs - 1));
}

// One warp: the first v in [lo, hi) with offsets[v + 1] > x (hi if there is
// none).  Each round probes 32 points that split the range into 33.
__device__ int64_t
warp_upper_bound(const int32_t* __restrict__ offsets, int64_t lo, int64_t hi,
                 int64_t x, int lane) {
  while (lo < hi) {
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;       // in [lo, hi)
    const unsigned gt = __ballot_sync(kFull, (int64_t)offsets[p + 1] > x);
    const int f = gt ? __ffs(gt) - 1 : 32;   // first lane whose probe is > x
    const int64_t p_f = __shfl_sync(kFull, p, f & 31);
    const int64_t p_b = __shfl_sync(kFull, p, (f + 31) & 31);
    if (f > 0) lo = p_b + 1;
    if (f < 32) hi = p_f;
  }
  return lo;
}

// Row bounds of the tiles, one warp each: rows[t] is the first row that
// ends after slot t * kTile, so tile t owns rows [rows[t], rows[t + 1]).
// The warps after those test the chunks of kRowChunk rows, 32 chunks a
// warp, one a lane (the searches and the tests run side by side): an empty
// chunk gets the identity in every row of each of the n_lanes rows of out,
// and run_end[j] is 0 unless chunk j is the first empty chunk of a run,
// where it is the row after the run's last empty chunk (n_seg if the run
// reaches the end).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
tile_rows_kernel(const int32_t* __restrict__ offsets, int64_t n_seg,
                 int64_t n_tiles, int64_t* __restrict__ rows,
                 int64_t* __restrict__ run_end, T* __restrict__ out,
                 int64_t n_out, int64_t n_lanes) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t <= n_tiles) {                            // whole warps
    int64_t r = 0;
    if (t == n_tiles) r = n_seg;
    else if (t > 0) r = warp_upper_bound(offsets, 0, n_seg, t * kTile, lane);
    if (lane == 0) rows[t] = r;
    return;
  }
  const int64_t n_chunks = (n_seg + kRowChunk - 1) / kRowChunk;
  const int64_t c0 = (t - n_tiles - 1) * 32;
  const int64_t j = c0 + lane;
  bool empty = false, first = false;
  int32_t x = 0;
  if (j < n_chunks) {
    const int64_t a = j * kRowChunk;
    x = offsets[a];
    empty = x == offsets[a + kRowChunk < n_seg ? a + kRowChunk : n_seg];
    first = empty && (j == 0 || offsets[a - kRowChunk] != x);
    if (!first) run_end[j] = 0;
  }
  for (unsigned m = __ballot_sync(kFull, empty); m; m &= m - 1) {
    const int64_t a = (c0 + __ffs(m) - 1) * kRowChunk;
    const int64_t b = a + kRowChunk < n_seg ? a + kRowChunk : n_seg;
    for (int64_t l = 0; l < n_lanes; ++l)
      for (int64_t v = a + lane; v < b; v += 32)
        out[l * n_out + v] = Red<T, OP>::ident();
  }
  for (unsigned m = __ballot_sync(kFull, first); m; m &= m - 1) {
    const int k = __ffs(m) - 1;
    const int64_t lo = (c0 + k + 1) * kRowChunk;
    const int64_t q = warp_upper_bound(offsets, lo < n_seg ? lo : n_seg,
                                       n_seg, __shfl_sync(kFull, x, k),
                                       lane);
    if (lane == 0)
      run_end[c0 + k] = q == n_seg ? n_seg : q / kRowChunk * kRowChunk;
  }
}

// (pf, pv) . (f, v), the pair on the left coming first: a set flag says
// that a row ended inside, and the value is what came after its end.
template <typename R>
__device__ __forceinline__ void combine(int pf, typename R::type pv, int& f,
                                        typename R::type& v) {
  if (!f) v = R::apply(pv, v);
  f |= pf;
}

// Shared memory of one block, in bytes: two tiles of values, the row
// numbers, two loads of offsets, the rows' results, the row-end bits.
constexpr int kOffBuf = kRowChunk + 1;
constexpr size_t kSmemBytes =
    (size_t)(2 * kTile + kTile + 2 * kOffBuf + kRowChunk + kTile / 32) * 4;
// The gather form's summary of the flags, kept whole in each block's shared
// memory behind the rest: at most kSummaryWords words, one bit for each
// 2^shift nodes, shift the least that fits (0 up to 212,992 nodes; 32 nodes
// a bit at soc-LiveJournal1's 4.8M, 128 at Graph500 scale 24's 16.8M).  26
// KB keeps two blocks an SM in the 164 KB carve-out, which leaves the L1 96
// KB for the reads in flight.  Measured at the benchmark's shapes on the
// same card (PERF.md), slot passes of a whole sssp, lj then g500s24: no
// summary 17.7 and 204 ms; 40 KB (16 and 64 nodes a bit, the 196 KB
// carve-out) 15.0 and 183; 26 KB 15.3 and 173.
constexpr int kSummaryWords = 6656;
constexpr size_t kGatherSmemBytes = kSmemBytes + (size_t)kSummaryWords * 4;

// The summary, one warp a word: lane l sets bit l where a flag of its
// 2^shift nodes is set.
__global__ void __launch_bounds__(kThreads)
mask_summary_kernel(const uint8_t* __restrict__ mask, int64_t n_nodes,
                    int shift, uint32_t* __restrict__ summary,
                    int64_t n_words) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_words) return;                      // whole warps
  const int64_t lo = ((w << 5) + lane) << shift;
  int64_t hi = lo + ((int64_t)1 << shift);
  hi = hi < n_nodes ? hi : n_nodes;
  bool any = false;
  int64_t v = lo;
  if (shift >= 4 && (uintptr_t)mask % 16 == 0)   // 16 flags a load
    for (; v + 16 <= hi; v += 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(mask + v));
      any |= (q.x | q.y | q.z | q.w) != 0u;
    }
  for (; v < hi; ++v) any |= mask[v] != 0;
  const unsigned bits = __ballot_sync(kFull, any);
  if (lane == 0) summary[w] = bits;
}

// kGather: vals holds source ids and `nt` the node tables (see the head of
// the file); kAdd: nt.add is given.  Without kGather, nt is not read.
template <typename T, int OP, bool kVec, bool kGather = false,
          bool kAdd = false>
__global__ void __launch_bounds__(kThreads,
                                  kGather ? kGatherBlocksPerSM : kBlocksPerSM)
segment_reduce_kernel(
    const typename std::conditional<kGather, int32_t, T>::type* __restrict__
        vals,
    int64_t n_vals, const int32_t* __restrict__ offsets, int64_t n_seg,
    int64_t n_out, T* __restrict__ out, uint64_t* __restrict__ status,
    const int64_t* __restrict__ tile_rows,
    const int64_t* __restrict__ run_end, int64_t n_tiles, NodeTables<T> nt) {
  typedef Red<T, OP> R;
  // what the tile's stage holds: the values, or the gather form's ids
  typedef typename std::conditional<kGather, int32_t, T>::type S;
  static_assert(!kGather || OP == gm::OP_MIN, "the gather form is a min");
  extern __shared__ __align__(16) unsigned char smem[];
  S* const s_vals = reinterpret_cast<S*>(smem);  // [2][kTile], phys_vec order
  // s_row[k]: the row that ends at slot k, counted from the tile's first row
  int32_t* const s_row = reinterpret_cast<int32_t*>(smem) + 2 * kTile;
  int32_t* const s_off = s_row + kTile;          // [2][kOffBuf], as in memory
  T* const s_out = reinterpret_cast<T*>(s_off + 2 * kOffBuf);  // [kRowChunk]
  unsigned* const s_ends = reinterpret_cast<unsigned*>(s_out + kRowChunk);
  // the gather form's summary of the flags, [nt.summary_words]
  uint32_t* const s_sum = reinterpret_cast<uint32_t*>(s_ends + kTile / 32);
  __shared__ int s_wf[kWarps];
  __shared__ T s_wv[kWarps];
  __shared__ T s_head;                           // the cut first row's part
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // rows n_seg..n_out-1: the identity, shared out over the blocks
  for (int64_t v = n_seg + (int64_t)blockIdx.x * kThreads + t; v < n_out;
       v += (int64_t)gridDim.x * kThreads)
    out[v] = R::ident();

  if (t < kTile / 32) s_ends[t] = 0;
  if (kGather)           // read after the first tile's barrier
    for (int64_t i = t; i < nt.summary_words; i += kThreads)
      s_sum[i] = nt.summary[i];
  // the slots that belong to any row at all: [lo, hi)
  const int64_t lo = offsets[0];
  const int64_t hi = offsets[n_seg];

  // Requests tile `tile`'s values and the offsets of its first kRowChunk
  // rows [r0, r1) into buffer b; returns where the row that is still open
  // at the tile's end starts (the tile's end if there is none).
  auto request = [&](int64_t tile, int64_t r0, int64_t r1, int b) -> int64_t {
    const int64_t ts = tile * kTile;
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const int vec = r * kThreads + t;          // coalesced over the threads
      const int64_t i = ts + 4 * vec;
      S* dst = s_vals + b * kTile + 4 * phys_vec(vec / kVecs, vec % kVecs);
      if (kVec && i + 4 <= n_vals) {
        cp_async16(dst, vals + i);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (i + m < n_vals) dst[m] = vals[i + m];
      }
    }
    const int rows0 = (int)(r1 - r0 < kRowChunk ? r1 - r0 : kRowChunk);
    for (int i = t; i <= rows0; i += kThreads)
      cp_async4(s_off + b * kOffBuf + i, offsets + r0 + i);
    return r1 < n_seg ? (int64_t)offsets[r1] : ts + kTile;
  };

  // Block b takes tiles b, b + G, b + 2G, ... of a grid of G blocks.  While
  // it works on one, the next one's values and offsets are on their way
  // into the other buffer and the row bounds of the one after are being
  // read, so that no tile starts with a chain of dependent loads.
  const int64_t stride = gridDim.x;
  int64_t tile = blockIdx.x, next = tile + stride;
  int64_t r0 = 0, r1 = 0, r0n = 0, r1n = 0, open_at = 0;
  if (tile < n_tiles) {
    r0 = tile_rows[tile];
    r1 = tile_rows[tile + 1];
    open_at = request(tile, r0, r1, 0);
  }
  cp_async_commit();
  if (next < n_tiles) {
    r0n = tile_rows[next];
    r1n = tile_rows[next + 1];
  }
  // The cut first row of a tile waits for its carry until the block has done
  // its next tile: by then the tiles before it have published, and their
  // status words, read at that tile's start, have long arrived.
  int64_t cut_tile = -1, cut_row = 0;
  for (unsigned k = 0; tile < n_tiles; ++k) {
    const int b = k & 1;
    const int64_t after = next + stride;
    int64_t r0a = 0, r1a = 0, open_n = 0;
    if (after < n_tiles) {
      r0a = tile_rows[after];
      r1a = tile_rows[after + 1];
    }
    if (next < n_tiles) open_n = request(next, r0n, r1n, b ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                          // this tile's requests
    __syncthreads();

    const int64_t ts = tile * kTile;             // the tile's slots: [ts, te)
    const S* const v_tile = s_vals + b * kTile;
    int32_t* const off = s_off + b * kOffBuf;
    const int base = kPer * t;
    // the slots of no row ([lo, hi) holds the rest) count as the identity
    const bool edge = ts + base < lo || ts + base + kPer > hi;
    // the gather form: my slots' flags, on their way through the row pass
    uint32_t flag[kGather ? kPer : 1];
    if (kGather) {
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(v_tile + 4 * phys_vec(t, m));
        const uint32_t id[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t i = ts + base + 4 * m + q;
          const uint32_t g = id[q] >> nt.shift;
          const bool maybe = !(edge && (i < lo || i >= hi)) &&
                             ((s_sum[g >> 5] >> (g & 31)) & 1u);
          // the flag itself where the summary's bit stands for more nodes
          flag[4 * m + q] =
              maybe && nt.shift ? (uint32_t)__ldcg(nt.mask + id[q])
                                : (uint32_t)maybe;
        }
      }
    }
    // the row cut by the tile's start (it ends here, so r0 < r1)
    const bool head = r0 < r1 && (int64_t)off[0] < ts;
    // few rows (the rule): their results meet in shared memory and leave
    // together, coalesced; else each goes to memory on its own
    const bool few = r1 - r0 <= kRowChunk;
    T* const dst = few ? s_out : out + r0;
    T cut_part = R::ident();
    uint64_t cut_word = 0;
    if (warp == 1 && cut_tile >= 0) {
      cut_part = s_head;
      if (cut_tile - 1 - lane >= 0)
        cut_word = gm::load_status(status + cut_tile - 1 - lane);
    }

    // 1. by rows: an empty row gets the identity; any other marks the slot
    //    where it ends
    for (int64_t c = r0; c < r1;) {
      const int rows = (int)(r1 - c < kRowChunk ? r1 - c : kRowChunk);
      if (c != r0) {                             // the first load was requested
        __syncthreads();                         // off is read by the last
        for (int i = t; i <= rows; i += kThreads) off[i] = offsets[c + i];
        __syncthreads();
      }
      if (!few && rows == kRowChunk && off[0] == off[rows]) {
        // 512 empty rows: if their run holds whole chunks, its first one is
        // chunk k - 1 or k, tile_rows_kernel wrote them, and the block
        // writes only the rows before them
        const int64_t k = (c + kRowChunk - 1) / kRowChunk;
        const int64_t e0 = k > 0 ? run_end[k - 1] : 0;
        const int64_t e = e0 > 0 ? e0 : run_end[k];
        if (e > 0) {
          if (e0 == 0)
            for (int64_t v = c + t; v < k * kRowChunk; v += kThreads)
              dst[v - r0] = R::ident();
          c = e < r1 ? e : r1;
          continue;
        }
      }
      for (int i = t; i < rows; i += kThreads) {
        const int a = (int)((int64_t)off[i] - ts);
        const int end = (int)((int64_t)off[i + 1] - ts) - 1;
        if (end < a) {
          dst[c - r0 + i] = R::ident();
        } else {
          atomicOr(&s_ends[end >> 5], 1u << (end & 31));
          s_row[end] = (int32_t)(c - r0 + i);
        }
      }
      c += rows;
    }
    __syncthreads();

    // 2. by slots: each thread walks its kPer consecutive slots in
    //    registers, writes the rows that start and end inside them, and
    //    keeps the part before the first end and the part after the last
    T x[kPer];
    if (kGather) {
      // the set sources' values and, where a vector of slots has one, its
      // weights, all requested before the first is used
      unsigned set = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) set |= (flag[j] != 0u ? 1u : 0u) << j;
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(v_tile + 4 * phys_vec(t, m));
        const uint32_t id[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[4 * m + q] =
              (set >> (4 * m + q)) & 1u ? __ldcg(nt.vals + id[q]) : R::ident();
      }
      T w[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) w[j] = (T)1;
      if (kAdd) {
        const T* const wp = nt.add + ts + base;
#pragma unroll
        for (int m = 0; m < kVecs; ++m) {
          if (!((set >> (4 * m)) & 0xfu)) continue;
          if (kVec && ts + base + 4 * m + 4 <= n_vals) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(wp + 4 * m));
            w[4 * m + 0] = gm::from_bits<T>(v.x);
            w[4 * m + 1] = gm::from_bits<T>(v.y);
            w[4 * m + 2] = gm::from_bits<T>(v.z);
            w[4 * m + 3] = gm::from_bits<T>(v.w);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if ((set >> (4 * m + q)) & 1u) w[4 * m + q] = __ldg(wp + 4 * m + q);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if ((set >> j) & 1u) x[j] = torch_add(x[j], w[j]);
    } else {
#pragma unroll
      for (int m = 0; m < kVecs; ++m) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(v_tile + 4 * phys_vec(t, m));
        x[4 * m + 0] = gm::from_bits<T>(v.x);
        x[4 * m + 1] = gm::from_bits<T>(v.y);
        x[4 * m + 2] = gm::from_bits<T>(v.z);
        x[4 * m + 3] = gm::from_bits<T>(v.w);
      }
      if (edge) {                                // slots of no row
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (ts + base + j < lo || ts + base + j >= hi) x[j] = R::ident();
      }
    }
    const unsigned ends = (s_ends[base >> 5] >> (base & 31)) &
                          (kPer == 32 ? ~0u : (1u << kPer) - 1u);
    int f = 0;                     // a row ended among my slots
    T first = R::ident();          // my slots up to the first end
    int first_row = 0;
    T acc = R::ident();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      acc = R::apply(acc, x[j]);
      if ((ends >> j) & 1) {
        const int32_t row = s_row[base + j];
        if (f) {
          dst[row] = acc;
        } else {
          first = acc;
          first_row = row;
          f = 1;
        }
        acc = R::ident();
      }
    }

    // exclusive scan of the threads' (f, acc) pairs over the block
    int wf = f;
    T wv = acc;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int yf = __shfl_up_sync(kFull, wf, s);
      const T yv = __shfl_up_sync(kFull, wv, s);
      if (lane >= s) combine<R>(yf, yv, wf, wv);
    }
    if (lane == 31) {
      s_wf[warp] = wf;
      s_wv[warp] = wv;
    }
    int ef = __shfl_up_sync(kFull, wf, 1);
    T ev = __shfl_up_sync(kFull, wv, 1);
    if (lane == 0) {
      ef = 0;
      ev = R::ident();
    }
    __syncthreads();
    if (t < kTile / 32) s_ends[t] = 0;           // for the next tile
    int pf = 0;
    T pv = R::ident();
    for (int w = 0; w < (t == 0 ? kWarps : warp); ++w) {
      int nf = s_wf[w];
      T nv = s_wv[w];
      combine<R>(pf, pv, nf, nv);
      pf = nf;
      pv = nv;
    }
    if (t == 0) {
      // the whole tile's pair: what follows the last end is the open row's
      // part.  State 2 if that row starts in this tile (or none is open),
      // state 1 if the tile lies wholly inside it.
      gm::store_status(status + tile,
                       (open_at < ts ? gm::kState1 : gm::kState2) |
                           gm::to_bits(pv));
      pf = 0;
      pv = R::ident();
    }
    combine<R>(pf, pv, ef, ev);    // (ef, ev): everything before my slots
    if (f) {
      const T whole = R::apply(ev, first);
      if (ef || !head) dst[first_row] = whole;
      else s_head = whole;         // the tile's first end, of the cut row
    }
    if (few) {
      __syncthreads();
      const int rows = (int)(r1 - r0);
      for (int i = t + (head ? 1 : 0); i < rows; i += kThreads)
        out[r0 + i] = s_out[i];
    }
    if (warp == 1 && cut_tile >= 0) {
      const T carry = gm::look_back<R>(status, cut_tile, lane, cut_word);
      if (lane == 0) out[cut_row] = R::apply(carry, cut_part);
    }
    cut_tile = head ? tile : -1;
    cut_row = r0;
    tile = next;
    r0 = r0n;
    r1 = r1n;
    open_at = open_n;
    next = after;
    r0n = r0a;
    r1n = r1a;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 1 && cut_tile >= 0) {
    const T carry = gm::look_back<R>(status, cut_tile, lane);
    if (lane == 0) out[cut_row] = R::apply(carry, s_head);
  }
}

// ---------------------------------------------------------------------------
// Lanes: vals [B, n_vals] and out [B, n_out] with one offsets array for all
// of them (the JAX package's `vmap` over the TPU kernel, which adds a grid
// axis over the lanes).  Bound on an H100: device-memory bandwidth, B x
// (4 bytes a value and 4 a result) and the offsets once: 4,742 MB at
// [16, E_pad] of the LiveJournal-scale graph, 1.416 ms at 3.35 TB/s.  The
// one-row tile kernel over (lane, tile) work items, lane-major, redid the
// row pass of every tile for every lane and spilled at its register cap:
// 3.26 ms.  So a kernel of its own, tile-major with the lanes inside: a
// block takes a tile, goes over its rows once, and then reduces the tile's
// slots for every lane in turn.
//   - What does not depend on the lane is found once a tile: the row pass
//     (row-end bits, row numbers, empty rows, the jumps over runs of empty
//     chunks), and each thread's row-end mask and slot mask, kept in
//     registers.  For each lane only the values come in again.
//   - The values stream into a ring of kStages shared-memory stages, one
//     lane's tile (16 KB) a stage, by the Tensor Memory Accelerator's 1-D
//     bulk copy with an mbarrier a stage.  Thread 0 starts the copy of work
//     item k + kStages as soon as every thread has taken item k's values
//     into registers, so the next lanes' bytes arrive while the current
//     lane is walked and scanned.  A stage lies as in memory; a thread reads
//     its four 16-byte vectors rotated by (t / 2) % 4, so eight neighbouring
//     threads hit eight distinct bank groups, and puts them back in order in
//     registers.  Values that are not 16-byte aligned, or rows whose length
//     is not a multiple of 4, take 4-byte loads straight into registers.
//   - The slot walk, the block scan and the cut-row look-back are the 1-D
//     kernel's, with the same tile, slot split, scan tree and order, so
//     each lane gets the bits of the 1-D launch on its row.  Each (lane,
//     tile) has its status word; a look-back never leaves its lane.  The
//     part of a lane's cut first row waits in out itself, and the row is
//     finished while the block walks the same lane of its next tile.
//   - Blocks are split into lane groups when the tiles are fewer than the
//     blocks the card holds: group g takes a contiguous share of the lanes.
// A block waits only for lower tiles of the same lane, and the grid is
// cooperative, so the lowest unfinished tile of a lane never waits.
//
// One barrier a lane: a lane's results of a tile of few rows leave shared
// memory after the next lane's barrier, so they take one of three buffers
// in turn, and the warps' totals one of two.
//
// Shared memory of one block: kStages stages of values, the row numbers,
// one load of offsets, kOutBufs buffers of the rows' results, the row-end
// bits: 73 KB at kStages = 3, so three blocks an SM (228 KB), and 80
// registers a thread.  Measured on an NVIDIA H100 80GB HBM3 at 700 W at
// the LiveJournal-scale pull shape, float32 add at [16, E_pad] (PERF.md):
// 3 blocks of 3 stages 1.94-1.95 ms; with two barriers a lane and the cut
// row's part read back from out at its look-back 2.20; the same with 4
// blocks of 2 stages (64 registers, 40-52 bytes spilled) 2.06, with the
// part read ahead 1.99-2.00; 2 blocks of 5 stages 2.81; without the
// look-back (wrong results) 1.90.  `nvcc -Xptxas -v` at 80 registers: the
// bulk-copy forms of float32 add and int32 min/max spill 12 bytes, the
// 4-byte-load forms of float32 4-16; a form that spilled 0-16 bytes (the
// last lane's results out after one more barrier a tile, the slot bounds
// in 32 bits) took 1.98 against this one's 1.93-1.94 in turns.
constexpr int kLaneBlocksPerSM = 3;
constexpr int kStages = 3;
constexpr int kOutBufs = 3;
constexpr size_t kLaneSmemBytes =
    (size_t)(kStages * kTile + kTile + kOffBuf + kOutBufs * kRowChunk +
             kTile / 32) *
    4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, from and to 16-byte aligned addresses) from
// global to shared memory by the TMA; completes on the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T, int OP, bool kTma>
__global__ void __launch_bounds__(kThreads, kLaneBlocksPerSM)
segment_reduce_lanes_kernel(const T* __restrict__ vals, int64_t n_vals,
                            const int32_t* __restrict__ offsets,
                            int64_t n_seg, int64_t n_out, T* __restrict__ out,
                            uint64_t* __restrict__ status,
                            const int64_t* __restrict__ tile_rows,
                            const int64_t* __restrict__ run_end,
                            int64_t n_tiles, int64_t n_lanes,
                            int64_t lanes_per_group) {
  typedef Red<T, OP> R;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const s_ring = reinterpret_cast<T*>(smem);  // [kStages][kTile]
  // s_row[k]: the row that ends at slot k, counted from the tile's first row
  int32_t* const s_row = reinterpret_cast<int32_t*>(s_ring + kStages * kTile);
  int32_t* const s_off = s_row + kTile;                      // [kOffBuf]
  T* const s_out = reinterpret_cast<T*>(s_off + kOffBuf);    // [kOutBufs][kRowChunk]
  unsigned* const s_ends =
      reinterpret_cast<unsigned*>(s_out + kOutBufs * kRowChunk);
  __shared__ __align__(8) uint64_t s_full[kStages];
  // the warps' totals, two sets: a lane's are read while the next lane's
  // are written
  __shared__ int s_wf[2][kWarps];
  __shared__ T s_wv[2][kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // rows n_seg..n_out-1 of every lane: the identity, shared out over the
  // blocks
  const int64_t pad = n_out - n_seg;
  for (int64_t k = (int64_t)blockIdx.x * kThreads + t; k < pad * n_lanes;
       k += (int64_t)gridDim.x * kThreads)
    out[k / pad * n_out + n_seg + k % pad] = R::ident();

  // the block's lanes [l0, l1) and tiles first, first + stride, ...
  const int64_t n_groups = (n_lanes + lanes_per_group - 1) / lanes_per_group;
  const int64_t stride = gridDim.x / n_groups;
  const int64_t group = blockIdx.x / stride;
  const int64_t first = blockIdx.x % stride;
  const int64_t l0 = group * lanes_per_group;
  const int64_t l1 = l0 + lanes_per_group < n_lanes ? l0 + lanes_per_group
                                                    : n_lanes;
  const int64_t nl = group < n_groups && l0 < l1 ? l1 - l0 : 0;
  const int64_t my_tiles =
      nl > 0 && first < n_tiles ? (n_tiles - 1 - first) / stride + 1 : 0;
  // work item k: lane l0 + k % nl of the block's tile k / nl
  const int64_t n_items = my_tiles * nl;

  // Thread 0 starts the copy of work item k into stage k % kStages.
  auto start_copy = [&](int64_t k) {
    const int64_t ts = (first + k / nl * stride) * kTile;
    const int64_t l = l0 + k % nl;
    const int s = (int)(k % kStages);
    const int64_t n = n_vals - ts < kTile ? n_vals - ts : kTile;
    const unsigned bytes = n > 0 ? (unsigned)(n * sizeof(T)) : 0u;
    mbar_expect_tx(&s_full[s], bytes);
    if (bytes) bulk_copy(s_ring + s * kTile, vals + l * n_vals + ts, bytes,
                         &s_full[s]);
  };
  if (kTma && t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < kTile / 32) s_ends[t] = 0;
  __syncthreads();
  if (kTma && t == 0)
    for (int64_t k = 0; k < kStages && k < n_items; ++k) start_copy(k);

  // the slots that belong to any row at all: [lo, hi)
  const int64_t lo = offsets[0];
  const int64_t hi = offsets[n_seg];
  const int base = kPer * t;
  const int rot = (t >> 1) & (kVecs - 1);

  // A lane's results of a tile of few rows leave shared memory after the
  // next lane's barrier (or the next tile's first one): the rows [r0, r0 +
  // out_rows) of lane out_lane from stage out_buf, the cut first row left
  // out.
  int64_t out_lane = -1, out_r0 = 0;
  int out_rows = 0, out_buf = 0, out_from = 0;
  auto copy_out = [&]() {
    if (out_lane >= 0) {
      const T* const src = s_out + out_buf * kRowChunk;
      T* const o = out + out_lane * n_out + out_r0;
      for (int i = t + out_from; i < out_rows; i += kThreads) o[i] = src[i];
      out_lane = -1;
    }
  };

  int64_t item = 0;
  // the cut first row of the block's last tile, finished lane by lane
  // while the block walks its next tile
  int64_t cut_tile = -1, cut_row = 0;
  for (int64_t tile = first; nl > 0 && tile < n_tiles; tile += stride) {
    const int64_t ts = tile * kTile;
    const int64_t r0 = tile_rows[tile];
    const int64_t r1 = tile_rows[tile + 1];
    // where the row still open at the tile's end starts
    const int64_t open_at = r1 < n_seg ? (int64_t)offsets[r1] : ts + kTile;
    const bool few = r1 - r0 <= kRowChunk;
    // the row cut by the tile's start (it ends here, so r0 < r1)
    const bool head = r0 < r1 && (int64_t)offsets[r0] < ts;
    __syncthreads();               // the last tile's s_row, s_off, s_out
    copy_out();                    // its last lane's results

    // 1. by rows, once for every lane: an empty row gets the identity; any
    //    other marks the slot where it ends
    for (int64_t c = r0; c < r1;) {
      const int rows = (int)(r1 - c < kRowChunk ? r1 - c : kRowChunk);
      if (c != r0) __syncthreads();              // s_off is read by the last
      for (int i = t; i <= rows; i += kThreads) s_off[i] = offsets[c + i];
      __syncthreads();
      if (!few && rows == kRowChunk && s_off[0] == s_off[rows]) {
        // 512 empty rows: as in the 1-D kernel, jump over the run's whole
        // chunks (tile_rows_kernel wrote them for every lane)
        const int64_t k = (c + kRowChunk - 1) / kRowChunk;
        const int64_t e0 = k > 0 ? run_end[k - 1] : 0;
        const int64_t e = e0 > 0 ? e0 : run_end[k];
        if (e > 0) {
          if (e0 == 0)
            for (int64_t l = l0; l < l1; ++l)
              for (int64_t v = c + t; v < k * kRowChunk; v += kThreads)
                out[l * n_out + v] = R::ident();
          c = e < r1 ? e : r1;
          continue;
        }
      }
      for (int i = t; i < rows; i += kThreads) {
        const int a = (int)((int64_t)s_off[i] - ts);
        const int end = (int)((int64_t)s_off[i + 1] - ts) - 1;
        if (end < a) {
          if (few) {
#pragma unroll
            for (int b = 0; b < kOutBufs; ++b)
              s_out[b * kRowChunk + c - r0 + i] = R::ident();
          } else {
            for (int64_t l = l0; l < l1; ++l)
              out[l * n_out + c + i] = R::ident();
          }
        } else {
          atomicOr(&s_ends[end >> 5], 1u << (end & 31));
          s_row[end] = (int32_t)(c - r0 + i);
        }
      }
      c += rows;
    }
    __syncthreads();
    // what each thread keeps for every lane: where its rows end, and
    // whether some of its slots lie outside every row
    const unsigned ends = (s_ends[base >> 5] >> (base & 31)) &
                          (kPer == 32 ? ~0u : (1u << kPer) - 1u);
    const bool edge = ts + base < lo || ts + base + kPer > hi;

    // 2. by lanes: the 1-D kernel's slot walk and scan on each lane's values
    int buf = 0;                   // the lane's stage of results
    for (int64_t l = l0; l < l1; ++l, ++item) {
      T* const out_l = out + l * n_out;
      uint64_t* const st_l = status + l * n_tiles;
      T* const dst = few ? s_out + buf * kRowChunk : out_l + r0;
      // warp 1 finishes the cut row of the block's last tile in this lane:
      // its part (left in out) and the status words before it, read now
      uint64_t cut_word = 0;
      T cut_part = R::ident();
      if (warp == 1 && cut_tile >= 0) {
        if (cut_tile - 1 - lane >= 0)
          cut_word = gm::load_status(st_l + cut_tile - 1 - lane);
        if (lane == 0) cut_part = out_l[cut_row];
      }
      T x[kPer];
      if (kTma) {
        const int s = (int)(item % kStages);
        mbar_wait(&s_full[s], (unsigned)(item / kStages) & 1u);
        const T* const v_tile = s_ring + s * kTile + base;
        uint4 v[kVecs];            // v[m]: vector (m + rot) % kVecs
#pragma unroll
        for (int m = 0; m < kVecs; ++m)
          v[m] = *reinterpret_cast<const uint4*>(
              v_tile + 4 * ((m + rot) & (kVecs - 1)));
#pragma unroll
        for (int r = 1; r < kVecs; r <<= 1) {
          if (rot & r) {           // rotate right by r
            uint4 w[kVecs];
#pragma unroll
            for (int m = 0; m < kVecs; ++m) w[m] = v[(m - r) & (kVecs - 1)];
#pragma unroll
            for (int m = 0; m < kVecs; ++m) v[m] = w[m];
          }
        }
#pragma unroll
        for (int m = 0; m < kVecs; ++m) {
          x[4 * m + 0] = gm::from_bits<T>(v[m].x);
          x[4 * m + 1] = gm::from_bits<T>(v[m].y);
          x[4 * m + 2] = gm::from_bits<T>(v[m].z);
          x[4 * m + 3] = gm::from_bits<T>(v[m].w);
        }
      } else {
        const T* const lv = vals + l * n_vals + ts + base;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          x[j] = ts + base + j < n_vals ? lv[j] : R::ident();
      }
      if (edge) {                  // slots of no row
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (ts + base + j < lo || ts + base + j >= hi) x[j] = R::ident();
      }
      int f = 0;                   // a row ended among my slots
      T first_part = R::ident();   // my slots up to the first end
      int first_row = 0;
      T acc = R::ident();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        acc = R::apply(acc, x[j]);
        if ((ends >> j) & 1) {
          const int32_t row = s_row[base + j];
          if (f) {
            dst[row] = acc;
          } else {
            first_part = acc;
            first_row = row;
            f = 1;
          }
          acc = R::ident();
        }
      }

      // exclusive scan of the threads' (f, acc) pairs over the block
      int wf = f;
      T wv = acc;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int yf = __shfl_up_sync(kFull, wf, s);
        const T yv = __shfl_up_sync(kFull, wv, s);
        if (lane >= s) combine<R>(yf, yv, wf, wv);
      }
      const int wb = (int)(l & 1);
      if (lane == 31) {
        s_wf[wb][warp] = wf;
        s_wv[wb][warp] = wv;
      }
      int ef = __shfl_up_sync(kFull, wf, 1);
      T ev = __shfl_up_sync(kFull, wv, 1);
      if (lane == 0) {
        ef = 0;
        ev = R::ident();
      }
      // every thread holds this item's values, and the last lane's
      // results are all in shared memory
      __syncthreads();
      copy_out();
      if (l == l0 && t < kTile / 32) s_ends[t] = 0;   // for the next tile
      int pf = 0;
      T pv = R::ident();
      for (int w = 0; w < (t == 0 ? kWarps : warp); ++w) {
        int nf = s_wf[wb][w];
        T nv = s_wv[wb][w];
        combine<R>(pf, pv, nf, nv);
        pf = nf;
        pv = nv;
      }
      if (t == 0) {
        if (kTma && item + kStages < n_items) {
          // the stage is free: its values are in registers
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          start_copy(item + kStages);
        }
        gm::store_status(st_l + tile,
                         (open_at < ts ? gm::kState1 : gm::kState2) |
                             gm::to_bits(pv));
        pf = 0;
        pv = R::ident();
      }
      combine<R>(pf, pv, ef, ev);  // (ef, ev): everything before my slots
      if (f) {
        const T whole = R::apply(ev, first_part);
        if (ef || !head) dst[first_row] = whole;
        else out_l[r0] = whole;    // the cut row's part, until its carry
      }
      if (few) {
        out_lane = l;
        out_r0 = r0;
        out_rows = (int)(r1 - r0);
        out_buf = buf;
        out_from = head ? 1 : 0;
        buf = buf + 1 < kOutBufs ? buf + 1 : 0;
      }
      if (warp == 1 && cut_tile >= 0) {
        const T carry = gm::look_back<R>(st_l, cut_tile, lane, cut_word);
        if (lane == 0) out_l[cut_row] = R::apply(carry, cut_part);
      }
    }
    cut_tile = head ? tile : -1;
    cut_row = r0;
  }
  __syncthreads();                 // the last results, the cut row's parts
  copy_out();
  if (cut_tile >= 0) {
    for (int64_t l = l0 + warp; l < l1; l += kWarps) {
      const T carry = gm::look_back<R>(status + l * n_tiles, cut_tile, lane);
      if (lane == 0)
        out[l * n_out + cut_row] = R::apply(carry, out[l * n_out + cut_row]);
    }
  }
}

// Blocks the card holds at once of `kernel` with `smem` bytes each.
cudaError_t resident_blocks(const void* kernel, size_t smem, int* resident) {
  if (*resident > 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || sms < 1) return cudaErrorLaunchOutOfResources;
  *resident = per_sm * sms;
  return cudaSuccess;
}

// A cooperative launch: the runtime starts the grid only when all of its
// blocks fit on the card together, or refuses it.  A block that waits for a
// tile's status word thus never waits for a block that is not running.
template <typename T, int OP, bool kVec, bool kGather = false,
          bool kAdd = false>
cudaError_t launch_tiles(
    const typename std::conditional<kGather, int32_t, T>::type* vals,
    int64_t n_vals, const int32_t* offsets, int64_t n_seg, int64_t n_out,
    T* out, uint64_t* status, const int64_t* rows, const int64_t* run_end,
    int64_t n_tiles, cudaStream_t stream, NodeTables<T> nt = {}) {
  auto kernel = segment_reduce_kernel<T, OP, kVec, kGather, kAdd>;
  const size_t smem = kGather ? kGatherSmemBytes : kSmemBytes;
  static int resident = 0;
  cudaError_t e = resident_blocks((const void*)kernel, smem, &resident);
  if (e != cudaSuccess) return e;
  const int64_t blocks = n_tiles < resident ? n_tiles : resident;
  void* args[] = {&vals,   &n_vals, &offsets, &n_seg,   &n_out,  &out,
                  &status, &rows,   &run_end, &n_tiles, &nt};
  return cudaLaunchCooperativeKernel((const void*)kernel,
                                     dim3((unsigned)blocks), dim3(kThreads),
                                     args, smem, stream);
}

template <typename T, int OP, bool kTma>
cudaError_t launch_lane_tiles(const T* vals, int64_t n_vals,
                              const int32_t* offsets, int64_t n_seg,
                              int64_t n_out, T* out, uint64_t* status,
                              const int64_t* rows, const int64_t* run_end,
                              int64_t n_tiles, int64_t n_lanes,
                              cudaStream_t stream) {
  auto kernel = segment_reduce_lanes_kernel<T, OP, kTma>;
  static int resident = 0;
  cudaError_t e =
      resident_blocks((const void*)kernel, kLaneSmemBytes, &resident);
  if (e != cudaSuccess) return e;
  // fewer tiles than the card holds blocks: the lanes split into groups
  int64_t groups = resident / n_tiles;
  groups = groups < 1 ? 1 : groups > n_lanes ? n_lanes : groups;
  int64_t per_group = (n_lanes + groups - 1) / groups;
  groups = (n_lanes + per_group - 1) / per_group;
  const int64_t tiles = n_tiles < resident / groups ? n_tiles
                                                    : resident / groups;
  const int64_t blocks = tiles * groups;
  void* args[] = {&vals,    &n_vals,  &offsets, &n_seg,
                  &n_out,   &out,     &status,  &rows,
                  &run_end, &n_tiles, &n_lanes, &per_group};
  return cudaLaunchCooperativeKernel((const void*)kernel,
                                     dim3((unsigned)blocks), dim3(kThreads),
                                     args, kLaneSmemBytes, stream);
}

// Clears the status words and launches the row bounds (tile_rows_kernel).
template <typename T, int OP>
cudaError_t row_bounds(int64_t n_lanes, const int32_t* offsets, int64_t n_seg,
                       int64_t n_out, void* out, void* scratch,
                       int64_t n_tiles, cudaStream_t stream) {
  uint64_t* status = (uint64_t*)scratch;
  int64_t* rows = (int64_t*)(status + n_lanes * n_tiles);
  int64_t* run_end = rows + n_tiles + 1;
  cudaError_t e =
      cudaMemsetAsync(scratch, 0, (size_t)(n_lanes * n_tiles) * 8, stream);
  if (e != cudaSuccess) return e;
  // a warp for each of the n_tiles + 1 row bounds, then one for 32 chunks
  const int64_t warps = n_tiles + 1 + (n_seg + 32 * kRowChunk - 1) /
                                          (32 * kRowChunk);
  tile_rows_kernel<T, OP><<<(unsigned)((warps + kWarps - 1) / kWarps),
                            kThreads, 0, stream>>>(offsets, n_seg, n_tiles,
                                                   rows, run_end, (T*)out,
                                                   n_out, n_lanes);
  return cudaGetLastError();
}

template <typename T, int OP>
int launch(const void* vals, int64_t n_lanes, int64_t n_vals,
           const int32_t* offsets, int64_t n_seg, int64_t n_out, void* out,
           void* scratch, int64_t n_tiles, cudaStream_t stream) {
  uint64_t* status = (uint64_t*)scratch;
  int64_t* rows = (int64_t*)(status + n_lanes * n_tiles);
  int64_t* run_end = rows + n_tiles + 1;
  cudaError_t e = row_bounds<T, OP>(n_lanes, offsets, n_seg, n_out, out,
                                    scratch, n_tiles, stream);
  if (e != cudaSuccess) return (int)e;
  // 16-byte loads and bulk copies need every lane's row aligned
  const bool vec =
      (uintptr_t)vals % 16 == 0 && (n_lanes == 1 || n_vals % 4 == 0);
  const T* v = (const T*)vals;
  T* o = (T*)out;
  if (n_lanes == 1)
    e = vec ? launch_tiles<T, OP, true>(v, n_vals, offsets, n_seg, n_out, o,
                                        status, rows, run_end, n_tiles,
                                        stream)
            : launch_tiles<T, OP, false>(v, n_vals, offsets, n_seg, n_out, o,
                                         status, rows, run_end, n_tiles,
                                         stream);
  else
    e = vec ? launch_lane_tiles<T, OP, true>(v, n_vals, offsets, n_seg, n_out,
                                             o, status, rows, run_end,
                                             n_tiles, n_lanes, stream)
            : launch_lane_tiles<T, OP, false>(v, n_vals, offsets, n_seg,
                                              n_out, o, status, rows, run_end,
                                              n_tiles, n_lanes, stream);
  return (int)e;
}

// The gather form, one row of slots: ids (and add) read with 16-byte loads,
// so both must be 16-byte aligned (the wrapper copies a view that is not).
template <typename T>
int launch_gather(const int32_t* ids, int64_t n_vals, const int32_t* offsets,
                  int64_t n_seg, int64_t n_out, void* out, void* scratch,
                  NodeTables<T> nt, int64_t n_nodes, int64_t n_tiles,
                  cudaStream_t stream) {
  constexpr int OP = gm::OP_MIN;
  uint64_t* status = (uint64_t*)scratch;
  int64_t* rows = (int64_t*)(status + n_tiles);
  int64_t* run_end = rows + n_tiles + 1;
  cudaError_t e = row_bounds<T, OP>(1, offsets, n_seg, n_out, out, scratch,
                                    n_tiles, stream);
  if (e != cudaSuccess) return (int)e;
  // the summary, after the row bounds in the scratch
  int shift = 0;
  while (((n_nodes - 1) >> shift) >= (int64_t)kSummaryWords * 32) ++shift;
  nt.shift = shift;
  nt.summary_words = n_nodes > 0 ? (((n_nodes - 1) >> shift) >> 5) + 1 : 0;
  uint32_t* summary = (uint32_t*)(run_end + (n_seg + kRowChunk - 1) / kRowChunk);
  nt.summary = summary;
  if (nt.summary_words > 0) {
    mask_summary_kernel<<<(unsigned)((nt.summary_words + kWarps - 1) / kWarps),
                          kThreads, 0, stream>>>(nt.mask, n_nodes, shift,
                                                 summary, nt.summary_words);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  T* o = (T*)out;
  e = nt.add ? launch_tiles<T, OP, true, true, true>(
                   ids, n_vals, offsets, n_seg, n_out, o, status, rows,
                   run_end, n_tiles, stream, nt)
             : launch_tiles<T, OP, true, true, false>(
                   ids, n_vals, offsets, n_seg, n_out, o, status, rows,
                   run_end, n_tiles, stream, nt);
  return (int)e;
}

}  // namespace

extern "C" {

// Edge slots per tile and rows per chunk: with T = max(1, ceil(n_vals /
// tile)) tiles, C = ceil(n_seg / chunk) chunks and B lanes the wrapper
// allocates B * T + T + 1 + C uint64 words of scratch (a status word per
// lane and tile, T + 1 row bounds and a run bound per chunk).
int gm_segment_reduce_tile_size(void) { return kTile; }
int gm_segment_reduce_row_chunk(void) { return kRowChunk; }

// dtype: 0 = int32, 1 = float32.  op: 0 = add, 1 = min, 2 = max.
// vals holds n_lanes rows of n_vals slots, one after another; offsets holds
// n_seg + 1 sorted entries within [0, n_vals], shared by the lanes; out
// holds n_lanes rows of n_out >= n_seg entries.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown dtype or op).
int gm_segment_reduce(const void* vals, int64_t n_lanes, int64_t n_vals,
                      const int32_t* offsets, int64_t n_seg, int64_t n_out,
                      void* out, void* scratch, int dtype, int op,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_out <= 0 || n_lanes <= 0) return (int)cudaGetLastError();
  const int64_t t = n_vals > 0 ? (n_vals + kTile - 1) / kTile : 1;
  const int64_t b = n_lanes;
  switch (dtype * 3 + op) {
    case 0: return launch<int32_t, gm::OP_ADD>(vals, b, n_vals, offsets, n_seg, n_out, out, scratch, t, s);
    case 1: return launch<int32_t, gm::OP_MIN>(vals, b, n_vals, offsets, n_seg, n_out, out, scratch, t, s);
    case 2: return launch<int32_t, gm::OP_MAX>(vals, b, n_vals, offsets, n_seg, n_out, out, scratch, t, s);
    case 3: return launch<float, gm::OP_ADD>(vals, b, n_vals, offsets, n_seg, n_out, out, scratch, t, s);
    case 4: return launch<float, gm::OP_MIN>(vals, b, n_vals, offsets, n_seg, n_out, out, scratch, t, s);
    case 5: return launch<float, gm::OP_MAX>(vals, b, n_vals, offsets, n_seg, n_out, out, scratch, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gather form's scratch beyond one lane's: uint64 words for the summary.
int gm_segment_reduce_gather_scratch(void) { return kSummaryWords / 2; }

// The gather form (min only, one row): ids holds each slot's node id;
// node_vals ([n_nodes], dtype 0 = int32, 1 = float32) and node_mask
// ([n_nodes] bytes, 0 = unset) are read at the ids of the slots in
// [offsets[0], offsets[n_seg]); add ([n_vals], node_vals' dtype) may be
// null for 1.  ids and add 16-byte aligned (else cudaErrorInvalidValue).
// Scratch: one lane's of gm_segment_reduce, then
// gm_segment_reduce_gather_scratch() words; out as gm_segment_reduce's.
int gm_segment_reduce_gather(const int32_t* ids, int64_t n_vals,
                             const int32_t* offsets, int64_t n_seg,
                             int64_t n_out, void* out, void* scratch,
                             const void* node_vals, const uint8_t* node_mask,
                             int64_t n_nodes, const void* add, int dtype,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_out <= 0) return (int)cudaGetLastError();
  if ((uintptr_t)ids % 16 != 0 || (uintptr_t)add % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t t = n_vals > 0 ? (n_vals + kTile - 1) / kTile : 1;
  switch (dtype) {
    case 0: return launch_gather<int32_t>(ids, n_vals, offsets, n_seg, n_out, out, scratch, {(const int32_t*)node_vals, node_mask, (const int32_t*)add, nullptr, 0, 0}, n_nodes, t, s);
    case 1: return launch_gather<float>(ids, n_vals, offsets, n_seg, n_out, out, scratch, {(const float*)node_vals, node_mask, (const float*)add, nullptr, 0, 0}, n_nodes, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
