// The binned edge map's bitwise OR (ops/binned.py `edge_map`, op "bor"):
// out[v] = OR of table[slot_src[s]] over the slots s of binned row v.
//
// Replaces no TPU kernel: the JAX package leaves `edge_map` to XLA, which
// fuses the row gather into the reduction.  Eager PyTorch does not: it
// wrote every gathered row (512 bytes a slot for 4,096 bit-BFS instances,
// ~76M slots a level at the LiveJournal-scale graph, ~39 GB) and read it
// back in log2(W) strided OR passes, and the hubs' second stage added ~160
// launches a level.  Here one launch reads each slot's row once into
// registers and writes each output row once.
//
// Bound on an H100: device-memory bandwidth.  The least a call moves is the
// slot ids and the table once and the output once; the rows are re-read
// once per slot whose source they are (~15 slots a row at that graph), so
// random 16-byte row pieces from HBM or L2 are what the time goes to.  The
// design keeps many of them in flight:
//   - rows are bytes: a row of `row_bytes` (16 to 512, a multiple of 16) is
//     row_bytes / 16 `uint4` pieces, and a subgroup of P lanes (the next
//     power of two) owns a row, one piece a lane.  OR does not care about
//     the element type, so the uint8, int16 and int32 planes share it;
//   - a subgroup walks a run of consecutive slots (the rows of a bin are
//     consecutive runs of `width` slots): it loads 32 slot ids at a time,
//     coalesced and streamed past L1, hands them round with `__shfl_sync`,
//     keeps kUnroll row loads in flight per lane through the read-only path,
//     ORs them into one `uint4` and stores it where a row's run ends;
//   - blocks are persistent and take items from an atomic counter, widest
//     first, since bins differ in width 4096-fold: a hub chunk (`w_max`
//     slots), a row of a wide bin (at least 32 slots a subgroup), or a tile
//     of kSubSlots slots a subgroup of a narrow bin.  A block splits a hub
//     chunk or a wide row over its subgroups and ORs their parts in shared
//     memory; a hub chunk then ORs its part into the hub's row with
//     `atomicOr` (OR is order-free, so the bits equal the plain path's);
//   - the host fills the launch's bin table (widest first, in kernel
//     parameters), zeroes the item counter and the rows from the hubs' first
//     to the last (hub rows take `atomicOr`; pad and identity rows hold 0,
//     the identity), and allocates nothing.
//
// The level form (`gm_edge_map_bor_level`) is a whole level of the bit BFS
// (models/batched.py `multi_source_bfs_bits`): where a node row's OR `r` is
// final it reads that row of `visited`, stores `n = r & ~visited` to `out`
// as the next frontier, stores `visited | n` back where `n != 0`, and counts
// the rows whose `n` is nonzero into a device word (one atomic a warp at
// its exit), which is the loop's predicate.  Torch took six plane-wide
// passes a level for that (`~`, `&`, `where`, `|`, `!= 0`, `any`, ~10 ms
// at 512-byte rows), each near its own bytes' bound; here the update costs
// a read of `visited` and a conditional write beside the gathered rows.  A
// lane reads its piece of a `visited` row only where its piece of the OR
// has a bit (elsewhere the next frontier is 0 whatever `visited` holds),
// when the row is final: most rows of a sparse level read nothing.  Hub
// rows are final only after their last chunk's `atomicOr`: a second, small
// launch (a warp a hub row) updates them.  The gather reads only the
// frontier, and `visited` is read and written only at the row being
// stored, so the two must not share storage (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Shapes tried on one NVIDIA H100 80GB HBM3 at 700.00 W
// (`scripts/probe_edge_map.py`: the 11 levels of one 4,096-source batch on
// the LiveJournal-scale graph, 512-byte rows; ms a call): 8 loads in
// flight 127.3 (11.5-11.6 a level whatever the frontier; 109% of the bound
// of the gathered rows, 13.6% of the table once); kept, 4 loads 126.5;
// at most 3 blocks an SM (80 registers) 127.4; 4 blocks and 4 loads 126.5;
// row loads past L1 (`ld.global.nc.L1::no_allocate`) 137.4; 1,024 slots a
// subgroup's tile 127.9.  The random row reads bound it, not the shape.
// The level form, the same batch (ms a call; the edge map alone 122.0 in
// the same runs): kept, `visited` read at the row end where the OR has a
// bit, 133.9 (11.5 a sparse level, 12.9 a dense one); 8 loads in flight
// 135.2, and with at most 3 blocks an SM 135.2; that read deferred to the
// next row end 133.8; `visited` read for every row beside the window's row
// loads 154.8 (13.7 a level where hardly a row has a bit), with 8 loads
// 160.9-170.6; no `visited` read at all (wrong results, timing only)
// 127.2.  The hub rows' launch takes ~1.6 us, so a countdown that updates
// each hub in its last chunk's block could gain no more than that and the
// launch gap; it was not tried.
constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // row loads in flight per lane
constexpr int kSubSlots = 256;   // slots a subgroup takes in a narrow tile
constexpr int kMaxBins = 96;     // the width ladder of any int32 w_max: 95

struct BinEntry {                // 32 bytes
  int64_t slot_off;              // the bin's first slot
  int32_t width, rows, row_off;
  int32_t per_sub;               // rows a subgroup takes; 0: a wide bin
  uint32_t first_item;
  int32_t pad;
};

struct Plan {
  int32_t n_bins;
  uint32_t n_items, hub_items;
  int32_t w_max;
  int64_t hub_slot_off, hub_row_off;
  BinEntry bins[kMaxBins];       // widest first
};
static_assert(sizeof(Plan) <= 4096, "kernel parameters");
static_assert(kMaxBins <= kThreads, "a thread tests one bin");

__device__ __forceinline__ void or_into(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

// The level form's row store of piece `at` of a final row `r`: the next
// frontier `n = r & ~v` (v: that piece of `visited`, read only where `r`
// has a bit), `visited` there ORed with `n` where `n` has a bit, and `rows`
// counting the row once (lane `lead` of the `mask` lanes that hold it) if
// any of its pieces has.  Every lane of `mask` calls it.
__device__ __forceinline__ void level_store(uint4* __restrict__ out,
                                            uint4* __restrict__ visited,
                                            int64_t at, const uint4& r,
                                            bool act, unsigned mask,
                                            bool lead, unsigned& rows) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 v = act && (r.x | r.y | r.z | r.w) != 0u
                      ? __ldcs(visited + at) : zero;
  const uint4 n = make_uint4(r.x & ~v.x, r.y & ~v.y, r.z & ~v.z, r.w & ~v.w);
  const bool set = act && (n.x | n.y | n.z | n.w) != 0u;
  if (act) __stcs(out + at, n);
  if (set) __stcs(visited + at, make_uint4(v.x | n.x, v.y | n.y, v.z | n.z,
                                           v.w | n.w));
  if (__any_sync(mask, set) && lead) ++rows;
}

// The lanes of this lane's subgroup of P (a power of two) in its warp.
template <int P>
__device__ __forceinline__ unsigned sub_mask() {
  if constexpr (P == 32) {
    return 0xffffffffu;
  } else {
    const unsigned first = (threadIdx.x % 32) & ~(unsigned)(P - 1);
    return ((1u << P) - 1u) << first;
  }
}

// The OR of the table rows at slots [s0, s0 + n) by a subgroup of P lanes,
// lane `sl` holding piece `sl` of a row of `g` pieces.  kRows: the run is
// whole rows of `width` slots, from binned row `row` on, each stored to
// `out` where it ends (the result is then 0); else the run's OR is
// returned.  kLevel (with kRows): each row is stored by `level_store`.
// Every lane of the warp calls it (the ids go round by shuffles).
template <int P, bool kRows, bool kLevel>
__device__ __forceinline__ uint4 walk(const uint4* __restrict__ table, int g,
                                      const int32_t* __restrict__ slot_src,
                                      int64_t s0, int n, int width,
                                      int64_t row, uint4* __restrict__ out,
                                      uint4* __restrict__ visited,
                                      unsigned& rows, int sl) {
  constexpr int Q = 32 / P;      // ids a lane loads of a window of 32
  static_assert(!kLevel || kRows, "the level form stores whole rows");
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const bool act = sl < g;
  const unsigned mask = sub_mask<P>();
  uint4 acc = zero;
  int rem = width;
  const int windows = (int)__reduce_max_sync(0xffffffffu,
                                             (unsigned)((n + 31) / 32));
  int ids[Q], next[Q];           // this window's ids and the next one's
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int t = sl + P * q;
    next[q] = t < n ? __ldcs(slot_src + s0 + t) : 0;
  }
  for (int w = 0; w < windows; ++w) {
    const int base = w * 32;
    const int cnt = n - base;    // slots of mine in the window, if > 0
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      ids[q] = next[q];
      const int t = base + 32 + sl + P * q;
      next[q] = t < n ? __ldcs(slot_src + s0 + t) : 0;
    }
    const int most = (int)__reduce_max_sync(0xffffffffu,
                                            (unsigned)(cnt > 0 ? cnt : 0));
#pragma unroll
    for (int b = 0; b < 32; b += kUnroll) {
      if (b >= most) break;
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = b + u;
        const int id = __shfl_sync(0xffffffffu, ids[t / P], t % P, P);
        v[u] = act && t < cnt ? __ldg(table + (int64_t)id * g + sl) : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        or_into(acc, v[u]);
        if (kRows && b + u < cnt && --rem == 0) {
          if (kLevel)
            level_store(out, visited, row * g + sl, acc, act, mask, sl == 0,
                        rows);
          else if (act)
            __stcs(out + row * g + sl, acc);
          acc = zero;
          rem = width;
          ++row;
        }
      }
    }
  }
  return acc;
}

// The OR of every subgroup's `acc` in the block; lanes sl < P of warp 0 get
// piece sl of it.  Lane L of each warp holds piece L % P, so warp 0 ORs its
// lanes' column of `s_acc` and then the lanes of one piece together.
template <int P>
__device__ __forceinline__ uint4 block_or(uint4 acc, uint4* s_acc) {
  s_acc[threadIdx.x] = acc;
  __syncthreads();
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x < 32) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w)
      or_into(r, s_acc[w * 32 + threadIdx.x]);
#pragma unroll
    for (int d = P; d < 32; d *= 2) {
      r.x |= __shfl_xor_sync(0xffffffffu, r.x, d);
      r.y |= __shfl_xor_sync(0xffffffffu, r.y, d);
      r.z |= __shfl_xor_sync(0xffffffffu, r.z, d);
      r.w |= __shfl_xor_sync(0xffffffffu, r.w, d);
    }
  }
  return r;
}

// kLevel: the level form (`visited`, and `counter[1]` counting the node
// rows of the next frontier that have a bit); the hub rows are left to
// `level_hubs_kernel`.
template <int P, bool kLevel>
__global__ void __launch_bounds__(kThreads)
edge_map_bor_kernel(const uint4* __restrict__ table, int g,
                    const int32_t* __restrict__ slot_src,
                    const int32_t* __restrict__ hub_owner,
                    uint4* __restrict__ out, uint4* __restrict__ visited,
                    unsigned* __restrict__ counter,
                    const __grid_constant__ Plan plan) {
  constexpr int kSubs = kThreads / P;
  __shared__ BinEntry s_bins[kMaxBins];
  __shared__ uint4 s_acc[kThreads];
  __shared__ unsigned s_item[2];   // two, so that thread 0 can take the
                                   // next while slow warps read this one
  const int tid = threadIdx.x;
  const int sub = tid / P, sl = tid % P;
  unsigned rows = 0;               // kLevel: rows this thread counted
  for (int i = tid; i < plan.n_bins; i += kThreads) s_bins[i] = plan.bins[i];
  for (int it = 0;; ++it) {
    if (tid == 0) s_item[it & 1] = atomicAdd(counter, 1u);
    __syncthreads();
    const unsigned item = s_item[it & 1];
    if (item >= plan.n_items) break;
    if (item < plan.hub_items) {   // a hub chunk: its part of the hub's row
      const int piece = (plan.w_max + kSubs - 1) / kSubs;
      const int lo = min(sub * piece, plan.w_max);
      const int hi = min(lo + piece, plan.w_max);
      const uint4 acc = walk<P, false, false>(
          table, g, slot_src,
          plan.hub_slot_off + (int64_t)item * plan.w_max + lo, hi - lo, 0,
          0, out, visited, rows, sl);
      const uint4 r = block_or<P>(acc, s_acc);
      if (tid < g) {
        unsigned* dst = reinterpret_cast<unsigned*>(
            out + (plan.hub_row_off + hub_owner[item]) * g + tid);
        if (r.x) atomicOr(dst, r.x);
        if (r.y) atomicOr(dst + 1, r.y);
        if (r.z) atomicOr(dst + 2, r.z);
        if (r.w) atomicOr(dst + 3, r.w);
      }
      continue;
    }
    const int k = __syncthreads_count(tid < plan.n_bins &&
                                      s_bins[tid].first_item <= item) - 1;
    const BinEntry bin = s_bins[k];
    const int j = (int)(item - bin.first_item);
    if (bin.per_sub == 0) {        // a wide row, split over the subgroups
      const int64_t row = bin.row_off + j;
      const int piece = (bin.width + kSubs - 1) / kSubs;
      const int lo = min(sub * piece, bin.width);
      const int hi = min(lo + piece, bin.width);
      const uint4 acc = walk<P, false, false>(
          table, g, slot_src, bin.slot_off + (int64_t)j * bin.width + lo,
          hi - lo, 0, 0, out, visited, rows, sl);
      const uint4 r = block_or<P>(acc, s_acc);
      if (kLevel) {
        if (tid < 32)
          level_store(out, visited, row * g + tid, r, tid < g, 0xffffffffu,
                      tid == 0, rows);
      } else if (tid < g) {
        __stcs(out + row * g + tid, r);
      }
    } else {                       // a tile of whole rows, per_sub a subgroup
      const int r0 = min(j * kSubs * bin.per_sub + sub * bin.per_sub,
                         bin.rows);
      const int r1 = min(r0 + bin.per_sub, bin.rows);
      walk<P, true, kLevel>(table, g, slot_src,
                            bin.slot_off + (int64_t)r0 * bin.width,
                            (r1 - r0) * bin.width, bin.width,
                            bin.row_off + r0, out, visited, rows, sl);
    }
  }
  if (kLevel) {                    // one atomic a warp
    rows = __reduce_add_sync(0xffffffffu, rows);
    if (tid % 32 == 0 && rows) atomicAdd(counter + 1, rows);
  }
}

// The level form's hub rows [row0, row0 + n_hub), once every chunk's
// `atomicOr` is in: a warp a row, lane L piece L.
__global__ void __launch_bounds__(kThreads)
level_hubs_kernel(uint4* __restrict__ out, uint4* __restrict__ visited,
                  int g, int64_t row0, int64_t n_hub,
                  unsigned* __restrict__ counter) {
  const int lane = threadIdx.x % 32;
  const int64_t h = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (h >= n_hub) return;          // a whole warp
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int64_t at = (row0 + h) * g + lane;
  const bool act = lane < g;
  const uint4 r = act ? __ldcg(out + at) : zero;
  unsigned rows = 0;
  level_store(out, visited, at, r, act, 0xffffffffu, lane == 0, rows);
  if (rows) atomicAdd(counter + 1, 1u);
}

template <int P, bool kLevel>
cudaError_t launch(const uint4* table, int g, const int32_t* slot_src,
                   const int64_t* bins, int n_bins, const int32_t* hub_owner,
                   int64_t n_hub_chunks, int64_t w_max, int64_t hub_slot_off,
                   int64_t hub_row_off, uint4* out, uint4* visited,
                   unsigned* counter, cudaStream_t s) {
  constexpr int kSubs = kThreads / P;
  Plan plan = {};
  plan.n_bins = n_bins;
  plan.hub_items = (uint32_t)n_hub_chunks;
  plan.w_max = (int32_t)w_max;
  plan.hub_slot_off = hub_slot_off;
  plan.hub_row_off = hub_row_off;
  int64_t items = n_hub_chunks;
  for (int i = 0; i < n_bins; ++i) {       // `bins` ascend by width
    const int64_t* b = bins + 4 * (n_bins - 1 - i);
    BinEntry& e = plan.bins[i];
    e.width = (int32_t)b[0];
    e.rows = (int32_t)b[1];
    e.slot_off = b[2];
    e.row_off = (int32_t)b[3];
    e.per_sub = e.width >= 32 * kSubs
                    ? 0 : (kSubSlots + e.width - 1) / e.width;
    e.first_item = (uint32_t)items;
    items += e.per_sub ? (e.rows + (int64_t)kSubs * e.per_sub - 1) /
                             ((int64_t)kSubs * e.per_sub)
                       : e.rows;
  }
  if (items >= (int64_t)UINT32_MAX) return cudaErrorInvalidValue;
  plan.n_items = (uint32_t)items;
  auto kernel = edge_map_bor_kernel<P, kLevel>;
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1 || sms < 1) return cudaErrorLaunchOutOfResources;
    resident = per_sm * sms;
  }
  const int64_t blocks = items < 1 ? 1 : items < resident ? items : resident;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(table, g, slot_src, hub_owner,
                                               out, visited, counter, plan);
  return cudaGetLastError();
}

// Both C entries: the checks, the memsets, the launch for the row width and,
// in the level form (`visited` not null), the hub rows' launch.
cudaError_t run(const void* table, int64_t n_rows, int row_bytes,
                const void* slot_src, const int64_t* bins, int n_bins,
                const void* hub_owner, int64_t n_hub_chunks, int64_t w_max,
                int64_t hub_slot_off, int64_t hub_row_off, int64_t n_nodes,
                void* visited, void* out, void* counter, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool level = visited != nullptr;
  if (row_bytes < 16 || row_bytes > 512 || row_bytes % 16 != 0 ||
      n_bins < 0 || n_bins > kMaxBins || hub_row_off < 0 ||
      hub_row_off > n_nodes || n_nodes > n_rows || n_rows > 0x7fffffff ||
      w_max < 1 || w_max > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(counter, 0,
                                  (level ? 2 : 1) * sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  if (n_rows > hub_row_off) {
    e = cudaMemsetAsync((char*)out + hub_row_off * row_bytes, 0,
                        (size_t)(n_rows - hub_row_off) * row_bytes, s);
    if (e != cudaSuccess) return e;
  }
  const int g = row_bytes / 16;
  const uint4* t = (const uint4*)table;
  const int32_t* src = (const int32_t*)slot_src;
  const int32_t* own = (const int32_t*)hub_owner;
  uint4* o = (uint4*)out;
  uint4* vis = (uint4*)visited;
  unsigned* c = (unsigned*)counter;
#define GM_EDGE_MAP_LAUNCH(P)                                               \
  (level ? launch<P, true>(t, g, src, bins, n_bins, own, n_hub_chunks, w_max, \
                           hub_slot_off, hub_row_off, o, vis, c, s)           \
         : launch<P, false>(t, g, src, bins, n_bins, own, n_hub_chunks,       \
                            w_max, hub_slot_off, hub_row_off, o, vis, c, s))
  e = g == 1    ? GM_EDGE_MAP_LAUNCH(1)
      : g == 2  ? GM_EDGE_MAP_LAUNCH(2)
      : g <= 4  ? GM_EDGE_MAP_LAUNCH(4)
      : g <= 8  ? GM_EDGE_MAP_LAUNCH(8)
      : g <= 16 ? GM_EDGE_MAP_LAUNCH(16)
                : GM_EDGE_MAP_LAUNCH(32);
#undef GM_EDGE_MAP_LAUNCH
  const int64_t n_hub = n_nodes - hub_row_off;
  if (e != cudaSuccess || !level || n_hub == 0) return e;
  constexpr int kWarps = kThreads / 32;
  level_hubs_kernel<<<(unsigned)((n_hub + kWarps - 1) / kWarps), kThreads, 0,
                      s>>>(o, vis, g, hub_row_off, n_hub, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[v] = OR of table rows slot_src[s] over binned row v's slots, for a
// table of n_rows rows of row_bytes (a multiple of 16, at most 512; table
// and out 16-byte aligned).  `bins`: n_bins (<= 96) rows of (width, count,
// slot_off, row_off), ascending by width, as `BinnedPull.bins`; hub chunk c
// (of n_hub_chunks) holds slots [hub_slot_off + c * w_max, + w_max) and is
// ORed into row hub_row_off + hub_owner[c].  Rows from hub_row_off to
// n_rows are zeroed first; `counter`: one word of scratch.  Two memsets and
// one launch; returns the first CUDA error.
int gm_edge_map_bor(const void* table, int64_t n_rows, int row_bytes,
                    const void* slot_src, const int64_t* bins, int n_bins,
                    const void* hub_owner, int64_t n_hub_chunks,
                    int64_t w_max, int64_t hub_slot_off, int64_t hub_row_off,
                    void* out, void* counter, void* stream) {
  return (int)run(table, n_rows, row_bytes, slot_src, bins, n_bins,
                  hub_owner, n_hub_chunks, w_max, hub_slot_off, hub_row_off,
                  n_rows, nullptr, out, counter, stream);
}

// A level of the bit BFS: with `table` the frontier, as gm_edge_map_bor,
// then on the node rows [0, n_nodes) (hubs from hub_row_off on)
// out = OR & ~visited and visited |= out, in place (`visited`: n_rows rows
// of row_bytes, 16-byte aligned, sharing no memory with `table`; rows from
// n_nodes on are neither read nor written), and counter[1] = the node rows
// of `out` with a bit set.  `counter`: two words.  Two memsets and one
// launch, and one more for the hub rows where there are any.
int gm_edge_map_bor_level(const void* table, int64_t n_rows, int row_bytes,
                          const void* slot_src, const int64_t* bins,
                          int n_bins, const void* hub_owner,
                          int64_t n_hub_chunks, int64_t w_max,
                          int64_t hub_slot_off, int64_t hub_row_off,
                          int64_t n_nodes, void* visited, void* out,
                          void* counter, void* stream) {
  if (visited == nullptr) return (int)cudaErrorInvalidValue;
  return (int)run(table, n_rows, row_bytes, slot_src, bins, n_bins,
                  hub_owner, n_hub_chunks, w_max, hub_slot_off, hub_row_off,
                  n_nodes, visited, out, counter, stream);
}

}  // extern "C"
