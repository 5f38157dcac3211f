// The wedge search of triangle counting (models/triangle.py
// `count_search`): over the degree-ordered DAG in CSR form (`dag_begin`
// [N+1] int32 row offsets, `dag_dst` [D_pad] int32 rows sorted ascending,
// `pair_cum` [D_pad+1] int64 wedges anchored before each slot), the number
// of wedge ids k < num_wedges whose wedge (b, c) closes a triangle: anchor
// slot i is the last with pair_cum[i] <= k, b = dag_dst[i], c =
// dag_dst[i + 1 + k - pair_cum[i]], and the wedge hits where c is in row b.
// Ids from pair_cum[D_pad], the DAG's wedge total, are no wedges and count
// nothing.  The count is one exact int64.
//
// Replaces no TPU kernel: green_marl_tpu/models/triangle.py:764
// `_count_wedges` (the search) and :505 `_count_wedges_shift` (its d-shift
// probe) are plain XLA.  Eager PyTorch ran the same search as ~131 passes a
// chunk of 2^24 wedges (the searchsorted decode, then ~9 bisection steps of
// `where`, gathers, int64 adds, compares, `clamp` and shifts over [2^24]
// int64 temporaries, each 128 MB read or written): ~980 ms a call at the
// LiveJournal-scale DAG (1.41G wedges), all of it temporaries' traffic.
//
// Bounds on an H100 (probes/bounds.py `triangle_search`): the DAG once
// (row offsets and rows, 0.30 GB at that DAG, ~0.09 ms at 3.35 TB/s), and
// each wedge-anchoring slot's row b once (4 bytes a row entry, 8 bytes of
// row bounds a slot: 19.3 GB there, ~5.8 ms; rows met again in the L2
// cost less).  The work is ~9.4G dependent probes of rows of at most a few
// hundred entries at that DAG.  The design keeps every wedge's decode and
// bisection in registers and writes no per-wedge temporary:
//   - a warp claims tiles of kTile consecutive wedge ids from a counter
//     (persistent blocks; the C entry clears the counter and the count);
//   - a tile finds its first anchor slot by one 32-way warp search of
//     pair_cum (each round a lane probes one of 32 points: ~6 rounds at
//     69M slots), then walks the slots forward in windows: lane t holds
//     pair_cum of slot s + t, so the warp's 32 consecutive wedge ids
//     decode to their slot by five shuffles, with no global search;
//   - lane u tests wedge kw + u: b and c from the rows (lanes of one slot
//     read consecutive c), then a bisection of row b, ended by `lo < hi`
//     (any row length); lanes of one slot probe the same row, so their
//     probes meet in L1;
//   - hits are summed in registers, reduced by the warp and the block, and
//     added to the count with one 64-bit atomicAdd a block.
//
// Shapes tried on one NVIDIA H100 80GB HBM3 at 700.00 W (the cell's DAG:
// 68,955,915 slots, 1.41G wedges, 9,339,219 triangles; ms a call): this
// design at 48 warps an SM 16.5, at 64 (32 registers, no spills) 14.7,
// tiles of 2^10 wedges 16.8; two or four wedges a lane bisected in
// lockstep (more loads in flight, the slowest chain sets the round) 17.9
// and 16.0; a warp a row with row a hashed in shared memory and each
// anchor's row b streamed through it (the edge iterator: every row b read
// whole, coalesced) 16.6, its streaming alone 8.8, and 1.5 s on K_2400,
// whose row work is uneven.  Without the bisection (one probe a wedge)
// this design takes 4.7: the bisection's dependent probes hold the rest
// (the lanes of a slot probe one row, so most should meet in L1; not
// measured).
//
// Wedge ids and counts are int64 throughout (the complete graph K_2400
// has 2.3G wedges); slot positions are below 2^31, as a Graph's slots are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;          // 32 registers: 64 warps an SM
constexpr int kWarps = kThreads / 32;
// Wedge ids a warp claims at once; tests/test_torch_cuda.py `SEARCH_TILE`
// holds the same number for its wedge counts that are not a multiple.
constexpr int64_t kTile = 1 << 12;
constexpr unsigned kFull = 0xffffffffu;

// The last i < n with cum[i] <= k, cum ascending and cum[0] <= k: a 32-way
// search by the whole warp (each round a lane probes one of 32 points).
__device__ __forceinline__ int64_t last_at_most(const int64_t* __restrict__ cum,
                                                int64_t n, int64_t k,
                                                int lane) {
  int64_t lo = 0, len = n;
  while (len > 1) {
    const int64_t step = (len + 31) / 32;
    const int64_t off = (int64_t)lane * step;
    const bool ok = off < len && __ldg(cum + lo + off) <= k;
    const int t = 31 - __clz((int)__ballot_sync(kFull, ok));
    lo += t * step;
    len = len - t * step < step ? len - t * step : step;
  }
  return lo;
}

// Is c in the ascending run dag_dst[lo, hi)?
__device__ __forceinline__ bool row_has(const int32_t* __restrict__ dag_dst,
                                        int32_t lo, int32_t hi, int32_t c) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    const int32_t v = __ldg(dag_dst + mid);
    if (v == c) return true;
    if (v < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
triangle_search_kernel(const int32_t* __restrict__ dag_begin,
                       const int32_t* __restrict__ dag_dst, int64_t d_pad,
                       const int64_t* __restrict__ pair_cum,
                       int64_t num_wedges,
                       unsigned long long* __restrict__ count,
                       unsigned long long* __restrict__ tiles) {
  __shared__ unsigned long long s_hits[kWarps];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  // past the DAG's total no slot decodes a wedge, and the window walk
  // below would never reach its end
  const int64_t total = __ldg(pair_cum + d_pad);
  if (num_wedges > total) num_wedges = total;
  unsigned long long hits = 0;
  for (;;) {
    unsigned long long tile = 0;
    if (lane == 0) tile = atomicAdd(tiles, 1ull);
    tile = __shfl_sync(kFull, tile, 0);
    const int64_t k0 = (int64_t)tile * kTile;
    if (k0 >= num_wedges) break;
    const int64_t k1 = k0 + kTile < num_wedges ? k0 + kTile : num_wedges;
    int64_t s = last_at_most(pair_cum, d_pad + 1, k0, lane);
    int64_t kw = k0;
    while (kw < k1) {
      const int64_t at = s + lane < d_pad ? s + lane : d_pad;
      const int64_t p = __ldg(pair_cum + at);
      const int64_t p32 = __ldg(pair_cum + (s + 32 < d_pad ? s + 32 : d_pad));
      const int64_t kend = k1 < p32 ? k1 : p32;
      const int64_t k = kw + lane;
      int t = 0;
      int64_t pt = __shfl_sync(kFull, p, 0);
#pragma unroll
      for (int step = 16; step >= 1; step >>= 1) {
        const int64_t v = __shfl_sync(kFull, p, t + step);
        if (v <= k) {
          t += step;
          pt = v;
        }
      }
      if (k < kend) {
        const int64_t slot = s + t;
        const int32_t b = __ldg(dag_dst + slot);
        const int32_t c = __ldg(dag_dst + slot + 1 + (k - pt));
        hits += row_has(dag_dst, __ldg(dag_begin + b), __ldg(dag_begin + b + 1),
                        c);
      }
      if (kend > kw) kw = kend < kw + 32 ? kend : kw + 32;
      if (p32 <= kw) {
        s += 32;
      } else {
        s += 31 - __clz((int)__ballot_sync(kFull, p <= kw));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    hits += __shfl_down_sync(kFull, hits, off);
  if (lane == 0) s_hits[wib] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_hits[w];
    if (sum) atomicAdd(count, sum);
  }
}

}  // namespace

extern "C" {

// out[0] = the wedges k < num_wedges of the DAG (dag_begin [n+1] int32,
// dag_dst [d_pad] int32, pair_cum [d_pad+1] int64) that close a triangle;
// out[1] is the kernel's tile counter.  `out` is [2] int64, cleared here.
// One memset and one launch; returns the first CUDA error.
int gm_triangle_search(const void* dag_begin, const void* dag_dst,
                       int64_t d_pad, const void* pair_cum,
                       int64_t num_wedges, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d_pad < 1 || num_wedges < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, 2 * sizeof(int64_t), s);
  if (e != cudaSuccess || num_wedges == 0) return (int)e;
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, triangle_search_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1 || sms < 1) return (int)cudaErrorLaunchOutOfResources;
    resident = per_sm * sms;
  }
  const int64_t warps = (num_wedges + kTile - 1) / kTile;
  const int64_t want = (warps + kWarps - 1) / kWarps;
  const int blocks = (int)(want < resident ? want : resident);
  unsigned long long* o = (unsigned long long*)out;
  triangle_search_kernel<<<blocks, kThreads, 0, s>>>(
      (const int32_t*)dag_begin, (const int32_t*)dag_dst, d_pad,
      (const int64_t*)pair_cum, num_wedges, o, o + 1);
  return (int)cudaGetLastError();
}

}  // extern "C"
