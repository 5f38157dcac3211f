// Inclusive or exclusive prefix sum of a 1-D int32 or float32 array.
//
// Replaces the TPU kernel `_cumsum_local_kernel`
// (green_marl_tpu/ops/pallas_kernels.py, reached through `plain_cumsum`),
// which computed chunk bases in XLA and the in-chunk prefix with 128x128 and
// 512x512 triangular float32 matmuls on the MXU.  That made integer sums
// exact only while a 65,536-element chunk summed below 2^24.  Here integers are added as uint32 throughout: the result is
// exact mod 2^32 for any input, with no 2^24 limit and no signed-overflow UB.
//
// Bound on an H100: device-memory bandwidth.  A scan must read each element
// once and write it once: 8 B per element, 552 MB at 69M elements, 0.165 ms
// at 3.35 TB/s.  The design is a single pass with decoupled look-back
// (Merrill and Garland, 2016), one launch:
//   - a block takes its tile number from an atomicAdd on a counter, so every
//     tile before it belongs to a block that has already started: a block
//     that waits on a predecessor never waits on one that was not scheduled;
//   - per tile of kTile elements, each thread loads kRounds 16-byte vectors
//     (round r of the block covers kThreads * 4 consecutive elements, so each
//     load is coalesced; streaming hints, as each byte is touched once),
//     scans its four elements of each round in registers,
//     each warp scans its thread totals with shuffles, and warp 0 combines
//     the kRounds * kWarps warp totals once per tile;
//   - each tile publishes one 64-bit status word: the state in the high half
//     (0 not ready, 1 aggregate, 2 inclusive prefix) and the value's 32 bits
//     in the low half, written and read whole, so flag and value never tear.
//     Warp 0 looks back over 32 predecessors at a time, adding aggregates
//     until it meets an inclusive prefix, then publishes its own.
// The status words and the counter are scratch the wrapper allocates and the
// C entry clears with one cudaMemsetAsync.  The exclusive form writes n + 1
// values, out[i] = sum(in[:i]), each at the index of its input element (and
// out[n] from the last tile), so its stores stay aligned like the input's.
// An input or output that is not 16-byte aligned (a view such as x[1:])
// takes the same kernel with 4-byte loads and stores.
//
// Lanes: one launch scans B rows at once, in [B, n] to out rows ld_out
// elements apart (the JAX package's `vmap` over the TPU kernel, which adds a
// grid axis over the lanes).  The tile counter runs over (lane, tile), lane
// by lane, with a status word each; a tile's look-back stops at its lane's
// first tile, which stands on an inclusive 0 as tile 0 does.  The exclusive
// form's rows of n + 1 values are laid out ld_out = n + 1 rounded up to a
// multiple of 4 apart by the wrapper, so that every row stays 16-byte
// aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

// Tile shape measured on an NVIDIA H100 80GB HBM3 at 700 W, 69M int32
// (PERF.md), threads x vectors per thread, with streaming hints: 128 x 16
// took 0.220 ms, 256 x 8 0.227 ms, 512 x 8 0.223 ms; 256 x 4 without the
// hints 0.260 ms.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                      // 16-byte vectors per thread
constexpr int kTile = kThreads * 4 * kRounds;    // 8,192 elements per tile
constexpr int kCombine = kRounds * kWarps;       // warp totals per tile
static_assert(kCombine % 32 == 0, "warp 0 combines kCombine / 32 per lane");
constexpr uint64_t kAggregate = gm::kState1;
constexpr uint64_t kInclusive = gm::kState2;
using gm::from_bits;
using gm::kFull;
using gm::load_status;
using gm::store_status;
using gm::to_bits;

template <typename T>
__device__ __forceinline__ T warp_inclusive(T x, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const T y = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x += y;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(kFull, x, s);
  return x;
}

// Warp 0 of tile `tile` > first: the sum of every element of its row
// before the tile, from the status words of its predecessors (the row's
// tiles start at status word `first`).
template <typename T>
__device__ T look_back(const uint64_t* status, int64_t tile, int64_t first,
                       int lane) {
  T prefix = T(0);
  for (int64_t end = tile - 1;; end -= 32) {
    const int64_t j = end - lane;            // lane 0: the nearest predecessor
    uint64_t w = kInclusive;                 // before the row: an inclusive 0
    if (j >= first) {
      do {
        w = load_status(status + j);
      } while ((w >> 32) == 0);
    }
    const unsigned incl = __ballot_sync(kFull, (w >> 32) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    prefix += warp_sum(lane <= stop ? from_bits<T>((uint32_t)w) : T(0));
    if (incl) return prefix;
  }
}

template <typename T, bool kExclusive, bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t n,
            int64_t n_tiles, int64_t ld_out, uint64_t* __restrict__ status,
            unsigned* __restrict__ counter) {
  __shared__ unsigned s_tile;
  __shared__ T s_warp[kCombine];    // warp totals, then their exclusive sums
  __shared__ T s_prefix;            // the sum of every element before the tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the counter's number g is tile g % n_tiles of row g / n_tiles
  const int64_t g = gm::take_tile(counter, &s_tile);
  const int64_t row = g / n_tiles;
  const int64_t first = g - g % n_tiles;     // the row's first status word
  const int64_t tile = g - first;
  in += row * n;
  out += row * ld_out;
  const int64_t base = tile * kTile;
  const bool full = base + kTile <= n;

  // round r of this thread: elements [base + r*kThreads*4 + 4*tid, +4)
  T x[kRounds][4];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads * 4 + 4 * threadIdx.x;
    if (kVec && full) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(in + i));
      x[r][0] = from_bits<T>(v.x);
      x[r][1] = from_bits<T>(v.y);
      x[r][2] = from_bits<T>(v.z);
      x[r][3] = from_bits<T>(v.w);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) x[r][m] = i + m < n ? in[i + m] : T(0);
    }
  }

  // thread totals of each round, and their exclusive scan within the warp
  T t_excl[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const T s = (x[r][0] + x[r][1]) + (x[r][2] + x[r][3]);
    const T incl = warp_inclusive(s, lane);
    T ex = __shfl_up_sync(kFull, incl, 1);
    t_excl[r] = lane == 0 ? T(0) : ex;
    if (lane == 31) s_warp[r * kWarps + warp] = incl;
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive prefixes of the warp totals in (round, warp) order
    constexpr int kPer = kCombine / 32;
    T w[kPer];
    T lsum = T(0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      w[k] = s_warp[lane * kPer + k];
      lsum += w[k];
    }
    const T lincl = warp_inclusive(lsum, lane);
    const T agg = __shfl_sync(kFull, lincl, 31);
    T run = __shfl_up_sync(kFull, lincl, 1);
    if (lane == 0) run = T(0);
    // publish the aggregate before waiting on anyone (tile 0: its prefix)
    if (lane == 0)
      store_status(status + g,
                   (tile == 0 ? kInclusive : kAggregate) | to_bits(agg));
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      s_warp[lane * kPer + k] = run;
      run += w[k];
    }
    T prefix = T(0);
    if (tile > 0) {
      prefix = look_back<T>(status, g, first, lane);
      if (lane == 0)
        store_status(status + g, kInclusive | to_bits(prefix + agg));
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (kExclusive && base + kTile >= n) out[n] = prefix + agg;
    }
  }
  __syncthreads();

  const T tile_prefix = s_prefix;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads * 4 + 4 * threadIdx.x;
    T acc = (tile_prefix + s_warp[r * kWarps + warp]) + t_excl[r];
    T y[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (kExclusive) {
        y[m] = acc;
        acc += x[r][m];
      } else {
        acc += x[r][m];
        y[m] = acc;
      }
    }
    if (kVec && full) {
      __stcs(reinterpret_cast<uint4*>(out + i),
             make_uint4(to_bits(y[0]), to_bits(y[1]), to_bits(y[2]),
                        to_bits(y[3])));
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (i + m < n) out[i + m] = y[m];
    }
  }
}

template <typename T, bool kExclusive>
int run(const void* in, void* out, void* scratch, int64_t n_lanes, int64_t n,
        int64_t ld_out, cudaStream_t s) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t items = n_lanes * n_tiles;
  uint64_t* status = (uint64_t*)scratch;
  unsigned* counter = (unsigned*)(status + items);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(items + 1) * 8, s);
  if (e != cudaSuccess) return (int)e;
  // 16-byte loads and stores need every row aligned
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   (n_lanes == 1 || (n % 4 == 0 && ld_out % 4 == 0));
  if (vec)
    scan_kernel<T, kExclusive, true><<<(unsigned)items, kThreads, 0, s>>>(
        (const T*)in, (T*)out, n, n_tiles, ld_out, status, counter);
  else
    scan_kernel<T, kExclusive, false><<<(unsigned)items, kThreads, 0, s>>>(
        (const T*)in, (T*)out, n, n_tiles, ld_out, status, counter);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* in, void* out, void* scratch, int64_t n_lanes,
             int64_t n, int64_t ld_out, int exclusive, cudaStream_t s) {
  return exclusive ? run<T, true>(in, out, scratch, n_lanes, n, ld_out, s)
                   : run<T, false>(in, out, scratch, n_lanes, n, ld_out, s);
}

}  // namespace

extern "C" {

// Elements per tile: for B rows of n the wrapper allocates B * ceil(n /
// tile) + 1 uint64 words of scratch (one status word per row and tile, and
// the tile counter).
int gm_cumsum_tile_size(void) { return kTile; }

// dtype: 0 = int32 (added as uint32, wraps mod 2^32), 1 = float32.
// in holds n_lanes rows of n values, one after another; row r of out starts
// at out + r * ld_out.  exclusive: 0 writes n values out[i] = sum(in[:i+1])
// a row; 1 writes n + 1 values out[i] = sum(in[:i]).  n == 0 writes
// nothing.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown dtype).
int gm_cumsum(const void* in, void* out, void* scratch, int64_t n_lanes,
              int64_t n, int64_t ld_out, int dtype, int exclusive,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || n_lanes <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return dispatch<uint32_t>(in, out, scratch, n_lanes, n, ld_out,
                              exclusive, s);
  if (dtype == 1)
    return dispatch<float>(in, out, scratch, n_lanes, n, ld_out, exclusive,
                           s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
