// Globally segmented inclusive scan: out[i] = op over vals[s..i], where s is
// the start of i's segment (a run of equal ids), for op add, min or max on
// int32 or float32.
//
// Replaces the TPU kernel `_seg_scan_kernel` in its full-output form
// `segmented_scan` (green_marl_tpu/ops/pallas_kernels.py:134, call :152).
// There the grid ran in order on one core and carried the open segment's
// value and id from one 32,768-slot chunk to the next in SMEM.  Hopper
// blocks run in no order, so the carry becomes a scan of its own: the
// segmented operator on (head-flag, value) pairs,
//     (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2)),
// is associative.  A segment starts where ids[i] != ids[i-1] (and at i = 0
// unless ids[0] is -1, the TPU kernel's initial carry id), so any length is
// accepted and no padding is needed.  Integer add wraps mod 2^32.
//
// Bound on an H100: device-memory bandwidth.  Each slot's value and id are
// read once and its result written once: 12 B per slot, 828 MB at 69M
// slots, 0.247 ms at 3.35 TB/s.  The first design took three phases (fold
// each tile, scan the tile aggregates, scan each tile again: 20 B per slot)
// and 48 block barriers per 4,096 slots.  This one is a single pass with
// decoupled look-back on the segmented operator, one launch, like cumsum.cu:
//   - per tile of kTile slots, each thread loads kRounds 16-byte vectors of
//     values and of ids (coalesced, streaming hints), turns the ids into
//     head flags at once (the id before a vector comes from the lane below
//     by shuffle; lane 0 loads it), and scans its four slots of each round
//     in registers.  Each warp scans its threads' (flag, value) pairs with
//     shuffles and warp 0 combines the kRounds * kWarps warp pairs once:
//     three barriers a tile;
//   - each tile publishes one 64-bit status word (lookback.cuh): state 1
//     with the tile's own aggregate while the tile holds no segment head,
//     state 2 with the value of the segment open at the tile's end, which
//     a tile that holds a head knows at once and any other tile after its
//     look-back.  A look-back ends at the nearest predecessor in state 2.
// A segment that spans three tiles or more is therefore summed in an order
// that depends on which predecessors had finished their look-back: float32
// add may differ in the last bits from run to run on such segments (int32
// and min/max never do).  An input or output that is not 16-byte aligned
// takes the same kernel with 4-byte loads and stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using gm::kFull;
using gm::Red;

// Tile shape measured on an NVIDIA H100 80GB HBM3 at 700 W, 69M float32 add
// (PERF.md), threads x vectors per thread: 512 x 4 took 0.350-0.358 ms,
// 256 x 4 0.384, 512 x 2 0.390, 128 x 8 0.393, 256 x 8 0.417-0.430 (97-123
// registers a thread), 1024 x 1 and 1024 x 2 0.421-0.424.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;    // 16-byte vectors of values per thread and tile
constexpr int kTile = kThreads * 4 * kRounds;    // 8,192 slots per tile
constexpr int kCombine = kRounds * kWarps;       // warp pairs per tile
static_assert(kCombine % 32 == 0, "warp 0 combines kCombine / 32 per lane");
static_assert(kRounds <= 8, "a thread keeps its 4 * kRounds head flags in 32 bits");

// (pf, pv) . (f, v), the pair on the left coming first
template <typename R>
__device__ __forceinline__ void combine(int pf, typename R::type pv, int& f,
                                        typename R::type& v) {
  if (!f) v = R::apply(pv, v);
  f |= pf;
}

// Inclusive scan of one pair per lane.
template <typename R>
__device__ __forceinline__ void warp_seg_scan(int& f, typename R::type& v,
                                              int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int yf = __shfl_up_sync(kFull, f, s);
    const typename R::type yv = __shfl_up_sync(kFull, v, s);
    if (lane >= s) combine<R>(yf, yv, f, v);
  }
}

template <typename T, int OP, bool kVec>
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const T* __restrict__ vals, const int32_t* __restrict__ ids,
                T* __restrict__ out, int64_t n, uint64_t* __restrict__ status,
                unsigned* __restrict__ counter) {
  typedef Red<T, OP> R;
  __shared__ unsigned s_tile;
  __shared__ int s_wf[kCombine];    // warp pairs, then their exclusive scan
  __shared__ T s_wv[kCombine];
  __shared__ T s_carry;             // the open segment's value at tile start
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int64_t tile = gm::take_tile(counter, &s_tile);
  const int64_t base = tile * kTile;
  const bool full = base + kTile <= n;

  // round r of this thread: slots [base + r*kThreads*4 + 4*tid, +4)
  T x[kRounds][4];
  unsigned heads = 0;               // bit 4r+m: slot m of round r is a head
  T e_v[kRounds];                   // exclusive pair of the thread in its warp
  unsigned e_f = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads * 4 + 4 * threadIdx.x;
    int32_t id[4];
    if (kVec && full) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(vals + i));
      const int4 d = __ldcs(reinterpret_cast<const int4*>(ids + i));
      x[r][0] = gm::from_bits<T>(v.x);
      x[r][1] = gm::from_bits<T>(v.y);
      x[r][2] = gm::from_bits<T>(v.z);
      x[r][3] = gm::from_bits<T>(v.w);
      id[0] = d.x; id[1] = d.y; id[2] = d.z; id[3] = d.w;
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        x[r][m] = i + m < n ? vals[i + m] : R::ident();
        id[m] = i + m < n ? ids[i + m] : 0;
      }
    }
    int32_t prev = __shfl_up_sync(kFull, id[3], 1);
    if (lane == 0) prev = (i > 0 && i - 1 < n) ? ids[i - 1] : -1;
    int tf = 0;
    T tv = R::ident();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int h = (i + m < n) && id[m] != (m ? id[m - 1] : prev);
      heads |= (unsigned)h << (4 * r + m);
      tv = h ? x[r][m] : R::apply(tv, x[r][m]);
      tf |= h;
    }
    warp_seg_scan<R>(tf, tv, lane);
    if (lane == 31) {
      s_wf[r * kWarps + warp] = tf;
      s_wv[r * kWarps + warp] = tv;
    }
    const int ef = __shfl_up_sync(kFull, tf, 1);
    const T ev = __shfl_up_sync(kFull, tv, 1);
    e_v[r] = lane == 0 ? R::ident() : ev;
    e_f |= (unsigned)(lane == 0 ? 0 : ef) << r;
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the warp pairs, which stand in slot order
    constexpr int kPer = kCombine / 32;
    int wf[kPer];
    T wv[kPer];
    int lf = 0;
    T lv = R::ident();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      wf[k] = s_wf[lane * kPer + k];
      wv[k] = s_wv[lane * kPer + k];
      int f = wf[k];
      T v = wv[k];
      combine<R>(lf, lv, f, v);
      lf = f;
      lv = v;
    }
    warp_seg_scan<R>(lf, lv, lane);
    const int agg_f = __shfl_sync(kFull, lf, 31);
    const T agg_v = __shfl_sync(kFull, lv, 31);
    // publish before waiting on anyone
    if (lane == 0)
      gm::store_status(status + tile,
                       ((tile == 0 || agg_f) ? gm::kState2 : gm::kState1) |
                           gm::to_bits(agg_v));
    int rf = __shfl_up_sync(kFull, lf, 1);
    T rv = __shfl_up_sync(kFull, lv, 1);
    if (lane == 0) {
      rf = 0;
      rv = R::ident();
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      s_wf[lane * kPer + k] = rf;
      s_wv[lane * kPer + k] = rv;
      int f = wf[k];
      T v = wv[k];
      combine<R>(rf, rv, f, v);
      rf = f;
      rv = v;
    }
    T carry = R::ident();
    if (tile > 0) {
      carry = gm::look_back<R>(status, tile, lane);
      if (lane == 0 && !agg_f)
        gm::store_status(status + tile, gm::kState2 |
                         gm::to_bits(R::apply(carry, agg_v)));
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  const T tile_carry = s_carry;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads * 4 + 4 * threadIdx.x;
    T acc = tile_carry;
    acc = s_wf[r * kWarps + warp] ? s_wv[r * kWarps + warp]
                                  : R::apply(acc, s_wv[r * kWarps + warp]);
    acc = ((e_f >> r) & 1) ? e_v[r] : R::apply(acc, e_v[r]);
    T y[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      acc = ((heads >> (4 * r + m)) & 1) ? x[r][m] : R::apply(acc, x[r][m]);
      y[m] = acc;
    }
    if (kVec && full) {
      __stcs(reinterpret_cast<uint4*>(out + i),
             make_uint4(gm::to_bits(y[0]), gm::to_bits(y[1]),
                        gm::to_bits(y[2]), gm::to_bits(y[3])));
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (i + m < n) out[i + m] = y[m];
    }
  }
}

template <typename T, int OP>
int run(const void* vals, const void* ids, void* out, void* scratch,
        int64_t n, cudaStream_t s) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  uint64_t* status = (uint64_t*)scratch;
  unsigned* counter = (unsigned*)(status + n_tiles);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(n_tiles + 1) * 8, s);
  if (e != cudaSuccess) return (int)e;
  const bool vec = ((uintptr_t)vals % 16 == 0) && ((uintptr_t)ids % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec)
    seg_scan_kernel<T, OP, true><<<(unsigned)n_tiles, kThreads, 0, s>>>(
        (const T*)vals, (const int32_t*)ids, (T*)out, n, status, counter);
  else
    seg_scan_kernel<T, OP, false><<<(unsigned)n_tiles, kThreads, 0, s>>>(
        (const T*)vals, (const int32_t*)ids, (T*)out, n, status, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots per tile: the wrapper allocates ceil(n / tile) + 1 uint64 words of
// scratch (one status word per tile and the tile counter).
int gm_segmented_scan_tile_size(void) { return kTile; }

// dtype: 0 = int32 (add wraps mod 2^32), 1 = float32.  op: 0 = add,
// 1 = min, 2 = max.  n == 0 writes nothing.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unknown dtype or op).
int gm_segmented_scan(const void* vals, const void* ids, void* out,
                      void* scratch, int64_t n, int dtype, int op,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  switch (dtype * 3 + op) {
    case 0: return run<int32_t, gm::OP_ADD>(vals, ids, out, scratch, n, s);
    case 1: return run<int32_t, gm::OP_MIN>(vals, ids, out, scratch, n, s);
    case 2: return run<int32_t, gm::OP_MAX>(vals, ids, out, scratch, n, s);
    case 3: return run<float, gm::OP_ADD>(vals, ids, out, scratch, n, s);
    case 4: return run<float, gm::OP_MIN>(vals, ids, out, scratch, n, s);
    case 5: return run<float, gm::OP_MAX>(vals, ids, out, scratch, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
