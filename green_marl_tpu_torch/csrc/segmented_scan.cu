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
// is associative, and the scan takes the three phases of cumsum.cu:
//   1. each block folds one tile of kTile slots into its aggregate pair;
//   2. one block turns the tile aggregates into exclusive tile carries,
//      1,024 at a time with a running carry;
//   3. each block scans its tile again, kThreads slots per round with a
//      warp-shuffle block scan, and applies its carry to the slots before
//      the tile's first segment head.
// A segment starts where ids[i] != ids[i-1] (and at i = 0 unless ids[0] is
// -1, the TPU kernel's initial carry id), so any length is accepted and no
// padding is needed.  Integer add wraps mod 2^32 (uint32 arithmetic).
//
// Bound on an H100: device-memory bandwidth.  Phases 1 and 3 each read the
// values and the ids (ids[i-1] comes from the same or the previous line),
// phase 3 writes the output: 20 B per slot.  The tile aggregates are a
// thousandth of that.  A single pass with decoupled look-back would save
// phase 1's reads and is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4,096 slots per tile
constexpr int kScanThreads = 1024;

struct AddU32 {
  using T = uint32_t;
  __device__ static T ident() { return 0u; }
  __device__ static T apply(T a, T b) { return a + b; }
};
struct AddF32 {
  using T = float;
  __device__ static T ident() { return 0.0f; }
  __device__ static T apply(T a, T b) { return a + b; }
};
struct MinI32 {
  using T = int32_t;
  __device__ static T ident() { return INT32_MAX; }
  __device__ static T apply(T a, T b) { return a < b ? a : b; }
};
struct MaxI32 {
  using T = int32_t;
  __device__ static T ident() { return INT32_MIN; }
  __device__ static T apply(T a, T b) { return a > b ? a : b; }
};
struct MinF32 {
  using T = float;
  __device__ static T ident() { return __int_as_float(0x7f800000); }
  __device__ static T apply(T a, T b) { return fminf(a, b); }
};
struct MaxF32 {
  using T = float;
  __device__ static T ident() { return __int_as_float(0xff800000); }
  __device__ static T apply(T a, T b) { return fmaxf(a, b); }
};

// (flag, value) . (flag, value) -- the segmented operator.
template <typename Op>
__device__ __forceinline__ void combine(int& f, typename Op::T& v, int pf,
                                        typename Op::T pv) {
  // (pf, pv) precedes (f, v)
  if (!f) v = Op::apply(pv, v);
  f |= pf;
}

// Block-wide inclusive segmented scan of one pair per thread.  Returns the
// thread's inclusive pair in (f, v) and the block's aggregate in (tf, tv).
template <typename Op, int BLOCK>
__device__ void block_seg_scan(int& f, typename Op::T& v, int* wf,
                               typename Op::T* wv, int& tf,
                               typename Op::T& tv) {
  using T = typename Op::T;
  constexpr int kWarps = BLOCK / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int yf = __shfl_up_sync(0xffffffffu, f, s);
    const T yv = __shfl_up_sync(0xffffffffu, v, s);
    if (lane >= s) combine<Op>(f, v, yf, yv);
  }
  if (lane == 31) {
    wf[warp] = f;
    wv[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    int cf = lane < kWarps ? wf[lane] : 0;
    T cv = lane < kWarps ? wv[lane] : Op::ident();
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int yf = __shfl_up_sync(0xffffffffu, cf, s);
      const T yv = __shfl_up_sync(0xffffffffu, cv, s);
      if (lane >= s) combine<Op>(cf, cv, yf, yv);
    }
    if (lane < kWarps) {
      wf[lane] = cf;
      wv[lane] = cv;
    }
  }
  __syncthreads();
  if (warp > 0) combine<Op>(f, v, wf[warp - 1], wv[warp - 1]);
  tf = wf[kWarps - 1];
  tv = wv[kWarps - 1];
  __syncthreads();  // wf/wv are reused by the next call
}

__device__ __forceinline__ int head_flag(const int32_t* __restrict__ ids,
                                         int64_t i) {
  return i == 0 ? ids[0] != -1 : ids[i] != ids[i - 1];
}

// Phases 1 and 3: fold (or scan, when `out` is set) one tile, starting from
// the carry pair (cf, cv).
template <typename Op>
__device__ void tile_pass(const typename Op::T* __restrict__ vals,
                          const int32_t* __restrict__ ids, int64_t n,
                          int& cf, typename Op::T& cv,
                          typename Op::T* __restrict__ out) {
  using T = typename Op::T;
  __shared__ int wf[kThreads / 32];
  __shared__ T wv[kThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int k = 0; k < kItems; ++k) {
    if (base + k * kThreads >= n) break;  // uniform across the block
    const int64_t i = base + k * kThreads + threadIdx.x;
    int f = 0;
    T v = Op::ident();
    if (i < n) {
      f = head_flag(ids, i);
      v = vals[i];
    }
    int tf;
    T tv;
    block_seg_scan<Op, kThreads>(f, v, wf, wv, tf, tv);
    if (out != nullptr && i < n) out[i] = f ? v : Op::apply(cv, v);
    combine<Op>(tf, tv, cf, cv);
    cf = tf;
    cv = tv;
  }
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
tile_aggregates_kernel(const typename Op::T* __restrict__ vals,
                       const int32_t* __restrict__ ids, int64_t n,
                       int* __restrict__ agg_f,
                       typename Op::T* __restrict__ agg_v) {
  int cf = 0;
  typename Op::T cv = Op::ident();
  tile_pass<Op>(vals, ids, n, cf, cv, nullptr);
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = cf;
    agg_v[blockIdx.x] = cv;
  }
}

// Exclusive segmented scan of the tile aggregates, in place (values only:
// phase 3 needs the carry's value, not its flag).
template <typename Op>
__global__ void __launch_bounds__(kScanThreads)
tile_carries_kernel(const int* __restrict__ agg_f,
                    typename Op::T* __restrict__ agg_v, int64_t n_tiles) {
  using T = typename Op::T;
  __shared__ int wf[kScanThreads / 32];
  __shared__ T wv[kScanThreads / 32];
  __shared__ T incl_v[kScanThreads];
  int cf = 0;
  T cv = Op::ident();
  for (int64_t base = 0; base < n_tiles; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    int f = i < n_tiles ? agg_f[i] : 0;
    T v = i < n_tiles ? agg_v[i] : Op::ident();
    int tf;
    T tv;
    block_seg_scan<Op, kScanThreads>(f, v, wf, wv, tf, tv);
    // the inclusive pair of thread t-1, combined with the running carry
    incl_v[threadIdx.x] = f ? v : Op::apply(cv, v);
    __syncthreads();
    if (i < n_tiles) {
      agg_v[i] = threadIdx.x == 0 ? cv : incl_v[threadIdx.x - 1];
    }
    combine<Op>(tf, tv, cf, cv);
    cf = tf;
    cv = tv;
    __syncthreads();  // incl_v is rewritten by the next round
  }
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const typename Op::T* __restrict__ vals,
                 const int32_t* __restrict__ ids, int64_t n,
                 const typename Op::T* __restrict__ carries,
                 typename Op::T* __restrict__ out) {
  int cf = 0;
  typename Op::T cv = carries[blockIdx.x];
  tile_pass<Op>(vals, ids, n, cf, cv, out);
}

template <typename Op>
int run(const void* vals, const void* ids, void* out, void* agg_f,
        void* agg_v, int64_t n, cudaStream_t s) {
  using T = typename Op::T;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  tile_aggregates_kernel<Op><<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const T*)vals, (const int32_t*)ids, n, (int*)agg_f, (T*)agg_v);
  int err = (int)cudaGetLastError();
  if (err) return err;
  tile_carries_kernel<Op><<<1, kScanThreads, 0, s>>>(
      (const int*)agg_f, (T*)agg_v, n_tiles);
  err = (int)cudaGetLastError();
  if (err) return err;
  tile_scan_kernel<Op><<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const T*)vals, (const int32_t*)ids, n, (const T*)agg_v, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots per tile: the wrapper allocates ceil(n / tile) entries of each of
// the two scratch arrays (int32 flags, and values of the scan's type).
int gm_segmented_scan_tile_size(void) { return kTile; }

// dtype: 0 = int32 (add wraps mod 2^32), 1 = float32.  op: 0 = add,
// 1 = min, 2 = max.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for an unknown dtype or op).
int gm_segmented_scan(const void* vals, const void* ids, void* out,
                      void* agg_f, void* agg_v, int64_t n, int dtype, int op,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (dtype == 0 && op == 0) return run<AddU32>(vals, ids, out, agg_f, agg_v, n, s);
  if (dtype == 0 && op == 1) return run<MinI32>(vals, ids, out, agg_f, agg_v, n, s);
  if (dtype == 0 && op == 2) return run<MaxI32>(vals, ids, out, agg_f, agg_v, n, s);
  if (dtype == 1 && op == 0) return run<AddF32>(vals, ids, out, agg_f, agg_v, n, s);
  if (dtype == 1 && op == 1) return run<MinF32>(vals, ids, out, agg_f, agg_v, n, s);
  if (dtype == 1 && op == 2) return run<MaxF32>(vals, ids, out, agg_f, agg_v, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
