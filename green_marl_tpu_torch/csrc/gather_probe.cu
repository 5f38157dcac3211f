// The gather probes: what the row gather of the batched engine can reach.
//
// 1. Blocked take-along-axis.  Replaces the in-VMEM `take_along_axis`
//    kernels of the TPU probes: `kern_sub` / `kern_lane` / `kern_full`
//    (scripts/probe_gather.py:109/116/124, a fixed 2 MB window), and
//    `kern_axis0` / `kern_axis1` / `kern_row` (scripts/probe_gather2.py:118/
//    122/126), `mk_tall`'s kernel (:154) and `mk_pallas`'s kernel
//    (scripts/probe_gather3.py:95), each on the block of its grid step.
//    Grid step b covers the idx rows [b*bh, (b+1)*bh) of a [R, 128] idx and
//    reads the table block of `th` rows that starts at row b*t_stride
//    (t_stride = th for blocked layouts, 0 for a fixed window).  Modes:
//      axis0:    out[i,j] = tb[r(idx[i,j]), j]
//      axis1:    out[i,j] = tb[i, l(idx[i,j])]
//      row:      out[i,j] = tb[r(idx[i,0]), j]
//      composed: l = l(idx[i,j]); out[i,j] = tb[r(idx[i,l]), l]
//    where r() and l() are the row and lane parts of an index: the index
//    itself, or with `split` its bits >> 7 and & 127 (probe_gather.py's
//    encoding); r() is clipped to [0, th) and l() to [0, 128), as the TPU
//    kernels clip (probe_gather.py:112,127).
//    Bound on an H100: the random 4-byte reads.  The TPU staged each block
//    in VMEM (many MB); a Hopper block has 227 KB of shared memory.  So a
//    table block of th*512 bytes that fits is staged in shared memory by
//    one CUDA block per grid step (coalesced 16-byte loads, then gathers
//    from shared memory); larger blocks and windows are read through
//    L1/L2 with one thread per output element.
//
// 2. K-in-flight row gather.  Replaces `gather_kernel`
//    (scripts/probe_gather4.py:36, via `run` :66), which kept K async DMA
//    row copies HBM -> VMEM in flight.  Here each warp walks its share of
//    the T sweeps over R row ids and keeps K `cp.async` copies of whole
//    rows (16 bytes per lane) in flight into a shared-memory ring of K
//    slots (`cp.async.commit_group` / `wait_group<K-1>`), then reads
//    element 0 of the oldest row into a uint32 sum.  Warp sums meet in one
//    atomicAdd: the result is T * sum(table[idx, 0]) mod 2^32.
//    Bound on an H100: the number of row requests in flight against the
//    memory latency (~0.5-1 us); K and the warps resident set it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;      // table and idx rows are 128 wide
constexpr int kTakeThreads = 256;
constexpr int kGatherWarps = 4;  // warps per block of the row gather
constexpr int kRowsPerWarp = 256;  // row ids each warp of the row gather walks

enum Mode { kAxis0 = 0, kAxis1 = 1, kRow = 2, kComposed = 3 };

__device__ __forceinline__ int row_part(int v, int split, int th) {
  const int r = split ? (v >> 7) : v;
  return min(max(r, 0), th - 1);
}

__device__ __forceinline__ int lane_part(int v, int split) {
  return split ? (v & 127) : min(max(v, 0), kLanes - 1);
}

// One output element.  `tb`: the table block (shared or global); `irow`:
// the idx row of the element; `li`: its row within the grid step.
__device__ __forceinline__ float take_one(const float* tb,
                                          const int32_t* __restrict__ irow,
                                          int li, int j, int th, int mode,
                                          int split) {
  const int v = irow[j];
  switch (mode) {
    case kAxis0:
      return tb[row_part(v, split, th) * kLanes + j];
    case kAxis1:
      return tb[li * kLanes + lane_part(v, split)];
    case kRow:
      return tb[row_part(irow[0], split, th) * kLanes + j];
    default: {  // kComposed
      const int l = lane_part(v, split);
      return tb[row_part(irow[l], split, th) * kLanes + l];
    }
  }
}

__global__ void __launch_bounds__(kTakeThreads)
take_global_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   int64_t n_out, int bh, int th, int64_t t_stride, int mode,
                   int split) {
  const int64_t e = (int64_t)blockIdx.x * kTakeThreads + threadIdx.x;
  if (e >= n_out) return;
  const int64_t row = e / kLanes;
  const int j = (int)(e % kLanes);
  const int64_t b = row / bh;
  const int li = (int)(row % bh);
  out[e] = take_one(table + b * t_stride * kLanes, idx + row * kLanes, li, j,
                    th, mode, split);
}

// One CUDA block per grid step: stage the table block, then gather.
__global__ void __launch_bounds__(kTakeThreads)
take_staged_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   int bh, int th, int64_t t_stride, int mode, int split) {
  extern __shared__ float4 stage4[];
  const float* stage = reinterpret_cast<const float*>(stage4);
  const int64_t b = blockIdx.x;
  const float4* src =
      reinterpret_cast<const float4*>(table + b * t_stride * kLanes);
  const int n4 = th * kLanes / 4;
  for (int k = threadIdx.x; k < n4; k += kTakeThreads) stage4[k] = src[k];
  __syncthreads();
  const int64_t base = b * bh * kLanes;
  for (int k = threadIdx.x; k < bh * kLanes; k += kTakeThreads) {
    const int li = k / kLanes;
    const int j = k % kLanes;
    out[base + k] = take_one(stage, idx + (b * bh + li) * kLanes, li, j, th,
                             mode, split);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int K>
__global__ void __launch_bounds__(kGatherWarps * 32)
row_gather_kernel(const int32_t* __restrict__ table, int64_t n_rows,
                  int roww, const int32_t* __restrict__ idx, int64_t R,
                  int64_t total, uint32_t* __restrict__ out) {
  extern __shared__ int4 ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nch = roww / 4;  // 16-byte chunks per row, <= 32
  int4* my = ring + (size_t)warp * K * nch;
  const int64_t j0 =
      ((int64_t)blockIdx.x * kGatherWarps + warp) * kRowsPerWarp;
  const int64_t j_end = j0 + kRowsPerWarp;
  const int64_t j1 = j_end < total ? j_end : total;
  uint32_t acc = 0;
  auto issue = [&](int slot, int64_t j) {
    if (j < j1 && lane < nch) {
      int64_t row = idx[j % R];
      row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
      cp_async16(my + slot * nch + lane, table + row * roww + lane * 4);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
  for (int s = 0; s < K; ++s) issue(s, j0 + s);
  for (int64_t j = j0; j < j1; ++j) {
    const int slot = (int)((j - j0) % K);
    cp_async_wait<K - 1>();  // the oldest of the K copies has landed
    __syncwarp();
    if (lane == 0) acc += (uint32_t)reinterpret_cast<const int32_t*>(
                              my + slot * nch)[0];
    __syncwarp();
    issue(slot, j + K);
  }
  cp_async_wait<0>();
  if (lane == 0 && acc != 0u) atomicAdd(out, acc);
}

template <int K>
int launch_row_gather(const void* table, int64_t n_rows, int roww,
                      const void* idx, int64_t R, int64_t total, void* out,
                      cudaStream_t s) {
  const int64_t warps = (total + kRowsPerWarp - 1) / kRowsPerWarp;
  const int64_t blocks = (warps + kGatherWarps - 1) / kGatherWarps;
  const size_t smem = (size_t)kGatherWarps * K * roww * 4;
  row_gather_kernel<K><<<(unsigned)blocks, kGatherWarps * 32, smem, s>>>(
      (const int32_t*)table, n_rows, roww, (const int32_t*)idx, R, total,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocked take-along-axis of a float32 [*, 128] table at int32 [R, 128]
// indices into a float32 [R, 128] output; R a multiple of bh.  `staged`:
// stage each table block in shared memory (th * 512 bytes, at most the
// 227 KB a block may use).  Returns cudaGetLastError() after the launch.
int gm_take_along(const void* table, const void* idx, void* out, int64_t R,
                  int bh, int th, int64_t t_stride, int mode, int split,
                  int staged, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0) return (int)cudaGetLastError();
  if (bh <= 0 || th <= 0 || R % bh != 0 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  if (staged) {
    const int smem = th * kLanes * 4;
    cudaError_t e = cudaFuncSetAttribute(
        take_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    take_staged_kernel<<<(unsigned)(R / bh), kTakeThreads, smem, s>>>(
        (const float*)table, (const int32_t*)idx, (float*)out, bh, th,
        t_stride, mode, split);
  } else {
    const int64_t n_out = R * kLanes;
    take_global_kernel<<<(unsigned)((n_out + kTakeThreads - 1) /
                                    kTakeThreads),
                         kTakeThreads, 0, s>>>(
        (const float*)table, (const int32_t*)idx, (float*)out, n_out, bh,
        th, t_stride, mode, split);
  }
  return (int)cudaGetLastError();
}

// K-in-flight row gather over an int32 [n_rows, roww] table (roww a
// multiple of 4, at most 128; 16-byte aligned): adds element 0 of row
// idx[j % R] for j < R * sweeps into *out (uint32, zeroed by the caller).
// k in {1, 2, 4, 8, 16}.
int gm_row_gather(const void* table, int64_t n_rows, int roww,
                  const void* idx, int64_t R, int sweeps, int k,
                  void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (roww <= 0 || roww % 4 != 0 || roww > 128 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = R * (int64_t)sweeps;
  if (total <= 0) return (int)cudaGetLastError();
  switch (k) {
    case 1: return launch_row_gather<1>(table, n_rows, roww, idx, R, total, out, s);
    case 2: return launch_row_gather<2>(table, n_rows, roww, idx, R, total, out, s);
    case 4: return launch_row_gather<4>(table, n_rows, roww, idx, R, total, out, s);
    case 8: return launch_row_gather<8>(table, n_rows, roww, idx, R, total, out, s);
    case 16: return launch_row_gather<16>(table, n_rows, roww, idx, R, total, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
