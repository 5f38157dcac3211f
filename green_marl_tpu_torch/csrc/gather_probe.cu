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
//    Bound on an H100: the bytes of index, table and output, once each.
//    The TPU staged each block in VMEM (many MB); a Hopper block has 227 KB
//    of shared memory.  The caller names one of four routes by shape
//    (`kernels.take_along_route`):
//      slab (axis0): out[i,j] reads column j of the table block only, so a
//        block of any height fits shared memory as slabs of C columns
//        (th * C * 4 bytes).  One CUDA block per (row range, slab) brings
//        its slab in with 16-byte `cp.async` copies, all in flight at once,
//        loads its first indices meanwhile, then gathers from shared memory:
//        a thread takes 4 neighbouring columns of one idx row (one 16-byte
//        index load, four shared-memory reads, one 16-byte store), so index
//        and output move as whole 32-byte sectors from C = 8 up.  Under 32
//        columns a block writes a part of each 128-byte output line only:
//        those stores carry the L2 evict-last policy, so that the line
//        waits in L2 for the blocks of the other slabs (0.136 -> 0.063 ms
//        at the 2 MB window).  With a fixed window each slab is staged by
//        a few persistent blocks that share the idx rows between them;
//        with a blocked layout a slab serves the bh idx rows of its grid
//        step.  Plain copies and no TMA box: a slab row is 32..512 bytes,
//        the kernel is bound by the index and output streams, and a tensor
//        map would tie the library to libcuda (`cuTensorMapEncodeTiled`) for
//        an address computation of two shifts.  Slabs of 2 or 4 columns lose to the
//        L2 route (16384-row blocks: 0.262-0.282 against 0.160 ms).
//      block (axis1, composed; th * 512 bytes fit): one CUDA block per grid
//        step stages the whole table block, then gathers.
//      L2 (the rest): one warp per idx row reads its 128 indices as 16 bytes
//        per lane (composed: through a shared-memory copy of the row, for
//        its second look-up) and gathers through L1/L2, a 32-byte sector
//        per value: 537 MB of sectors for 2^24 values, which is what holds
//        axis0 and composed at 0.10-0.16 ms there.  A thread-block cluster
//        of 16 blocks that holds a 2 MB table block in distributed shared
//        memory was tried in its place: 0.30-0.34 ms (4-byte reads over
//        the SM-to-SM network), so it is not kept.
//      row: `kern_row` (probe_gather2.py:126) copies whole 512-byte rows,
//        one warp per idx row, one lane reads the row's index and a shuffle
//        broadcasts it, each lane copies one 16-byte chunk of the row, and
//        each warp keeps kRowBatch rows in flight.
//
// 2. K-in-flight row gather.  Replaces `gather_kernel`
//    (scripts/probe_gather4.py:36, via `run` :66), which kept K async DMA
//    row copies HBM -> VMEM in flight.  The result, sweeps * sum(table[idx,
//    0]) mod 2^32, does not depend on the order of the requests, so the
//    kernel picks it: random ids over a table ten times the 50 MB L2 ask for
//    most rows twice or more, and in their given order the repeats go to
//    HBM again.  A pre-pass (two launches) bins the clipped ids by table
//    region with a counting sort on their high bits; then persistent warps
//    walk the binned ids in small chunks, interleaved over the whole grid,
//    so that all copies in flight at one time fall into a few neighbouring
//    regions: a row's first request reads HBM and its repeats meet it in
//    L2.  Each warp keeps K copy steps in flight into a shared-memory ring
//    of K slots and adds element 0 of the oldest step's rows into a uint32
//    sum; warp sums meet in one atomicAdd.  A step is one 512-byte row,
//    copied by the warp's lanes 16 bytes each (`cp.async`), or up to 8
//    narrower rows side by side.  One `cp.async.bulk` per row onto an
//    `mbarrier`, started and awaited by one lane, was slower on the binned
//    ids: 0.32-0.43 against 0.24-0.28 ms at 512-byte rows (the copy loop
//    alone 0.25-0.31 against 0.17-0.21: about 16 ns a row and SM).
//    Bound on an H100: the distinct rows and the ids, once each, from HBM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;      // table and idx rows are 128 wide
constexpr int kTakeThreads = 256;
constexpr int kRowBatch = 4;     // rows in flight per warp, row mode
constexpr int kRowBlocks = 4096; // grid cap of the row mode (grid-stride)
// Shapes tried on one NVIDIA H100 80GB HBM3 at 700.00 W
// (`probes/gather.py`, E = 2^24 indices; ms for the axis0 2 MB window /
// [1024,128] / [4096,128] blocks, slabs of 8 / 32 / 8 columns):
//   threads 256: 0.073 / 0.087 / 0.096; 512: 0.065 / 0.079 / 0.090 (kept);
//   1024: 0.071 / 0.093 / 0.093
//   index loads per thread 2: 0.071 / 0.081 / 0.093; 4: kept; 8: 0.069 /
//   0.079 / 0.098
constexpr int kSlabThreads = 512;  // most threads of a slab block
constexpr int kSlabUnroll = 4;   // 16-byte index loads in flight per thread
// Row gather, 512-byte rows, 2^21 ids over 2^20 rows, K = 2 / 8 (same card):
//   ids a warp takes at a time 4: 0.199 / 0.234; 8: 0.206 / 0.260 (kept: a
//   whole 32-byte sector of ids); 32 (with bulk copies): no better
//   table regions (kBins) 64: 0.198 / 0.280; 256: 0.206 / 0.260 (kept);
//   1024: 0.206 / 0.249
//   ids per thread of a pre-pass block 4 / 8 / 16: histogram 0.016 / 0.010 /
//   0.007 ms (16 kept)
//   rows per step at 32 / 128 / 512-byte rows, K = 4: one 0.138 / 0.136 /
//   0.203; what 32 lanes cover, up to 8 (kept) 0.069 / 0.092 / the same;
//   8 KB of ring per warp whatever K, 4 lanes to a 512-byte row 0.075 /
//   0.085 / 0.215
constexpr int kGatherWarps = 4;  // warps per block of the row gather
constexpr int kGatherChunk = 8;  // binned ids a warp takes at a time
constexpr int kBins = 256;       // most regions the pre-pass bins into
                                 // (`kernels.ROW_GATHER_BINS` sizes the scratch)
constexpr int kBinThreads = 512;
constexpr int kBinPerThread = 16;  // ids per thread of a pre-pass block
static_assert(kBins <= kBinThreads, "a thread scans one bin");
static_assert(kGatherChunk <= 8, "a step of 1, 2, 4 or 8 rows");

enum Mode { kAxis0 = 0, kAxis1 = 1, kRow = 2, kComposed = 3 };
enum Route { kRouteL2 = 0, kRouteBlock = 1, kRouteSlab = 2, kRouteRow = 3 };

__device__ __forceinline__ int row_part(int v, int split, int th) {
  const int r = split ? (v >> 7) : v;
  return min(max(r, 0), th - 1);
}

__device__ __forceinline__ int lane_part(int v, int split) {
  return split ? (v & 127) : min(max(v, 0), kLanes - 1);
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Take-along: the L2 route.  One warp per idx row, 4 columns per lane.
// ---------------------------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(kTakeThreads)
take_l2_kernel(const float* __restrict__ table, const int4* __restrict__ idx,
               float4* __restrict__ out, int64_t R, int bh, int th,
               int64_t t_stride, int split) {
  constexpr int kWarps = kTakeThreads / 32;
  __shared__ int irow[MODE == kComposed ? kWarps * kLanes : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < R;
       row += (int64_t)gridDim.x * kWarps) {
    const float* tb = table + row / bh * t_stride * kLanes;
    const int4 v = idx[row * (kLanes / 4) + lane];
    const int j = 4 * lane;
    float4 o;
    if constexpr (MODE == kAxis0) {
      o.x = tb[row_part(v.x, split, th) * kLanes + j];
      o.y = tb[row_part(v.y, split, th) * kLanes + j + 1];
      o.z = tb[row_part(v.z, split, th) * kLanes + j + 2];
      o.w = tb[row_part(v.w, split, th) * kLanes + j + 3];
    } else if constexpr (MODE == kAxis1) {
      const float* tr = tb + (row % bh) * kLanes;
      o.x = tr[lane_part(v.x, split)];
      o.y = tr[lane_part(v.y, split)];
      o.z = tr[lane_part(v.z, split)];
      o.w = tr[lane_part(v.w, split)];
    } else {
      int* mine = irow + warp * kLanes;
      reinterpret_cast<int4*>(mine)[lane] = v;
      __syncwarp();
      const int l0 = lane_part(v.x, split), l1 = lane_part(v.y, split);
      const int l2 = lane_part(v.z, split), l3 = lane_part(v.w, split);
      o.x = tb[row_part(mine[l0], split, th) * kLanes + l0];
      o.y = tb[row_part(mine[l1], split, th) * kLanes + l1];
      o.z = tb[row_part(mine[l2], split, th) * kLanes + l2];
      o.w = tb[row_part(mine[l3], split, th) * kLanes + l3];
      __syncwarp();
    }
    out[row * (kLanes / 4) + lane] = o;
  }
}

// ---------------------------------------------------------------------------
// Take-along: the row route.  out[row, :] = tb[r(idx[row, 0]), :], one warp
// per idx row.  kRowBatch rows per warp at a time: lanes 0..kRowBatch-1 read
// their rows' indices, then every lane copies one float4 of each row.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTakeThreads)
take_row_kernel(const float4* __restrict__ table,
                const int32_t* __restrict__ idx, float4* __restrict__ out,
                int64_t R, int bh, int th, int64_t t_stride, int split) {
  constexpr int kVecs = kLanes / 4;  // float4 per row: one per lane
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kTakeThreads / 32);
  const int64_t first =
      (int64_t)blockIdx.x * (kTakeThreads / 32) + (threadIdx.x >> 5);
  for (int64_t row0 = first * kRowBatch; row0 < R;
       row0 += warps * kRowBatch) {
    int v = 0;
    if (lane < kRowBatch && row0 + lane < R) v = idx[(row0 + lane) * kLanes];
    float4 chunk[kRowBatch];
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      const int vk = __shfl_sync(0xffffffffu, v, k);
      const int64_t row = row0 + k;
      if (row < R) {
        const int64_t trow = row / bh * t_stride + row_part(vk, split, th);
        chunk[k] = table[trow * kVecs + lane];
      }
    }
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k)
      if (row0 + k < R) out[(row0 + k) * kVecs + lane] = chunk[k];
  }
}

// ---------------------------------------------------------------------------
// Take-along: the block route (axis1 and composed).  One CUDA block per grid
// step: stage the table block, then gather, one thread per output element.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTakeThreads)
take_block_kernel(const float* __restrict__ table,
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
    const int32_t* irow = idx + (b * bh + li) * kLanes;
    const int v = irow[j];
    float o;
    if (mode == kAxis1) {
      o = stage[li * kLanes + lane_part(v, split)];
    } else {
      const int l = lane_part(v, split);
      o = stage[row_part(irow[l], split, th) * kLanes + l];
    }
    out[base + k] = o;
  }
}

// ---------------------------------------------------------------------------
// Take-along: the slab route (axis0).  Block (q, s) holds columns
// [s*C, (s+1)*C) of the table block of idx rows [q*rpb, (q+1)*rpb).
// ---------------------------------------------------------------------------

// A slab narrower than 32 columns writes less than a 128-byte line of each
// output row, and the blocks of the other slabs write the rest a little
// earlier or later.  Left alone, L2 writes such a line back before it is
// whole and device memory sees many small writes; stored with the
// evict-last policy the line waits in L2 for its other sectors.
__device__ __forceinline__ uint64_t l2_keep_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void store_keep(float4* p, float4 v,
                                           uint64_t policy) {
  asm volatile(
      "st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(policy)
      : "memory");
}

template <int C>
__global__ void __launch_bounds__(kSlabThreads)
take_slab_kernel(const float* __restrict__ table,
                 const int32_t* __restrict__ idx, float* __restrict__ out,
                 int64_t R, int rpb, int bh, int th, int64_t t_stride,
                 int split) {
  constexpr int kV = C / 4;              // 4-column pieces per slab row
  constexpr int kSlabs = kLanes / C;
  constexpr bool kNarrow = C < 32;       // less than a line of each row
  extern __shared__ float4 slab4[];
  const float* slab = reinterpret_cast<const float*>(slab4);
  const int T = blockDim.x;
  const int s = blockIdx.x % kSlabs;
  const int64_t r0 = (int64_t)(blockIdx.x / kSlabs) * rpb;
  const int n_rows = (int)(R - r0 < rpb ? R - r0 : rpb);
  const float* src = table + r0 / bh * t_stride * kLanes + s * C;
  const int32_t* ib = idx + r0 * kLanes + s * C;
  float* ob = out + r0 * kLanes + s * C;
  const int n_piece = n_rows * kV;
  const uint64_t keep = l2_keep_policy();
  for (int p = threadIdx.x; p < th * kV; p += T)
    cp_async16(slab4 + p, src + (int64_t)(p / kV) * kLanes + p % kV * 4);
  cp_async_commit();
  for (int base = 0; base < n_piece; base += kSlabUnroll * T) {
    int4 v[kSlabUnroll];
#pragma unroll
    for (int u = 0; u < kSlabUnroll; ++u) {
      const int p = base + u * T + threadIdx.x;
      if (p < n_piece)
        v[u] = *reinterpret_cast<const int4*>(
            ib + (int64_t)(p / kV) * kLanes + p % kV * 4);
    }
    if (base == 0) {   // the first indices are on their way: now the slab
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kSlabUnroll; ++u) {
      const int p = base + u * T + threadIdx.x;
      if (p < n_piece) {
        const float* col = slab + p % kV * 4;
        const float4 o = make_float4(
            col[row_part(v[u].x, split, th) * C],
            col[row_part(v[u].y, split, th) * C + 1],
            col[row_part(v[u].z, split, th) * C + 2],
            col[row_part(v[u].w, split, th) * C + 3]);
        float4* at = reinterpret_cast<float4*>(
            ob + (int64_t)(p / kV) * kLanes + p % kV * 4);
        if (kNarrow)
          store_keep(at, o, keep);
        else
          *at = o;
      }
    }
  }
}

template <int C>
cudaError_t launch_slab(const float* table, const int32_t* idx, float* out,
                        int64_t R, int bh, int th, int64_t t_stride,
                        int split, cudaStream_t s) {
  auto kernel = take_slab_kernel<C>;
  constexpr int kV = C / 4;
  constexpr int kSlabs = kLanes / C;
  const int smem = th * C * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int64_t rpb = bh;
  if (t_stride == 0) {
    // a fixed window: every block of a slab stages the same columns, so as
    // few blocks as fill the card share the idx rows between them
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kSlabThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1 || sms < 1) return cudaErrorLaunchOutOfResources;
    int64_t parts = (int64_t)sms * per_sm / kSlabs;
    if (parts < 1) parts = 1;
    rpb = (R + parts - 1) / parts;
  }
  const int64_t pieces = rpb * kV;
  int threads = (int)(pieces < kSlabThreads ? (pieces + 31) / 32 * 32
                                            : kSlabThreads);
  const int64_t blocks = (R + rpb - 1) / rpb * kSlabs;
  if (blocks > 0x7fffffff || rpb > 0x7fffffff / kV)
    return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(table, idx, out, R, (int)rpb,
                                                bh, th, t_stride, split);
  return cudaGetLastError();
}

template <int MODE>
void launch_l2(const float* table, const int32_t* idx, float* out, int64_t R,
               int bh, int th, int64_t t_stride, int split, cudaStream_t s) {
  constexpr int kWarps = kTakeThreads / 32;
  const int64_t blocks = (R + kWarps - 1) / kWarps;
  take_l2_kernel<MODE><<<(unsigned)(blocks < (1 << 30) ? blocks : 1 << 30),
                         kTakeThreads, 0, s>>>(
      table, (const int4*)idx, (float4*)out, R, bh, th, t_stride, split);
}

// ---------------------------------------------------------------------------
// Row gather: the pre-pass.  A counting sort of the clipped ids on their bits
// from `shift` up: a histogram over all blocks, then every block scans the
// histogram for the bins' first slots and scatters its ids behind them.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int clip_row(int v, int n_rows) {
  return v < 0 ? 0 : (v >= n_rows ? n_rows - 1 : v);
}

__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const int32_t* __restrict__ idx, int64_t R, int n_rows,
                 int shift, int n_bins, uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kBins];
  for (int b = threadIdx.x; b < n_bins; b += kBinThreads) h[b] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kBinThreads * kBinPerThread;
  int id[kBinPerThread];
#pragma unroll
  for (int i = 0; i < kBinPerThread; ++i) {
    const int64_t j = base + i * kBinThreads + threadIdx.x;
    id[i] = j < R ? clip_row(idx[j], n_rows) : -1;
  }
#pragma unroll
  for (int i = 0; i < kBinPerThread; ++i)
    if (id[i] >= 0) atomicAdd(&h[id[i] >> shift], 1u);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kBinThreads)
    if (h[b]) atomicAdd(&hist[b], h[b]);
}

// Exclusive prefix sums of v[0..n), n <= kBins, in place, by the whole
// block; `part`: kBins words of scratch.
__device__ void bins_exclusive_scan(uint32_t* v, int n, uint32_t* part) {
  const int b = threadIdx.x;
  const uint32_t mine = b < n ? v[b] : 0u;
  if (b < kBins) part[b] = mine;
  __syncthreads();
  for (int d = 1; d < kBins; d *= 2) {           // inclusive scan of `part`
    const uint32_t add = b >= d && b < kBins ? part[b - d] : 0u;
    __syncthreads();
    if (b < kBins) part[b] += add;
    __syncthreads();
  }
  if (b < n) v[b] = part[b] - mine;
  __syncthreads();
}

// A block sorts its ids by bin in shared memory first, so that it writes
// each bin's ids as one run of neighbouring words.
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(const int32_t* __restrict__ idx, int64_t R, int n_rows,
                   int shift, int n_bins, const uint32_t* __restrict__ hist,
                   uint32_t* __restrict__ cursor,
                   int32_t* __restrict__ binned) {
  __shared__ uint32_t h[kBins];      // this block's count, then its run's
                                        // first place among its sorted ids
  __shared__ uint32_t start[kBins];  // where this block's run of a bin
                                        // starts in `binned`
  __shared__ uint32_t part[kBins];
  __shared__ int32_t sorted[kBinThreads * kBinPerThread];
  for (int b = threadIdx.x; b < n_bins; b += kBinThreads) {
    start[b] = hist[b];
    h[b] = 0;
  }
  __syncthreads();
  bins_exclusive_scan(start, n_bins, part);
  const int64_t base = (int64_t)blockIdx.x * kBinThreads * kBinPerThread;
  int id[kBinPerThread];
  uint32_t rank[kBinPerThread];
#pragma unroll
  for (int i = 0; i < kBinPerThread; ++i) {
    const int64_t j = base + i * kBinThreads + threadIdx.x;
    id[i] = j < R ? clip_row(idx[j], n_rows) : -1;
  }
#pragma unroll
  for (int i = 0; i < kBinPerThread; ++i)
    if (id[i] >= 0) rank[i] = atomicAdd(&h[id[i] >> shift], 1u);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += kBinThreads)
    if (h[b]) start[b] += atomicAdd(&cursor[b], h[b]);
  __syncthreads();
  bins_exclusive_scan(h, n_bins, part);
#pragma unroll
  for (int i = 0; i < kBinPerThread; ++i)
    if (id[i] >= 0) sorted[h[id[i] >> shift] + rank[i]] = id[i];
  __syncthreads();
  const int n_here = (int)(R - base < kBinThreads * kBinPerThread
                               ? R - base
                               : kBinThreads * kBinPerThread);
  for (int p = threadIdx.x; p < n_here; p += kBinThreads) {
    const int v = sorted[p];
    const int b = v >> shift;
    binned[start[b] + (p - h[b])] = v;
  }
}

// ---------------------------------------------------------------------------
// Row gather: the copies.  Item t of the whole run copies row
// binned[t / sweeps].  The warps of the grid take chunks of kGatherChunk
// items in turn (chunk c goes to warp c % warps), so the copies in flight
// stay within warps * kGatherChunk neighbouring items of the binned order.
// A warp copies by steps, K of them in flight (`cp.async` groups), each
// lane 16 bytes: a step is one 512-byte row or, since a narrow row costs
// a whole step of its warp whatever its bytes (0.16 ms for 2^21 rows of 32 or
// 128 bytes at a row a step), the G rows that the 32 lanes cover: a power
// of two, at most a chunk.
// ---------------------------------------------------------------------------

// Rows per step for rows of `nch` 16-byte pieces.
int rows_per_step(int nch) {
  int g = 1;
  while (2 * g * nch <= 32 && 2 * g <= kGatherChunk) g *= 2;
  return g;
}

template <int K, int G>
__global__ void __launch_bounds__(kGatherWarps * 32)
row_gather_kernel(const int32_t* __restrict__ table, int roww,
                  const int32_t* __restrict__ binned, int64_t total,
                  int sweeps, uint32_t* __restrict__ out) {
  extern __shared__ int4 ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nch = roww / 4;  // 16-byte pieces per row, <= 32
  const int g = G == 1 ? 0 : lane / nch;      // my row of a step
  const int piece = G == 1 ? lane : lane % nch;
  const bool active = G == 1 ? lane < nch : g < G;
  int4* my = ring + (size_t)warp * K * G * nch;
  const int64_t warps = (int64_t)gridDim.x * kGatherWarps;
  const int64_t gw = (int64_t)blockIdx.x * kGatherWarps + warp;
  const int64_t n_chunks = (total + kGatherChunk - 1) / kGatherChunk;
  if (gw >= n_chunks) return;
  const int64_t my_chunks = (n_chunks - gw + warps - 1) / warps;
  const int64_t last = gw + (my_chunks - 1) * warps;   // my last chunk
  const int64_t n_items = (my_chunks - 1) * kGatherChunk +
                          (total - last * kGatherChunk < kGatherChunk
                               ? total - last * kGatherChunk
                               : kGatherChunk);
  const int64_t n_steps = (n_items + G - 1) / G;
  int ids = 0;
  uint32_t acc = 0;
  auto mine = [&](int64_t step) {    // do I copy in this step?
    return active && (G == 1 || step * G + g < n_items);
  };
  auto start_copy = [&](int64_t step) {
    if (step < n_steps) {
      const int64_t n = step * G;    // the step's first item, of mine
      const int o = (int)(n % kGatherChunk);
      if (o == 0) {
        const int64_t t =
            (gw + n / kGatherChunk * warps) * kGatherChunk + lane;
        if (lane < kGatherChunk && t < total)
          ids = binned[sweeps == 1 ? t : t / sweeps];
      }
      const int row = __shfl_sync(0xffffffffu, ids, (o + g) & 31);
      if (mine(step))
        cp_async16(my + (step % K) * G * nch + lane,
                   table + (int64_t)row * roww + piece * 4);
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
  for (int step = 0; step < K; ++step) start_copy(step);
  for (int64_t step = 0; step < n_steps; ++step) {
    cp_async_wait<K - 1>();  // the oldest of the K steps has landed
    __syncwarp();
    if (piece == 0 && mine(step))
      acc += (uint32_t)reinterpret_cast<const int32_t*>(
          my + (step % K) * G * nch + lane)[0];
    __syncwarp();
    start_copy(step + K);
  }
  cp_async_wait<0>();
  if (G > 1)
    for (int d = 16; d > 0; d /= 2)
      acc += __shfl_down_sync(0xffffffffu, acc, d);
  if (lane == 0 && acc != 0u) atomicAdd(out, acc);
}

template <int K, int G>
cudaError_t launch_row_gather(const void* table, int roww, const void* binned,
                              int64_t total, int sweeps, void* out,
                              cudaStream_t s) {
  auto kernel = row_gather_kernel<K, G>;
  const size_t smem = (size_t)kGatherWarps * K * G * roww * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kGatherWarps * 32, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || sms < 1) return cudaErrorLaunchOutOfResources;
  const int64_t chunks = (total + kGatherChunk - 1) / kGatherChunk;
  int64_t blocks = (chunks + kGatherWarps - 1) / kGatherWarps;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  kernel<<<(unsigned)blocks, kGatherWarps * 32, smem, s>>>(
      (const int32_t*)table, roww, (const int32_t*)binned, total, sweeps,
      (uint32_t*)out);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_row_gather(const void* table, int roww, const void* binned,
                              int64_t total, int sweeps, void* out,
                              cudaStream_t s) {
  switch (rows_per_step(roww / 4)) {
    case 1: return launch_row_gather<K, 1>(table, roww, binned, total, sweeps, out, s);
    case 2: return launch_row_gather<K, 2>(table, roww, binned, total, sweeps, out, s);
    case 4: return launch_row_gather<K, 4>(table, roww, binned, total, sweeps, out, s);
    default: return launch_row_gather<K, 8>(table, roww, binned, total, sweeps, out, s);
  }
}

}  // namespace

extern "C" {

// Blocked take-along-axis of a float32 [*, 128] table at int32 [R, 128]
// indices into a float32 [R, 128] output; R a multiple of bh; table, idx
// and out 16-byte aligned.  `route`: 0 through L1/L2 (axis0, axis1,
// composed), 1 the whole table block in shared memory (axis1, composed;
// th * 512 bytes, at most the 227 KB a block may use), 2 slabs of
// `slab_cols` columns of it (axis0; a power of two from 8 to 128 with
// th * slab_cols * 4 bytes in shared memory), 3 the row mode's own kernel.  Returns cudaGetLastError()
// after the launch.
int gm_take_along(const void* table, const void* idx, void* out, int64_t R,
                  int bh, int th, int64_t t_stride, int mode, int split,
                  int route, int slab_cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0) return (int)cudaGetLastError();
  if (bh <= 0 || th <= 0 || R % bh != 0 || mode < 0 || mode > 3 ||
      (route == kRouteRow) != (mode == kRow) ||
      (route == kRouteSlab && mode != kAxis0) ||
      (route == kRouteBlock && mode == kAxis0))
    return (int)cudaErrorInvalidValue;
  const float* t = (const float*)table;
  const int32_t* i = (const int32_t*)idx;
  float* o = (float*)out;
  if (route == kRouteRow) {
    const int64_t per_block = (kTakeThreads / 32) * kRowBatch;
    const int64_t blocks = (R + per_block - 1) / per_block;
    take_row_kernel<<<(unsigned)(blocks < kRowBlocks ? blocks : kRowBlocks),
                      kTakeThreads, 0, s>>>(
        (const float4*)table, i, (float4*)out, R, bh, th, t_stride, split);
  } else if (route == kRouteBlock) {
    const int smem = th * kLanes * 4;
    cudaError_t e = cudaFuncSetAttribute(
        take_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    take_block_kernel<<<(unsigned)(R / bh), kTakeThreads, smem, s>>>(
        t, i, o, bh, th, t_stride, mode, split);
  } else if (route == kRouteSlab) {
    switch (slab_cols) {
      case 8: return (int)launch_slab<8>(t, i, o, R, bh, th, t_stride, split, s);
      case 16: return (int)launch_slab<16>(t, i, o, R, bh, th, t_stride, split, s);
      case 32: return (int)launch_slab<32>(t, i, o, R, bh, th, t_stride, split, s);
      case 64: return (int)launch_slab<64>(t, i, o, R, bh, th, t_stride, split, s);
      case 128: return (int)launch_slab<128>(t, i, o, R, bh, th, t_stride, split, s);
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (route == kRouteL2) {
    if (mode == kAxis0)
      launch_l2<kAxis0>(t, i, o, R, bh, th, t_stride, split, s);
    else if (mode == kAxis1)
      launch_l2<kAxis1>(t, i, o, R, bh, th, t_stride, split, s);
    else
      launch_l2<kComposed>(t, i, o, R, bh, th, t_stride, split, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K-in-flight row gather over an int32 [n_rows, roww] table (roww a
// multiple of 4, at most 128; 16-byte aligned): adds element 0 of row
// clip(idx[j]) `sweeps` times, for every j < R, into scratch[0] (uint32).
// `scratch`: 1 + 2 * kBins uint32, zeroed by the caller; `binned`: R int32,
// the ids in binned order.  k in {1, 2, 4, 8, 16}.  Three
// launches; returns the first CUDA error.
int gm_row_gather(const void* table, int64_t n_rows, int roww,
                  const void* idx, int64_t R, int sweeps, int k,
                  void* scratch, void* binned, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (roww <= 0 || roww % 4 != 0 || roww > 128 || n_rows <= 0 ||
      n_rows > 0x7fffffff || R > 0x7fffffff || sweeps < 1)
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  int shift = 0;
  while (((n_rows - 1) >> shift) >= kBins) ++shift;
  const int n_bins = (int)((n_rows - 1) >> shift) + 1;
  uint32_t* out = (uint32_t*)scratch;
  uint32_t* hist = out + 1;
  uint32_t* cursor = hist + kBins;
  const int64_t per_block = (int64_t)kBinThreads * kBinPerThread;
  const unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
  bin_count_kernel<<<blocks, kBinThreads, 0, s>>>(
      (const int32_t*)idx, R, (int)n_rows, shift, n_bins, hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bin_scatter_kernel<<<blocks, kBinThreads, 0, s>>>(
      (const int32_t*)idx, R, (int)n_rows, shift, n_bins, hist, cursor,
      (int32_t*)binned);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = R * (int64_t)sweeps;
  switch (k) {
    case 1: return (int)launch_row_gather<1>(table, roww, binned, total, sweeps, out, s);
    case 2: return (int)launch_row_gather<2>(table, roww, binned, total, sweeps, out, s);
    case 4: return (int)launch_row_gather<4>(table, roww, binned, total, sweeps, out, s);
    case 8: return (int)launch_row_gather<8>(table, roww, binned, total, sweeps, out, s);
    case 16: return (int)launch_row_gather<16>(table, roww, binned, total, sweeps, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
