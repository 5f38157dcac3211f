// The bit BFS's final per-instance counts (models/batched.py
// `_bit_popstats`): for a [n_rows, lanes] bit plane, instance b's count is
// the number of rows whose bit b is set, and its traversed edges the sum of
// deg_rows over those rows, both int64 and exact.
//
// Replaces no TPU kernel: green_marl_tpu/models/batched.py:340
// `_bit_popstats` is left to XLA, which fuses each bit's shift, mask and
// widening into its two reductions.  Eager PyTorch does not: for 4,096
// instances over the LiveJournal-scale graph's 2.48 GB visited plane it
// ran 32 passes (one a bit) over each 1M-row chunk, each writing and reading
// an int32 shift, an int32 mask, an int64 copy, an int64 product and two
// int64 sums: ~1 TB of traffic, ~467 ms a call.  Here one launch reads each
// plane word and each degree once.
//
// Bounds on an H100: the plane once (2.48 GB, ~0.75 ms at 3.35 TB/s) and
// integer throughput: counting each bit of each word alone costs ~4
// operations a bit, ~128 a 32-bit word, ~5 ms at that shape.  The design
// keeps most words to a few operations:
//   - the plane is read as little-endian 32-bit words: bit p of word w of a
//     row is instance 32 w + p whatever the element type (bit i of lane l is
//     instance l * bits + i for the uint8, int16 and int32 planes alike), so
//     one kernel takes the three plane types and any lane count (rows whose
//     bytes are not a multiple of 4, or a plane not 4-byte aligned, are read
//     a byte at a time);
//   - a warp owns 32 consecutive words of a row (a column group) and walks
//     tiles of 32 rows: lane l loads word l of each of the tile's rows, 128
//     contiguous bytes a load, 32 loads in flight a lane;
//   - a lane counts the tile's union first, the rows whose word is not 0,
//     once for all its 32 instances: their number and their degree sum (by
//     bit slices: D_k, the rows whose degree has bit k set, ballotted for the
//     warp, gives sum_k popc(union & D_k) << k, over the tile's K significant
//     slices only; slice 31 weighs -2^31, as degrees are int32).  An instance
//     whose bit is set in every word of the union has the union's rows; one
//     whose bit is set in no word has none.  At the end of a BFS nearly every
//     instance is one or the other (a word is 0 in rows that none of its
//     sources reach, and the same in the rows that all good sources reach);
//     an instance with no row keeps the union's count and sum as a negative
//     difference: a count in a register, a sum in shared memory;
//   - only where some instance is neither does the lane transpose its 32 x 32
//     bit block in registers (five rounds of delta swaps, ~13 operations a
//     word), so that word i is instance i's 32-row mask, and every instance
//     whose mask is not the union keeps its difference from it (weighed by
//     the slices where it is neither 0 nor all ones);
//   - a lane's union sums and differences stay in registers and shared
//     memory across a warp's tiles; at the end each lane adds each of its
//     instances' two totals to the [lanes * bits] int64 outputs with one
//     64-bit `atomicAdd`.
//     Integer sums are order-free, so the results equal the plain version's
//     bit for bit.
//
// Shapes tried on one NVIDIA H100 80GB HBM3 at 700.00 W, in the order tried
// (the final popcount of one 4,096-source batch on the LiveJournal-scale
// graph, 4.84M rows of 128 int32 lanes, 96.6% of its words 0 or all ones
// and 59.3% of a word's 32-row blocks all 0 or all ones; bound 0.747 ms; ms
// a call):
// counts and sums of every instance in registers (190 of them, 8 warps an
// SM) and every block that is not all 0 or all ones transposed and weighed
// by slices, instance by instance, 4.63; the union counted once and only
// the instances off it kept, 4 blocks of 128 threads an SM, 1.61 (3 blocks
// at 168 registers 1.61; `__ldg` 1.61; with the next tile's loads in flight
// 1.48, spilling); kept, the transpose only where an instance's bit is set
// in some but not all of the union's words (0.0019% of the blocks), 1.12
// (with the next tile's loads in flight 1.01, spilling 256 bytes); the
// loads alone, no count, 0.92.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // see "Shapes tried" above
constexpr int kMinBlocks = 4;    // at most 128 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// One round of the 32 x 32 bit transpose: rows k and k + J (k & J == 0)
// swap the J x J blocks off the diagonal of their 2J x 2J block.
template <int J, uint32_t M>
__device__ __forceinline__ void swap_round(uint32_t (&x)[32]) {
#pragma unroll
  for (int b = 0; b < 32; b += 2 * J) {
#pragma unroll
    for (int k = b; k < b + J; ++k) {
      const uint32_t t = ((x[k] >> J) ^ x[k + J]) & M;
      x[k + J] ^= t;
      x[k] ^= t << J;
    }
  }
}

// x[r] bit i -> x[i] bit r.
__device__ __forceinline__ void transpose32(uint32_t (&x)[32]) {
  swap_round<16, 0x0000ffffu>(x);
  swap_round<8, 0x00ff00ffu>(x);
  swap_round<4, 0x0f0f0f0fu>(x);
  swap_round<2, 0x33333333u>(x);
  swap_round<1, 0x55555555u>(x);
}

// Word `col` of row `row` (0 past the plane's rows or the row's bytes).
template <bool kWords>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ plane,
                                              int64_t row, int64_t n_rows,
                                              int row_bytes, int col,
                                              int words) {
  if (row >= n_rows || col >= words) return 0u;
  const uint8_t* p = plane + row * row_bytes + 4 * (int64_t)col;
  if (kWords) return __ldcs(reinterpret_cast<const unsigned*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * col + b < row_bytes) v |= (uint32_t)__ldcs(p + b) << (8 * b);
  return v;
}

// sum over the rows r of `mask` of deg[r], by the tile's K significant
// degree slices (slice 31 weighs -2^31): Horner from the top slice.
__device__ __forceinline__ int64_t weigh(uint32_t mask,
                                         const uint32_t* slices, int K) {
  int64_t w = 0;
  for (int k = K - 1; k >= 0; --k) {
    const int p = __popc(mask & slices[k]);
    w = 2 * w + (k == 31 ? -p : p);
  }
  return w;
}

// Warps are laid over (column group, member) pairs, `per_group` members a
// group, each member taking every per_group-th tile of 32 rows.
template <bool kWords>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bit_popstats_kernel(const uint8_t* __restrict__ plane,
                    const int32_t* __restrict__ deg, int64_t n_rows,
                    int row_bytes, int words, int groups, int64_t per_group,
                    unsigned long long* __restrict__ cnt,
                    unsigned long long* __restrict__ trav) {
  // each lane's instances' degree sums less the union's, lane-private
  // columns: [warp][instance][lane]
  __shared__ int64_t s_dt[kWarps][32][32];
  __shared__ uint32_t s_slice[kWarps][32];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  const int64_t n_tiles = (n_rows + 31) / 32;
  const int64_t n_inst = (int64_t)row_bytes * 8;
  for (int64_t v = (int64_t)blockIdx.x * kWarps + wib;
       v < groups * per_group; v += n_warps) {
    const int col = (int)(v / per_group) * 32 + lane;
    int32_t dc[32];              // each instance's count less the union's
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dc[i] = 0;
      s_dt[wib][i][lane] = 0;
    }
    uint32_t uc = 0u;            // rows where the lane's word is not 0
    int64_t ut = 0;              // and their degrees
    for (int64_t tile = v % per_group; tile < n_tiles; tile += per_group) {
      const int64_t row0 = tile * 32;
      uint32_t x[32];
#pragma unroll
      for (int r = 0; r < 32; ++r)
        x[r] = load_word<kWords>(plane, row0 + r, n_rows, row_bytes, col,
                                 words);
      const int32_t d = row0 + lane < n_rows ? __ldcs(deg + row0 + lane) : 0;
      // the tile's degree sum, exact: 16-bit halves summed apart
      const int64_t tile_sum =
          (int64_t)__reduce_add_sync(kFull, d >> 16) * 65536 +
          __reduce_add_sync(kFull, (unsigned)d & 0xffffu);
      uint32_t m = 0u;           // the union: rows whose word is not 0
      uint32_t all = kFull, any = 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (x[r] != 0u) {
          m |= 1u << r;
          all &= x[r];
        }
        any |= x[r];
      }
      // bits of `all` are set in every row of the union, bits outside `any`
      // in none: only the others need the transpose
      uint32_t exc = m != 0u ? ~any : 0u, mixed = 0u;
      if ((any & ~all) != 0u) {  // instances whose rows are not the union
        transpose32(x);
        exc = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (x[i] == m) continue;
          exc |= 1u << i;
          if (x[i] != 0u && x[i] != kFull) mixed |= 1u << i;
        }
      } else {                   // the exceptions' rows: none
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = 0u;
      }
      const bool partial = m != 0u && m != kFull;
      int64_t wm = m == kFull ? tile_sum : 0;
      int K = 0;
      if (__any_sync(kFull, partial || mixed != 0u)) {
        // D_k, the rows whose degree has bit k set, for the whole warp
        K = 32 - __clz((int)__reduce_or_sync(kFull, (unsigned)d));
        int64_t w = 0;
        for (int k = K - 1; k >= 0; --k) {
          const uint32_t slice = __ballot_sync(kFull, ((unsigned)d >> k) & 1u);
          if (lane == 0) s_slice[wib][k] = slice;
          const int p = __popc(m & slice);
          w = 2 * w + (k == 31 ? -p : p);
        }
        if (partial) wm = w;
        __syncwarp();
      }
      uc += __popc(m);
      ut += wm;
      if (exc != 0u) {
        const int pm = __popc(m);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (!((exc >> i) & 1u)) continue;
          const int64_t wi =
              x[i] == kFull ? tile_sum
              : x[i] == 0u  ? 0
                            : weigh(x[i], s_slice[wib], K);
          dc[i] += __popc(x[i]) - pm;
          s_dt[wib][i][lane] += wi - wm;
        }
      }
      __syncwarp();              // the slices are read before they change
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int64_t inst = (int64_t)col * 32 + i;
      if (inst >= n_inst) continue;
      const unsigned long long cv = (unsigned long long)((int64_t)uc + dc[i]);
      const unsigned long long tv =
          (unsigned long long)(ut + s_dt[wib][i][lane]);
      if (cv) atomicAdd(cnt + inst, cv);
      if (tv) atomicAdd(trav + inst, tv);   // two's complement: exact
    }
  }
}

template <bool kWords>
cudaError_t launch(const uint8_t* plane, const int32_t* deg, int64_t n_rows,
                   int row_bytes, unsigned long long* cnt,
                   unsigned long long* trav, cudaStream_t s) {
  auto kernel = bit_popstats_kernel<kWords>;
  static int resident = 0;       // per instantiation
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
  const int words = (row_bytes + 3) / 4;
  const int groups = (words + 31) / 32;
  const int64_t n_tiles = (n_rows + 31) / 32;
  const int64_t want = (groups * n_tiles + kWarps - 1) / kWarps;
  const int64_t blocks = want < resident ? want : resident;
  int64_t per_group = blocks * kWarps / groups;
  if (per_group > n_tiles) per_group = n_tiles;
  if (per_group < 1) per_group = 1;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      plane, deg, n_rows, row_bytes, words, groups, per_group, cnt, trav);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[0][b] = the rows of `plane` ([n_rows, row_bytes] bytes, rows
// contiguous) whose bit b (bit b % 8 of byte b / 8) is set, out[1][b] the
// sum of `deg` ([n_rows] int32) over them, for b < 8 * row_bytes; `out` is
// [2, 8 * row_bytes] int64.  Rows are read as 4-byte words where row_bytes
// and `plane` are 4-byte aligned, else a byte at a time.  One memset of
// `out` and one launch; returns the first CUDA error.
int gm_bit_popstats(const void* plane, int64_t n_rows, int row_bytes,
                    const void* deg, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows < 1 || row_bytes < 1 || row_bytes > (1 << 26))
    return (int)cudaErrorInvalidValue;
  const int64_t n_inst = (int64_t)row_bytes * 8;
  cudaError_t e = cudaMemsetAsync(out, 0, 2 * n_inst * sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  const uint8_t* p = (const uint8_t*)plane;
  const int32_t* d = (const int32_t*)deg;
  unsigned long long* cnt = (unsigned long long*)out;
  unsigned long long* trav = cnt + n_inst;
  const bool words = row_bytes % 4 == 0 && (uintptr_t)plane % 4 == 0;
  return (int)(words ? launch<true>(p, d, n_rows, row_bytes, cnt, trav, s)
                     : launch<false>(p, d, n_rows, row_bytes, cnt, trav, s));
}

}  // extern "C"
