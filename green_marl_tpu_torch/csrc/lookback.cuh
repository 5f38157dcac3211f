// Shared by the single-pass kernels (cumsum.cu, segment_reduce.cu,
// segmented_scan.cu): the reduction operators, and the pieces of decoupled
// look-back (Merrill and Garland, 2016) that carry a value from tile to tile
// inside one launch.
//
//   - take_tile: a block takes its tile number from an atomicAdd on a
//     counter, so every tile before it belongs to a block that has already
//     started.  A block that waits on a predecessor's status word therefore
//     never waits on a block that was not scheduled, which would deadlock
//     once every SM holds a waiting block.
//   - a tile's status is one 64-bit word: the state in the high half
//     (0 = not ready; the kernels name states 1 and 2) and the value's 32
//     bits in the low half, stored and loaded whole, so state and value
//     never tear.
// The status words and the counter are scratch that the wrapper allocates
// and the C entry clears with one cudaMemsetAsync before the launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gm {

constexpr unsigned kFull = 0xffffffffu;

enum OpCode { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };

// add / min / max on int32 and float32 with their identities.  Integer add
// is done in uint32, so that it wraps mod 2^32 without signed overflow.
template <typename T, int OP> struct Red;

template <> struct Red<int32_t, OP_ADD> {
  using type = int32_t;
  __device__ static int32_t ident() { return 0; }
  __device__ static int32_t apply(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};
template <> struct Red<int32_t, OP_MIN> {
  using type = int32_t;
  __device__ static int32_t ident() { return INT32_MAX; }
  __device__ static int32_t apply(int32_t a, int32_t b) { return min(a, b); }
};
template <> struct Red<int32_t, OP_MAX> {
  using type = int32_t;
  __device__ static int32_t ident() { return INT32_MIN; }
  __device__ static int32_t apply(int32_t a, int32_t b) { return max(a, b); }
};
template <> struct Red<float, OP_ADD> {
  using type = float;
  __device__ static float ident() { return 0.0f; }
  __device__ static float apply(float a, float b) { return a + b; }
};
template <> struct Red<float, OP_MIN> {
  using type = float;
  __device__ static float ident() { return __int_as_float(0x7f800000); }
  __device__ static float apply(float a, float b) { return fminf(a, b); }
};
template <> struct Red<float, OP_MAX> {
  using type = float;
  __device__ static float ident() { return __int_as_float(0xff800000); }
  __device__ static float apply(float a, float b) { return fmaxf(a, b); }
};

__device__ __forceinline__ uint32_t to_bits(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t to_bits(int32_t v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t to_bits(float v) {
  return __float_as_uint(v);
}
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b) { return (T)b; }
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}

constexpr uint64_t kState1 = 1ull << 32;
constexpr uint64_t kState2 = 2ull << 32;

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The block's tile number; ends with a barrier, so shared memory written
// before the call is visible after it.
__device__ __forceinline__ int64_t take_tile(unsigned* counter,
                                             unsigned* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  return *s_tile;
}

// One warp: op over the values of the status words of tiles tile-1,
// tile-2, ... down to and including the nearest one in state 2 (before
// tile 0 stands a state 2 with the identity).  Waits for words that are
// not ready.  Each window of 32 words is folded by a butterfly, windows
// in order of distance, so the order is fixed by which tiles are in state
// 2 when they are read.  `w` may hold the lane's word of the first window,
// status[tile - 1 - lane], read ahead of time (0: not read, or not ready).
template <typename R>
__device__ typename R::type look_back(const uint64_t* status, int64_t tile,
                                      int lane, uint64_t w = 0) {
  using T = typename R::type;
  T carry = R::ident();
  for (int64_t end = tile - 1;; end -= 32, w = 0) {
    const int64_t j = end - lane;            // lane 0: the nearest predecessor
    if (j < 0) w = kState2 | to_bits(R::ident());
    while ((w >> 32) == 0) w = load_status(status + j);
    const unsigned stops = __ballot_sync(kFull, (w >> 32) == 2);
    const int stop = stops ? __ffs(stops) - 1 : 31;
    T v = lane <= stop ? from_bits<T>((uint32_t)w) : R::ident();
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      v = R::apply(v, __shfl_xor_sync(kFull, v, s));
    carry = R::apply(v, carry);              // farther tiles come first
    if (stops) return carry;
  }
}

}  // namespace gm
