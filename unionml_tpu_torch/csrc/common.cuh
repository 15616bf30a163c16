// Element types shared by the port's kernels.
//
// Tensors cross the C interface as raw bytes; each kernel is templated on a
// storage struct that says how one stored element becomes a float and back.
// bf16 travels as its 16 raw bits, so conversions are exact bit operations
// (bf16 -> f32 is a shift) plus round-to-nearest-even on the way out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uml {

constexpr float kNegInf = -1e30f;  // the finite "masked" score of the JAX kernels

struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  // value rounding to this type, kept in a float
  static __device__ __forceinline__ float round(float x) { return x; }
};

struct BF16 {
  using T = uint16_t;
  static __device__ __forceinline__ float load(uint16_t x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  static __device__ __forceinline__ uint16_t store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float round(float x) { return load(store(x)); }
};

struct I8 {
  using T = int8_t;
  static __device__ __forceinline__ float load(int8_t x) { return static_cast<float>(x); }
};

// The scan range of a tile of 32 rows in packed (segment-id) mode: the
// [min first, max end) over rows r0 .. r0 + 31 (those < n_rows) of a
// (n_rows, 2) int32 array of per-row [first, end) ranges on the other axis,
// written to out[0], out[1] in shared memory. Rows past n_rows count as the
// empty range [n_other, 0). The first warp reduces by shuffles; every thread
// of the block must call this (it ends in __syncthreads).
__device__ __forceinline__ void reduce_tile_range(const int* ranges, int r0, int n_rows, int n_other,
                                                  int* out) {
  if (threadIdx.x < 32) {
    const int row = r0 + static_cast<int>(threadIdx.x);
    int lo = n_other, hi = 0;
    if (row < n_rows) {
      lo = ranges[2 * static_cast<size_t>(row)];
      hi = ranges[2 * static_cast<size_t>(row) + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (threadIdx.x == 0) {
      out[0] = lo;
      out[1] = hi;
    }
  }
  __syncthreads();
}

}  // namespace uml
