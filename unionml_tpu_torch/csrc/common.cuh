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

}  // namespace uml
