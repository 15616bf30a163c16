// What the port's kernels share: element types, the packed skip map's tile
// reduction, and the Hopper building blocks (mbarriers, TMA and cp.async loads,
// wgmma and its descriptors, and the host-side tensor maps).
//
// Tensors cross the C interface as raw bytes; each kernel is templated on a
// storage struct that says how one stored element becomes a float and back.
// bf16 travels as its 16 raw bits, so conversions are exact bit operations
// (bf16 -> f32 is a shift) plus round-to-nearest-even on the way out.
#pragma once

#include <cuda.h>
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
  // round to nearest even in integer operations (the same value as
  // load(store(x)) for finite x, without the conversion unit)
  static __device__ __forceinline__ float round(float x) {
    const uint32_t u = __float_as_uint(x);
    return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
  }
};

struct I8 {
  using T = int8_t;
  static __device__ __forceinline__ float load(int8_t x) { return static_cast<float>(x); }
};

// four int8 codes packed in a word -> exact floats, without the conversion
// unit: byte e, biased by 128, becomes the low mantissa bits of 2^23 + 128 + x
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + e)) - 8388736.f;
}

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

// The scan ranges of a tile of 32 * NG rows in packed mode, one per group of
// 32 rows: group g's [min first, max end) over rows r0 + 32 g .. r0 + 32 g + 31
// (those < n_rows) goes to out[2 g], out[2 g + 1] in shared memory, with the
// rule of reduce_tile_range; callers take the union of the groups they own.
// Warp g reduces group g, so the block needs at least NG warps; every thread
// of the block must call this (it ends in __syncthreads).
template <int NG>
__device__ __forceinline__ void reduce_tile_ranges(const int* ranges, int r0, int n_rows, int n_other, int* out) {
  const int warp = static_cast<int>(threadIdx.x) / 32;
  if (warp < NG) {
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
    if ((threadIdx.x & 31) == 0) {
      out[2 * warp] = lo;
      out[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- Hopper
// Building blocks of the sm_90a kernels: mbarriers, TMA tile loads,
// warpgroup MMA (wgmma) and its shared-memory descriptors.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes initialised mbarriers visible to the async proxy (TMA) and the CTA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at coordinates (c0, c1, c2) of a 3-D tensor map (passed as
// a __grid_constant__ kernel parameter) into shared memory; completion adds the
// box's bytes to `bar`'s transaction count. Out-of-range elements read as 0.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tensor_map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async: one 16-byte copy from device memory into shared memory that does
// not pass through registers; with valid == false the 16 bytes are zero-filled
// and nothing is read. Copies are grouped by commit; wait_group<N> returns when
// at most N of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's earlier shared-memory writes (plain stores, cp.async)
// before later reads by the async proxy (wgmma operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma ordering: fence before the first wgmma that reads registers written
// since (accumulators, the A fragment); commit issued wgmmas as one group; wait
// until at most N groups are pending.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle (the layout a TMA
// box of 64 bf16 columns writes with CU_TENSOR_MAP_SWIZZLE_128B: rows of 128
// bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8), 1024-byte
// aligned atoms of 8 rows). lbo/sbo in bytes: K-major operands take sbo 1024
// (the next 8 rows) and ignore lbo; MN-major operands take lbo = the stride to
// the next 64 elements of M/N and sbo 1024 (the next 8 rows of K).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// two floats -> one word of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64, f32) = A (64 x 16) B^T, both bf16 from shared-memory descriptors
// (scale_d 0: d is overwritten; 1: d += A B^T). tnsp_b 1: B is MN-major.
template <int TnspB>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TnspB));
}

// d (64 x 64, f32) (+)= A (64 x 16) B: A bf16 in registers (the m64k16 A
// fragment, two bf16 per word), B bf16 from a shared-memory descriptor.
template <int TnspB>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TnspB));
}

// d (64 x 128, f32) (+)= A (64 x 16) B: A bf16 in registers (the m64k16 A
// fragment, two bf16 per word), B bf16 from a shared-memory descriptor.
template <int TnspB>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TnspB));
}

// ------------------------------------------------------ Hopper, host side
// The tensor maps the TMA loads read, built on the host and passed to the
// kernels as __grid_constant__ parameters (K1, K2 and K3 share these).

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (D, rows, BH) bf16 tensor map with boxes of 64 columns x box_rows rows,
// 128-byte swizzle, zeros past the edges; an empty tensor gets a map that is
// never read
inline bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int BH, int D, int box_rows) {
  if (rows == 0) {
    *map = CUtensorMap{};
    return true;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace uml
