// K4: paged attention straight off the KV block pool (int8 or full precision).
//
// Replaces the Pallas kernel `_paged_kernel` reached through `_paged_forward`
// in unionml_tpu/ops/paged_attention.py. Same function: S queries of each row
// attend over the row's KV through its block table; logical key position
// w*bs + o lives in pool block table[b, w] at offset o and is visible to query
// s iff w*bs + o <= base[b] + s. An int8 pool is dequantized as
// (codes.f32 * scale).astype(out_dtype) with per-(block, head) f32 scales, the
// same value rounding as the reference's gather-dequant; a full-precision pool
// is read as is. Scores, softmax and the value sum run in f32.
//
// What bounds it on the H100: decode is S = 1, so each stored K/V byte feeds
// about one multiply-add: the kernel is bounded by the bytes it reads (int8
// codes + scales of the columns the query can see, q, and the output), far
// below the card's ridge point.
//
// Design, simple and right first: one CTA per (query s, head h, row b), 8
// warps. The CTA reads its row's table itself (no scalar prefetch on a GPU)
// and walks only columns 0 .. (base + s) / bs: the rest of the table (the
// unwritten tail and the trailing scratch column) is masked for this query and
// never read. Warps take columns round robin; inside a warp a lane pair owns
// one key of a 16-key pass, each lane half of the head dim, loaded with
// 16-byte vector loads straight into registers and dequantized there. Each
// warp keeps its own online-softmax state (max, sum, a partial value sum per
// lane); the pass's scores are reduced across the warp by shuffles. At the end
// lanes and then warps are merged through shared memory. No pool-sized copy,
// no gathered table in device memory. head_dim 64 or 128.

#include <string.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kKeysPerPass = 16;  // one key per lane pair

template <typename KV, typename OUT, int DH>
__device__ __forceinline__ void load_half_row(const typename KV::T* __restrict__ src, float scale,
                                              float* out) {
  using T = typename KV::T;
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecs = DH / kPerVec;
  constexpr bool kQuant = sizeof(T) == 1;
  const uint4* vec = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const uint4 raw = __ldg(vec + i);
    T vals[kPerVec];
    memcpy(vals, &raw, 16);
#pragma unroll
    for (int e = 0; e < kPerVec; ++e) {
      const float x = KV::load(vals[e]);
      // int8: the reference's (codes.f32 * scale).astype(out_dtype)
      out[i * kPerVec + e] = kQuant ? OUT::round(x * scale) : x;
    }
  }
}

template <typename OUT, typename KV, int D>
__global__ void __launch_bounds__(kWarps * 32) paged_attention_kernel(
    const typename OUT::T* __restrict__ q, const typename KV::T* __restrict__ k_pool,
    const typename KV::T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ base, typename OUT::T* __restrict__ o, int H, int S, int bs, int W,
    float sm_scale) {
  constexpr int DH = D / 2;  // dims per lane
  __shared__ float s_acc[kWarps][D];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];

  const int s_idx = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane & 1;
  const int key_slot = lane >> 1;

  const int q_pos = base[b] + s_idx;
  const int last_col = q_pos < 0 ? -1 : min(q_pos / bs, W - 1);

  float qr[DH], acc[DH], kv[DH];
  const typename OUT::T* q_row = q + ((static_cast<size_t>(b) * H + h) * S + s_idx) * D + half * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = OUT::load(q_row[d]);
    acc[d] = 0.f;
  }
  float m = uml::kNegInf, l = 0.f;

  for (int w = warp; w <= last_col; w += kWarps) {
    const int blk = table[static_cast<size_t>(b) * W + w];
    const size_t bh = static_cast<size_t>(blk) * H + h;
    const float ks = k_scale != nullptr ? k_scale[bh] : 1.f;
    const float vs = v_scale != nullptr ? v_scale[bh] : 1.f;
    for (int c = 0; c < bs; c += kKeysPerPass) {
      const int j = c + key_slot;
      const bool valid = j < bs && w * bs + j <= q_pos;
      const size_t row = (bh * bs + min(j, bs - 1)) * D + half * DH;
      load_half_row<KV, OUT, DH>(k_pool + row, ks, kv);
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) part += qr[d] * kv[d];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const float score = valid ? part * sm_scale : uml::kNegInf;
      float m_new = score;
#pragma unroll
      for (int off = 2; off < 32; off <<= 1) m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
      m_new = fmaxf(m, m_new);
      const float corr = expf(m - m_new);
      // a masked key contributes exactly 0 (exp(0) would be 1 while every
      // key seen so far is masked)
      const float p = valid ? expf(score - m_new) : 0.f;
      l = l * corr + (half == 0 ? p : 0.f);  // each key counted once per pair
      load_half_row<KV, OUT, DH>(v_pool + row, vs, kv);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = acc[d] * corr + p * kv[d];
      m = m_new;
    }
  }

  // merge the lane pairs of the warp (same half of the head dim), then warps
#pragma unroll
  for (int off = 2; off < 32; off <<= 1) {
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane < 2) {
#pragma unroll
    for (int d = 0; d < DH; ++d) s_acc[warp][half * DH + d] = acc[d];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x < D) {
    float m_all = uml::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
    float l_all = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w] - m_all);  // 0 for a warp that saw no key
      l_all += s_l[w] * f;
      out += s_acc[w][threadIdx.x] * f;
    }
    o[((static_cast<size_t>(b) * H + h) * S + s_idx) * D + threadIdx.x] =
        OUT::store(out / fmaxf(l_all, 1e-30f));
  }
}

template <typename OUT, typename KV, int D>
void launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
            const int* table, const int* base, void* o, int B, int H, int S, int bs, int W,
            float sm_scale, cudaStream_t stream) {
  const dim3 grid(S, H, B);
  paged_attention_kernel<OUT, KV, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const typename OUT::T*>(q), static_cast<const typename KV::T*>(k),
      static_cast<const typename KV::T*>(v), ks, vs, table, base,
      static_cast<typename OUT::T*>(o), H, S, bs, W, sm_scale);
}

template <typename OUT, int D>
int dispatch_kv(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                const int* table, const int* base, void* o, int B, int H, int S, int bs, int W,
                int kv_int8, float sm_scale, cudaStream_t stream) {
  if (kv_int8) {
    launch<OUT, uml::I8, D>(q, k, v, ks, vs, table, base, o, B, H, S, bs, W, sm_scale, stream);
  } else {
    launch<OUT, OUT, D>(q, k, v, nullptr, nullptr, table, base, o, B, H, S, bs, W, sm_scale, stream);
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 — of q, of the output and, when kv_int8 is
// 0, of the pool. kv_int8 = 1: the pool holds int8 codes and k_scale/v_scale
// hold one f32 per (block, head). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a combination the Python wrapper rejects first).
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* k_scale,
                               const void* v_scale, const void* table, const void* base, void* o,
                               int B, int H, int S, int D, int bs, int W, int dtype, int kv_int8,
                               float sm_scale, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* bse = static_cast<const int*>(base);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) {
    dispatch_kv<uml::F32, 64>(q, k, v, ks, vs, tbl, bse, o, B, H, S, bs, W, kv_int8, sm_scale, s);
  } else if (dtype == 0 && D == 128) {
    dispatch_kv<uml::F32, 128>(q, k, v, ks, vs, tbl, bse, o, B, H, S, bs, W, kv_int8, sm_scale, s);
  } else if (dtype == 1 && D == 64) {
    dispatch_kv<uml::BF16, 64>(q, k, v, ks, vs, tbl, bse, o, B, H, S, bs, W, kv_int8, sm_scale, s);
  } else if (dtype == 1 && D == 128) {
    dispatch_kv<uml::BF16, 128>(q, k, v, ks, vs, tbl, bse, o, B, H, S, bs, W, kv_int8, sm_scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
