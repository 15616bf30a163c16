// K1: blocked attention forward with an online softmax (flash attention).
//
// Replaces the Pallas kernel `_flash_kernel` reached through `_flash_forward`
// in unionml_tpu/ops/attention.py (the `pl.pallas_call` of the forward). Same
// function: softmax(q k^T * sm_scale) v per (batch, head), with optional causal
// masking (query i sees keys j <= i), optional right-padding lengths kv_lens[b]
// (keys j >= kv_len are masked), optional packed segment ids, f32
// accumulation, output in q's dtype, zeros for a row that sees no key, and an
// optional f32 logsumexp per row (the residual a backward pass reuses).
//
// Segment-id (packed) mode, replacing the `packed=True` branch of
// `_flash_kernel` (attention.py:113-176) and its block-skip map
// `_segment_block_bounds` (:212-254): seg_ids is (B, seg_stride) int32, the
// query ids are its first Sq columns and the key ids its first Sk; key j is
// visible to query i when j < kv_len, id_q[i] == id_k[j] and id_q[i] > 0 (and
// j <= i under causal, row positions as in JAX). kv_len comes through kv_lens:
// the wrapper sets it to the last nonzero key id's index + 1. seg_ranges is
// (B, Sq, 2) int32: for each query, [first, end) of the key positions that
// carry its id (empty for padding). The CTA reduces them over its 32 rows and
// scans only the key tiles inside [min first, max end) ∩ [0, kv_len) ∩ the
// causal limit, so a packed row costs O(sum of seg_len^2), not O(S^2); a
// 32-row tile that straddles segments scans the union, and the in-tile id test
// keeps the union exact (as it keeps the superset ranges of ids that recur
// non-contiguously exact). Padding rows (id 0) see no key: they write zeros
// and an lse of -1e30, from which K2/K3 take exactly nothing (they select).
//
// What bounds it on the H100: at the engine's prefill shapes (B <= 4, H 12,
// D 64, S <= 512) the work is 4*B*H*Sq*Sk*D flops (half that under causal;
// in packed mode 4*D per visible pair, sum of s(s+1)/2 per segment) against
// ~(q + k + v + o) bytes, about Sk/2 flops per byte: above the card's bf16
// ridge only through the tensor cores, so a kernel that does its products on
// the CUDA cores is bounded by their f32 FMA rate, not by memory.
//
// Design, simple and right first: one CTA of 128 threads per (batch*head,
// tile of 32 query rows); four threads share a query row, each holding a
// quarter of the head dim of the scaled query and of the accumulator in
// registers (interleaved float4 columns, so the four threads hit distinct
// shared-memory banks). The CTA walks K/V tiles staged once in shared memory
// as f32 (with their key ids in packed mode) and read by all 32 rows; scores
// of 8 keys at a time are reduced across the four threads by warp shuffles and
// folded into the running (max, sum, acc) state. Tiles outside the scan range
// are never loaded. Any Sq and Sk: the ragged query tile and the ragged key
// tile are masked, there is no fallback. head_dim 64 or 128.
// Later work: mma.sync / wgmma tiles and cp.async/TMA staging.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;  // query rows per CTA, four threads per row
constexpr int kChunk = 8;    // keys scored per online-softmax update

template <typename E, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const typename E::T* __restrict__ q, const typename E::T* __restrict__ k,
    const typename E::T* __restrict__ v, const int* __restrict__ kv_lens,
    const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges,
    typename E::T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk, int seg_stride,
    int causal, float sm_scale) {
  constexpr int BK = D == 64 ? 64 : 32;  // keys per shared-memory tile (16 KB each of K and V)
  constexpr int NV = D / 16;             // float4 columns per thread
  constexpr int DT = NV * 4;             // dims per thread
  __shared__ float4 k_tile[BK * D / 4];
  __shared__ float4 v_tile[BK * D / 4];
  __shared__ int k_ids[BK];
  __shared__ int scan_range[2];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int quad = tid & 3;
  const int q0 = static_cast<int>(blockIdx.x) * kBlockQ;
  const int qi = q0 + (tid >> 2);
  const bool q_live = qi < Sq;
  const bool packed = seg_ids != nullptr;

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(Sk, max(kv_lens[b], 0));
  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, min(q0 + kBlockQ, Sq));
  int k_begin = 0;
  int qid = 0;
  const int* ids_b = packed ? seg_ids + static_cast<size_t>(b) * seg_stride : nullptr;
  if (packed) {
    uml::reduce_tile_range(seg_ranges + static_cast<size_t>(b) * Sq * 2, q0, Sq, Sk, scan_range);
    k_begin = scan_range[0];
    n_keys = min(n_keys, scan_range[1]);
    qid = q_live ? ids_b[qi] : 0;
  }

  // this thread's dims: float4 column j*4 + quad, i.e. dims (j*4+quad)*4 .. +3
  float qr[DT], acc[DT];
  const typename E::T* q_row = q + (static_cast<size_t>(bh) * Sq + (q_live ? qi : 0)) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[j * 4 + e] = E::load(q_row[(j * 4 + quad) * 4 + e]) * sm_scale;
      acc[j * 4 + e] = 0.f;
    }
  }
  float m = uml::kNegInf, l = 0.f;

  const typename E::T* k_bh = k + static_cast<size_t>(bh) * Sk * D;
  const typename E::T* v_bh = v + static_cast<size_t>(bh) * Sk * D;
  float* k_flat = reinterpret_cast<float*>(k_tile);
  float* v_flat = reinterpret_cast<float*>(v_tile);
  const int n_tiles = (n_keys + BK - 1) / BK;

  for (int t = k_begin / BK; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int key = k0 + idx / D;
      const bool in = key < Sk;
      const size_t src = static_cast<size_t>(key) * D + (idx % D);
      k_flat[idx] = in ? E::load(k_bh[src]) : 0.f;
      v_flat[idx] = in ? E::load(v_bh[src]) : 0.f;
    }
    if (packed && tid < BK) k_ids[tid] = k0 + tid < Sk ? ids_b[k0 + tid] : 0;
    __syncthreads();

    // the first chunk that can hold a key at or past k_begin (CTA-uniform)
    const int c_begin = k0 < k_begin ? ((k_begin - k0) / kChunk) * kChunk : 0;
#pragma unroll 1
    for (int c = c_begin; c < BK; c += kChunk) {
      if (k0 + c >= n_keys) break;  // CTA-uniform: the rest of the tile is masked
      float s[kChunk];
      unsigned valid = 0;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4* k_row = k_tile + (c + u) * (D / 4);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 kk = k_row[j * 4 + quad];
          part += qr[j * 4 + 0] * kk.x + qr[j * 4 + 1] * kk.y + qr[j * 4 + 2] * kk.z +
                  qr[j * 4 + 3] * kk.w;
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int key = k0 + c + u;
        const bool ok = key < kv_len && (!causal || key <= qi) &&
                        (!packed || (qid > 0 && k_ids[c + u] == qid));
        valid |= ok ? (1u << u) : 0u;
        s[u] = ok ? part : uml::kNegInf;
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) m_new = fmaxf(m_new, s[u]);
      const float corr = expf(m - m_new);
      float p[kChunk];
      float p_sum = 0.f;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        // a masked key contributes exactly 0, also on a row that sees no key
        // yet (m_new == kNegInf there, and exp(0) would be 1)
        p[u] = (valid >> u) & 1u ? expf(s[u] - m_new) : 0.f;
        p_sum += p[u];
      }
      l = l * corr + p_sum;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] *= corr;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4* v_row = v_tile + (c + u) * (D / 4);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float4 vv = v_row[j * 4 + quad];
          acc[j * 4 + 0] += p[u] * vv.x;
          acc[j * 4 + 1] += p[u] * vv.y;
          acc[j * 4 + 2] += p[u] * vv.z;
          acc[j * 4 + 3] += p[u] * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (!q_live) return;
  const float denom = fmaxf(l, 1e-30f);  // a row that saw no key writes zeros
  typename E::T* o_row = o + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o_row[(j * 4 + quad) * 4 + e] = E::store(acc[j * 4 + e] / denom);
  }
  if (lse != nullptr && quad == 0) lse[static_cast<size_t>(bh) * Sq + qi] = m + logf(denom);
}

template <typename E, int D>
void launch(const void* q, const void* k, const void* v, const int* kv_lens, const int* seg_ids,
            const int* seg_ranges, void* o, float* lse, int B, int H, int Sq, int Sk, int seg_stride,
            int causal, float sm_scale, cudaStream_t stream) {
  using T = typename E::T;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<E, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_lens, seg_ids,
      seg_ranges, static_cast<T*>(o), lse, H, Sq, Sk, seg_stride, causal, sm_scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_lens, seg_ids (with seg_ranges and
// seg_stride) and lse may be null; with seg_ids, kv_lens must be given.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype/head_dim, which the Python wrapper rejects first).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_lens,
                         const void* seg_ids, const void* seg_ranges, void* o, void* lse, int B, int H,
                         int Sq, int Sk, int D, int seg_stride, int dtype, int causal, float sm_scale,
                         void* stream) {
  const int* lens = static_cast<const int*>(kv_lens);
  const int* ids = static_cast<const int*>(seg_ids);
  const int* ranges = static_cast<const int*>(seg_ranges);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids != nullptr && (ranges == nullptr || lens == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64) {
    launch<uml::F32, 64>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else if (dtype == 0 && D == 128) {
    launch<uml::F32, 128>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else if (dtype == 1 && D == 64) {
    launch<uml::BF16, 64>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else if (dtype == 1 && D == 128) {
    launch<uml::BF16, 128>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
