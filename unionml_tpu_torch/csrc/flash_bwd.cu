// K2 and K3: blocked attention backward (flash-attention-2 style), with the
// probabilities recomputed from the forward's logsumexp.
//
// K2 `flash_bwd_dq` replaces the Pallas kernel `_bwd_dq_kernel` and K3
// `flash_bwd_dkv` replaces `_bwd_dkv_kernel`, both launched by
// `_flash_backward` in unionml_tpu/ops/attention.py. Same function, per
// (batch, head), with qs = q * sm_scale and s = qs k^T:
//   P  = exp(s - lse) where key j is visible to query i, exactly 0 elsewhere
//   dS = P * (dO v^T - delta),   delta_i = rowsum(dO_i * O_i) (given, f32)
//   dQ = sm_scale * dS k    (K2)
//   dK = dS^T qs,  dV = P^T dO    (K3)
// A key is visible when j < kv_len (right padding) and, under causal
// (top-left aligned), j <= i. f32 accumulation, outputs in the inputs' dtype.
// A masked entry contributes exactly 0 through a select, never a multiply, so
// an lse of -1e30 (a row that saw no key) or garbage cannot leak in. Padded
// query rows (i past kv_len) still see the valid keys and get their dQ, as in
// the JAX kernels.
//
// What bounds them on the H100: K2 does 6*D flops and K3 8*D flops per
// visible (query, key) pair against ~(q + k + v + 2 dO) bytes; at the BERT
// fine-tune shape (S 128, D 64, bf16) that is ~80 flops per byte, above the card's
// memory ridge for CUDA-core f32 (67 TFLOP/s / 3.35 TB/s = 20 flops per byte)
// and below the tensor cores' (295). Products run on the CUDA cores here, so
// their f32 FMA rate, and latency at this occupancy, bound both kernels.
//
// Design, simple and right first, the layout of K1 (flash_fwd.cu):
// - K2: one CTA of 128 threads per (batch*head, tile of 32 query rows); four
//   threads share a query row and hold a quarter of the head dim of qs, dO and
//   the dQ accumulator in registers (interleaved float4 columns, distinct
//   shared-memory banks). The CTA streams K/V tiles through shared memory as
//   f32; per key, two quad dot products (s and dO.v) are reduced by two warp
//   shuffles, two keys at a time (a wider step holds more shared-memory rows
//   in registers and spilled K3). The scan stops at min(kv_len, the tile's
//   causal diagonal).
// - K3: one CTA of 128 threads per (batch*head, tile of 32 key rows); four
//   threads share a key row and hold its quarter of k, v and the dK/dV
//   accumulators. The CTA streams qs/dO tiles and their lse/delta through
//   shared memory. Under causal the scan starts at the query tile holding the
//   tile's first key; a key tile wholly at or past kv_len scans nothing.
//   Outputs come from torch.empty, so every key row of the tile is written:
//   rows at or past kv_len, and skipped tiles, get exact zeros.
// Any Sq and Sk (ragged tiles masked, no fallback), bf16 or f32, head_dim 64
// or 128. Later work: mma.sync / wgmma tiles and cp.async/TMA staging.
//
// Segment-id (packed) mode, replacing the `packed=True` branches of
// `_bwd_dq_kernel` (attention.py:371-417) and `_bwd_dkv_kernel` (:439-502)
// with the block-skip maps `_flash_backward` builds from
// `_segment_block_bounds`: seg_ids is (B, seg_stride) int32, query ids its
// first Sq columns and key ids its first Sk; a key is visible to a query when
// j < kv_len, id_q[i] == id_k[j], id_q[i] > 0 and, under causal, j <= i (row
// positions, as in JAX); kv_len (the last nonzero key id's index + 1) comes
// through kv_lens. seg_ranges holds per position of the kernel's own axis the
// [first, end) that its id occupies on the other axis: (B, Sq, 2) key ranges
// for K2, (B, Sk, 2) query ranges for K3. Each CTA reduces them over its 32
// rows (a tile that straddles segments scans the union; the in-tile id test
// keeps unions and the supersets of ids that recur non-contiguously exact).
// - K2 scans only the key tiles inside [min first, max end) ∩ [0, kv_len) ∩
//   the causal limit. Padding query rows (id 0) get exact zeros.
// - K3 starts at max(the causal diagonal, min first) and stops at
//   min(Sq, max end); a key tile at or past kv_len scans nothing. The query
//   scan is never bounded by kv_len, which counts keys: the JAX kernel had
//   that bug and dropped dK/dV rows when Sq > Sk (:494-500). Keys no query
//   sees (padding, or a tile outside every range) get exact zeros.
// The work drops from O(S^2) to O(sum of seg_len^2) per row, as in K1.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // rows owned per CTA (queries in K2, keys in K3), four threads per row
constexpr int kChunk = 2;  // streamed rows per inner step: 8 (K1's) spilled K3 at
                           // 255 registers; 2 keeps D 64 spill-free (K3 158, K2 128 registers)

// the quad's dot product of a register quarter-row with a shared-memory row
// (float4 columns j*4 + quad), reduced across the four threads of the quad
template <int NV>
__device__ __forceinline__ float quad_dot(const float* reg, const float4* row, int quad) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 x = row[j * 4 + quad];
    part += reg[j * 4 + 0] * x.x + reg[j * 4 + 1] * x.y + reg[j * 4 + 2] * x.z + reg[j * 4 + 3] * x.w;
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

// acc += w * row, over the thread's quarter of the head dim
template <int NV>
__device__ __forceinline__ void quad_axpy(float* acc, float w, const float4* row, int quad) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 x = row[j * 4 + quad];
    acc[j * 4 + 0] += w * x.x;
    acc[j * 4 + 1] += w * x.y;
    acc[j * 4 + 2] += w * x.z;
    acc[j * 4 + 3] += w * x.w;
  }
}

// the thread's quarter of row `row` of a (rows, D) tensor, times `scale`
template <typename E, int D>
__device__ __forceinline__ void load_quarter(float* dst, const typename E::T* src, int quad, float scale) {
  constexpr int NV = D / 16;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[j * 4 + e] = E::load(src[(j * 4 + quad) * 4 + e]) * scale;
  }
}

template <typename E, int D>
__device__ __forceinline__ void store_quarter(typename E::T* dst, const float* src, int quad, float scale) {
  constexpr int NV = D / 16;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(j * 4 + quad) * 4 + e] = E::store(src[j * 4 + e] * scale);
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const typename E::T* __restrict__ q, const typename E::T* __restrict__ k,
    const typename E::T* __restrict__ v, const typename E::T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ kv_lens,
    const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges, typename E::T* __restrict__ dq,
    int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale) {
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
  const int q0 = static_cast<int>(blockIdx.x) * kRows;
  const int qi = q0 + (tid >> 2);
  const bool q_live = qi < Sq;
  const bool packed = seg_ids != nullptr;

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(Sk, max(kv_lens[b], 0));
  int n_keys = kv_len;
  if (causal) n_keys = min(n_keys, min(q0 + kRows, Sq));
  int k_begin = 0;
  int qid = 0;
  const int* ids_b = packed ? seg_ids + static_cast<size_t>(b) * seg_stride : nullptr;
  if (packed) {
    uml::reduce_tile_range(seg_ranges + static_cast<size_t>(b) * Sq * 2, q0, Sq, Sk, scan_range);
    k_begin = scan_range[0];
    n_keys = min(n_keys, scan_range[1]);
    qid = q_live ? ids_b[qi] : 0;
  }

  const size_t row = static_cast<size_t>(bh) * Sq + (q_live ? qi : 0);
  float qr[DT], dor[DT], acc[DT];
  load_quarter<E, D>(qr, q + row * D, quad, sm_scale);
  load_quarter<E, D>(dor, dout + row * D, quad, 1.f);
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0.f;
  const float row_lse = q_live ? lse[row] : 0.f;
  const float row_delta = q_live ? delta[row] : 0.f;

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

    // the first step that can hold a key at or past k_begin (CTA-uniform)
    const int c_begin = k0 < k_begin ? ((k_begin - k0) / kChunk) * kChunk : 0;
#pragma unroll 1
    for (int c = c_begin; c < BK; c += kChunk) {
      if (k0 + c >= n_keys) break;  // CTA-uniform: the rest of the tile is masked
      float ds[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float s = quad_dot<NV>(qr, k_tile + (c + u) * (D / 4), quad);
        const float dp = quad_dot<NV>(dor, v_tile + (c + u) * (D / 4), quad);
        const int key = k0 + c + u;
        const bool ok = q_live && key < kv_len && (!causal || key <= qi) &&
                        (!packed || (qid > 0 && k_ids[c + u] == qid));
        const float p = ok ? expf(s - row_lse) : 0.f;
        ds[u] = ok ? p * (dp - row_delta) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) quad_axpy<NV>(acc, ds[u], k_tile + (c + u) * (D / 4), quad);
    }
  }

  if (!q_live) return;
  store_quarter<E, D>(dq + row * D, acc, quad, sm_scale);
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const typename E::T* __restrict__ q, const typename E::T* __restrict__ k,
    const typename E::T* __restrict__ v, const typename E::T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ kv_lens,
    const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges, typename E::T* __restrict__ dk,
    typename E::T* __restrict__ dv, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale) {
  constexpr int BQ = D == 64 ? 64 : 32;  // queries per shared-memory tile (16 KB each of qs and dO)
  constexpr int NV = D / 16;
  constexpr int DT = NV * 4;
  __shared__ float4 q_tile[BQ * D / 4];  // q * sm_scale
  __shared__ float4 do_tile[BQ * D / 4];
  __shared__ float lse_tile[BQ];
  __shared__ float delta_tile[BQ];
  __shared__ int q_ids[BQ];
  __shared__ int scan_range[2];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int quad = tid & 3;
  const int k0 = static_cast<int>(blockIdx.x) * kRows;
  const int kj = k0 + (tid >> 2);
  const bool k_live = kj < Sk;
  const bool packed = seg_ids != nullptr;

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(Sk, max(kv_lens[b], 0));
  // query i sees key j only if i >= j under causal; a tile wholly at or past
  // kv_len sees no query at all
  int q_begin = causal ? min(k0, Sq) : 0;
  int q_end = k0 < kv_len ? Sq : 0;
  int kid = 0;
  const int* ids_b = packed ? seg_ids + static_cast<size_t>(b) * seg_stride : nullptr;
  if (packed) {
    // the transposed map: the query range of the tile's key ids, in query units
    uml::reduce_tile_range(seg_ranges + static_cast<size_t>(b) * Sk * 2, k0, Sk, Sq, scan_range);
    q_begin = max(q_begin, scan_range[0]);
    q_end = min(q_end, scan_range[1]);
    kid = k_live ? ids_b[kj] : 0;
  }

  const size_t row = static_cast<size_t>(bh) * Sk + (k_live ? kj : 0);
  float kr[DT], vr[DT], dk_acc[DT], dv_acc[DT];
  load_quarter<E, D>(kr, k + row * D, quad, 1.f);
  load_quarter<E, D>(vr, v + row * D, quad, 1.f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const typename E::T* q_bh = q + static_cast<size_t>(bh) * Sq * D;
  const typename E::T* do_bh = dout + static_cast<size_t>(bh) * Sq * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * Sq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * Sq;
  float* q_flat = reinterpret_cast<float*>(q_tile);
  float* do_flat = reinterpret_cast<float*>(do_tile);

  for (int t0 = (q_begin / BQ) * BQ; t0 < q_end; t0 += BQ) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BQ * D; idx += kThreads) {
      const int qrow = t0 + idx / D;
      const bool in = qrow < Sq;
      const size_t src = static_cast<size_t>(qrow) * D + (idx % D);
      q_flat[idx] = in ? E::load(q_bh[src]) * sm_scale : 0.f;
      do_flat[idx] = in ? E::load(do_bh[src]) : 0.f;
    }
    if (tid < BQ) {
      const bool in = t0 + tid < Sq;
      lse_tile[tid] = in ? lse_bh[t0 + tid] : 0.f;
      delta_tile[tid] = in ? delta_bh[t0 + tid] : 0.f;
      if (packed) q_ids[tid] = in ? ids_b[t0 + tid] : 0;
    }
    __syncthreads();

    // the first step that can hold a query at or past q_begin (CTA-uniform)
    const int c_begin = t0 < q_begin ? ((q_begin - t0) / kChunk) * kChunk : 0;
#pragma unroll 1
    for (int c = c_begin; c < BQ; c += kChunk) {
      if (t0 + c >= q_end) break;  // CTA-uniform: the rest of the tile is past Sq
      float p[kChunk], ds[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float s = quad_dot<NV>(kr, q_tile + (c + u) * (D / 4), quad);
        const float dp = quad_dot<NV>(vr, do_tile + (c + u) * (D / 4), quad);
        const int qi = t0 + c + u;
        const bool ok = qi < Sq && kj < kv_len && (!causal || qi >= kj) &&
                        (!packed || (kid > 0 && q_ids[c + u] == kid));
        p[u] = ok ? expf(s - lse_tile[c + u]) : 0.f;
        ds[u] = ok ? p[u] * (dp - delta_tile[c + u]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        quad_axpy<NV>(dv_acc, p[u], do_tile + (c + u) * (D / 4), quad);
        quad_axpy<NV>(dk_acc, ds[u], q_tile + (c + u) * (D / 4), quad);
      }
    }
  }

  if (!k_live) return;
  store_quarter<E, D>(dk + row * D, dk_acc, quad, 1.f);
  store_quarter<E, D>(dv + row * D, dv_acc, quad, 1.f);
}

template <typename E, int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kv_lens, const int* seg_ids, const int* seg_ranges, void* dq,
               int B, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale, cudaStream_t stream) {
  using T = typename E::T;
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<E, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kv_lens, seg_ids, seg_ranges, static_cast<T*>(dq), H, Sq, Sk,
      seg_stride, causal, sm_scale);
}

template <typename E, int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, const int* kv_lens, const int* seg_ids, const int* seg_ranges, void* dk,
                void* dv, int B, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale,
                cudaStream_t stream) {
  using T = typename E::T;
  const dim3 grid((Sk + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<E, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kv_lens, seg_ids, seg_ranges, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, seg_stride, causal, sm_scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse and delta are float32 (B, H, Sq);
// kv_lens (int32, (B,)) may be null; seg_ids ((B, seg_stride) int32) may be
// null, and with it kv_lens and seg_ranges must be given ((B, Sq, 2) for
// flash_bwd_dq, (B, Sk, 2) for flash_bwd_dkv). Sq, Sk and B*H must be positive.
// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue for
// an unsupported dtype/head_dim, which the Python wrapper rejects first).
#define UML_BWD_DISPATCH(LAUNCH, ...)                                  \
  if (seg_ids != nullptr && (seg_ranges == nullptr || kv_lens == nullptr)) \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  if (dtype == 0 && D == 64) {                                         \
    LAUNCH<uml::F32, 64>(__VA_ARGS__);                                 \
  } else if (dtype == 0 && D == 128) {                                 \
    LAUNCH<uml::F32, 128>(__VA_ARGS__);                                \
  } else if (dtype == 1 && D == 64) {                                  \
    LAUNCH<uml::BF16, 64>(__VA_ARGS__);                                \
  } else if (dtype == 1 && D == 128) {                                 \
    LAUNCH<uml::BF16, 128>(__VA_ARGS__);                               \
  } else {                                                             \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  }                                                                    \
  return static_cast<int>(cudaGetLastError());

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* kv_lens, const void* seg_ids,
                            const void* seg_ranges, void* dq, int B, int H, int Sq, int Sk, int D,
                            int seg_stride, int dtype, int causal, float sm_scale, void* stream) {
  UML_BWD_DISPATCH(launch_dq, q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<const int*>(kv_lens), static_cast<const int*>(seg_ids),
                   static_cast<const int*>(seg_ranges), dq, B, H, Sq, Sk, seg_stride, causal, sm_scale,
                   static_cast<cudaStream_t>(stream))
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kv_lens, const void* seg_ids,
                             const void* seg_ranges, void* dk, void* dv, int B, int H, int Sq, int Sk,
                             int D, int seg_stride, int dtype, int causal, float sm_scale, void* stream) {
  UML_BWD_DISPATCH(launch_dkv, q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                   static_cast<const int*>(kv_lens), static_cast<const int*>(seg_ids),
                   static_cast<const int*>(seg_ranges), dk, dv, B, H, Sq, Sk, seg_stride, causal, sm_scale,
                   static_cast<cudaStream_t>(stream))
}
