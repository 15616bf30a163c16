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
// the JAX kernels. Outputs come from torch.empty, so every row is written:
// keys at or past kv_len, and rows whose tiles are all skipped, get exact
// zeros.
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
// for K2, (B, Sk, 2) query ranges for K3 (for self-attention one tensor, K1's
// own map). Each CTA reduces them over its rows (a tile that straddles
// segments scans the union; the in-tile id test keeps unions and the
// supersets of ids that recur non-contiguously exact).
// - K2 scans only the key tiles inside [min first, max end) ∩ [0, kv_len) ∩
//   the causal limit. Padding query rows (id 0) get exact zeros.
// - K3 starts at max(the causal diagonal, min first) and stops at
//   min(Sq, max end); a key tile at or past kv_len scans nothing. The query
//   scan is never bounded by kv_len, which counts keys: the JAX kernel had
//   that bug and dropped dK/dV rows when Sq > Sk (:494-500). Keys no query
//   sees (padding, or a tile outside every range) get exact zeros.
// The work drops from O(S^2) to O(sum of seg_len^2) per row, as in K1.
//
// Two bodies per kernel behind one entry point, chosen by dtype (not a
// fallback: each dtype always takes its own body, and a call the chosen body
// cannot take returns an error that the wrapper raises):
//
// bf16 -> flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel, the
// tensor-core bodies. What bounds them on the H100: K2 does 6*D flops and K3
// 8*D flops per visible (query, key) pair against q, k, v, dO read once and
// dQ (K2) or dK, dV (K3) written once. At the main path's shapes (BERT B64
// H12 S128 with kv_lens; packed LM B8 H12 S1024 causal, segments of ~250
// tokens) that is 40-130 flops per byte, below the card's bf16 ridge (~295
// flops per byte), so the bound is bytes (~0.02 ms at both shapes); only
// causal rows of more than ~1k keys at D 64 are bounded by operations.
// Reaching either needs the products on the tensor cores and loads that
// overlap them. Design (Hopper), on K1's building blocks (common.cuh):
//   - one CTA per (batch*head, tile of own rows): queries for K2 (128 rows,
//     two consumer warpgroups of 64), keys for K3 (128 rows and two
//     warpgroups at D 64; 64 rows and one warpgroup at D 128, where the dK
//     and dV accumulators take 128 of a thread's registers), and one
//     producer warp;
//   - TMA (3-D tensor maps over (D, S, batch*head), 128-byte swizzle, zero
//     fill past S) stages the own rows' two tiles once (K2: Q and dO; K3: K
//     and V) and streams the other axis in 64-row bf16 tiles (K2: K and V;
//     K3: Q and dO, with the 64 queries' lse, delta and ids written by the
//     producer's lanes) through a two-stage ring behind full/empty
//     mbarriers, so the next tile's copy is in flight while the current one
//     computes and no __syncthreads sits in the loop;
//   - K2 per K/V tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16 (both
//     operands K-major as stored), P = exp2(S scale log2e - lse log2e) and
//     dS = P (dP - delta) on the accumulator fragments, then dQ += dS K by
//     wgmma with dS in registers as the A operand (the accumulator fragment
//     is the A fragment register for register, as P is in K1) and K the
//     MN-major B operand through the transpose bit; dQ is scaled and
//     rounded to bf16 once at the end;
//   - K3 per Q/dO tile, in transposed form so that a warpgroup's accumulator
//     rows are its own keys: S^T = K Q^T and dP^T = V dO^T, P^T with each
//     column's lse from shared memory, dV += P^T dO and dK += dS^T Q with dO
//     and Q MN-major; dK is scaled at the end;
//   - dS enters its products (dQ in K2, dK in K3) as bf16 rounded once; P
//     enters K3's dV = P^T dO as two bf16 parts, hi = bf16(p) and
//     lo = bf16(p - hi), two products, as in K1's P V: with one rounding, dV
//     missed chip_smoke's bf16 check (atol 2e-2 + rtol 2e-2 against the f32
//     plain backward) at the BERT shape, where a short row's few keys each
//     sum up to 128 rounded weights, in 3 of 10 input seeds against none for
//     the two parts, which cost K3 5-8 % (H100 80GB HBM3, 700 W);
//   - masks only on tiles that need them: a warp applies the kv_len, causal
//     and segment-id masks to its fragments only when the tile straddles
//     kv_len or the diagonal for its 16 rows, or its rows and the tile's
//     streamed rows do not all carry one id (a warp vote);
//   - the packed skip map is reduced over 64-row groups (reduce_tile_ranges)
//     per warpgroup and over the CTA's rows for the loads;
//   - heaviest tiles first: without ids K2's first CTAs take the last query
//     tiles and K3's the first key tiles (the longest causal scans); with
//     ids the wrapper passes a work order (tiles by descending scan length)
//     after the skip map.
//
// f32 -> flash_bwd_dq_kernel and flash_bwd_dkv_kernel, the CUDA-core bodies
// of the first port: a product of f32 inputs on the tensor cores would be
// TF32 (about three decimal digits), too coarse for the f32 checks (1e-4
// gradients). Products are f32 FMA, bound by the CUDA cores' rate and by
// latency at this occupancy:
// - K2: one CTA of 128 threads per (batch*head, tile of 32 query rows); four
//   threads share a query row and hold a quarter of the head dim of qs, dO and
//   the dQ accumulator in registers (interleaved float4 columns, distinct
//   shared-memory banks). The CTA streams K/V tiles through shared memory;
//   per key, two quad dot products (s and dO.v) are reduced by two warp
//   shuffles, two keys at a time (a wider step holds more shared-memory rows
//   in registers and spilled K3). The scan stops at min(kv_len, the tile's
//   causal diagonal).
// - K3: one CTA of 128 threads per (batch*head, tile of 32 key rows); four
//   threads share a key row and hold its quarter of k, v and the dK/dV
//   accumulators. The CTA streams qs/dO tiles and their lse/delta through
//   shared memory. Under causal the scan starts at the query tile holding the
//   tile's first key.
//
// All bodies take any Sq and Sk (the ragged tiles are masked), head_dim 64 or
// 128.

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
template <int D>
__device__ __forceinline__ void load_quarter(float* dst, const float* src, int quad, float scale) {
  constexpr int NV = D / 16;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[j * 4 + e] = src[(j * 4 + quad) * 4 + e] * scale;
  }
}

template <int D>
__device__ __forceinline__ void store_quarter(float* dst, const float* src, int quad, float scale) {
  constexpr int NV = D / 16;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(j * 4 + quad) * 4 + e] = src[j * 4 + e] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ kv_lens,
    const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges, float* __restrict__ dq,
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
  load_quarter<D>(qr, q + row * D, quad, sm_scale);
  load_quarter<D>(dor, dout + row * D, quad, 1.f);
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0.f;
  const float row_lse = q_live ? lse[row] : 0.f;
  const float row_delta = q_live ? delta[row] : 0.f;

  const float* k_bh = k + static_cast<size_t>(bh) * Sk * D;
  const float* v_bh = v + static_cast<size_t>(bh) * Sk * D;
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
      k_flat[idx] = in ? k_bh[src] : 0.f;
      v_flat[idx] = in ? v_bh[src] : 0.f;
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
  store_quarter<D>(dq + row * D, acc, quad, sm_scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ kv_lens,
    const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale) {
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
  load_quarter<D>(kr, k + row * D, quad, 1.f);
  load_quarter<D>(vr, v + row * D, quad, 1.f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const float* q_bh = q + static_cast<size_t>(bh) * Sq * D;
  const float* do_bh = dout + static_cast<size_t>(bh) * Sq * D;
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
      q_flat[idx] = in ? q_bh[src] * sm_scale : 0.f;
      do_flat[idx] = in ? do_bh[src] : 0.f;
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
  store_quarter<D>(dk + row * D, dk_acc, quad, 1.f);
  store_quarter<D>(dv + row * D, dv_acc, quad, 1.f);
}

template <int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kv_lens, const int* seg_ids, const int* seg_ranges, void* dq,
               int B, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, kv_lens, seg_ids, seg_ranges, static_cast<float*>(dq), H, Sq,
      Sk, seg_stride, causal, sm_scale);
}

template <int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, const int* kv_lens, const int* seg_ids, const int* seg_ranges, void* dk,
                void* dv, int B, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale,
                cudaStream_t stream) {
  const dim3 grid((Sk + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, kv_lens, seg_ids, seg_ranges, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Sq, Sk, seg_stride, causal, sm_scale);
}


// ------------------------------------------------------ bf16: tensor cores

constexpr int kBN = 64;          // streamed rows per ring tile (keys in K2, queries in K3)
constexpr int kStages = 2;       // ring depth
constexpr float kLog2e = 1.4426950408889634f;

// consumer warpgroups per CTA (64 owned rows each) and the CTA's owned rows:
// K2 takes two at both head dims; K3 holds two f32 accumulators of D columns
// per row, so at D 128 it takes one warpgroup to stay within 255 registers
template <int D>
struct DqShape {
  static constexpr int kWG = 2, kBM = 64 * kWG, kThreads = 128 * kWG + 32;
};
template <int D>
struct DkvShape {
  static constexpr int kWG = D == 64 ? 2 : 1, kBM = 64 * kWG, kThreads = 128 * kWG + 32;
};

// Shared-memory layout of both bodies (byte offsets from a 1024-byte aligned
// base; every tile stored as blocks of 64 columns, 128-byte rows, 128-byte
// swizzle): two tiles of the CTA's own kBM rows held for the whole CTA (K2: Q
// and dO; K3: K and V), a ring of kStages pairs of kBN-row tiles (K2: K and V;
// K3: Q and dO) with per-row ints of the streamed axis (K2: key ids; K3: the
// queries' lse in log2 units, delta and ids), the scan ranges of the own
// rows, and the mbarriers.
template <int D, int BM, int Cols>
struct BwdSmem {
  static constexpr int kOwnA = 0;                             // [D/64][BM][64]
  static constexpr int kOwnB = kOwnA + BM * D * 2;            // [D/64][BM][64]
  static constexpr int kTile = kBN * D * 2;                   // one streamed tile: [D/64][kBN][64]
  static constexpr int kRing = kOwnB + BM * D * 2;            // stage s: first tile at kRing + 2 s kTile
  static constexpr int kCols = kRing + kStages * 2 * kTile;   // [kStages][Cols][kBN] 32-bit words
  static constexpr int kRanges = kCols + kStages * Cols * kBN * 4;  // [BM / 32][2] scan ranges
  static constexpr int kBars = kRanges + BM / 32 * 2 * 4;     // full[kStages], empty[kStages], own
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;                // slack to align the base
};

// the fragment's column of accumulator entry j (64 x 64 tile): the thread's
// rows are row0 (j & 2 == 0) and row0 + 8
__device__ __forceinline__ int frag_col(int j, int tq) { return (j / 4) * 8 + 2 * tq + (j & 1); }

// d (+)= A B over a 64-row streamed tile, A in registers (four k16 steps of
// the m64k16 fragment) and B the tile MN-major (its rows are the product's K)
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[D / 2], const uint32_t (&a)[16], const uint8_t* tile) {
#pragma unroll
  for (int ks = 0; ks < kBN / 16; ++ks) {
    const uint32_t frag[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3]};
    // 16 rows of 128 bytes per step, the next 64 columns kBN rows further on
    const uint64_t desc = uml::sw128_desc(tile + ks * 16 * 128, kBN * 128, 1024);
    if constexpr (D == 64) {
      uml::wgmma_rs_m64n64<1>(d, frag, desc, 1);
    } else {
      uml::wgmma_rs_m64n128<1>(d, frag, desc, 1);
    }
  }
}

// d = A B^T (64 x 64, f32): A the warpgroup's 64 own rows (a block of 64 rows
// in an own tile of BM rows), B a 64-row streamed tile, both K-major over D
template <int D, int BM>
__device__ __forceinline__ void wgmma_ss_scores(float (&d)[32], const uint8_t* own, const uint8_t* tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uml::wgmma_ss_m64n64<0>(d, uml::sw128_desc(own + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024),
                            uml::sw128_desc(tile + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024),
                            kk > 0 ? 1 : 0);
  }
}

// K2 (dQ), bf16: see the header note
template <int D>
__global__ void __launch_bounds__(DqShape<D>::kThreads, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ kv_lens,
    const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges, const int* __restrict__ order,
    uint16_t* __restrict__ dq, int BH, int H, int Sq, int Sk, int seg_stride, int n_mt, int causal,
    float sm_scale) {
  constexpr int kWG = DqShape<D>::kWG, kBM = DqShape<D>::kBM;
  using L = BwdSmem<D, kBM, 1>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (uml::smem_u32(smem_raw) & 1023u)) & 1023u);
  int* ranges_s = reinterpret_cast<int*>(smem + L::kRanges);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own_bar = empty + kStages;

  // the work item: heaviest query tiles first (see the header note)
  const int idx = static_cast<int>(blockIdx.x);
  int bh, m;
  if (order != nullptr) {
    const int tile = order[idx / H];
    bh = (tile / n_mt) * H + idx % H;
    m = tile % n_mt;
  } else {
    bh = idx % BH;
    m = n_mt - 1 - idx / BH;
  }
  const int b = bh / H;
  const int q0 = m * kBM;
  const bool packed = seg_ids != nullptr;
  const int* ids_b = packed ? seg_ids + static_cast<size_t>(b) * seg_stride : nullptr;
  if (packed) uml::reduce_tile_ranges<kBM / 32>(seg_ranges + static_cast<size_t>(b) * Sq * 2, q0, Sq, Sk, ranges_s);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      uml::mbar_init(&full[s], 32);          // the producer warp's lanes
      uml::mbar_init(&empty[s], 128 * kWG);  // every consumer thread
    }
    uml::mbar_init(own_bar, 1);
    uml::mbar_fence_init();
  }
  __syncthreads();

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(Sk, max(kv_lens[b], 0));
  // the CTA's key scan [lo, end), and its tiles [t0, t0 + n_t)
  int lo = 0, end = kv_len;
  if (causal) end = min(end, min(q0 + kBM, Sq));
  if (packed) {
    int hi = 0;
    lo = Sk;
#pragma unroll
    for (int g = 0; g < kBM / 32; ++g) {
      lo = min(lo, ranges_s[2 * g]);
      hi = max(hi, ranges_s[2 * g + 1]);
    }
    end = min(end, hi);
  }
  const int t0 = lo / kBN;
  const int n_t = end > lo ? (end + kBN - 1) / kBN - t0 : 0;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) & 31;

  if (warp == 4 * kWG) {  // producer: Q and dO once, then the K/V ring
    if (lane == 0 && n_t > 0) {
      uml::mbar_arrive_expect_tx(own_bar, 2 * kBM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        uml::tma_load_3d(smem + L::kOwnA + c * kBM * 128, &tm_q, own_bar, c * 64, q0, bh);
        uml::tma_load_3d(smem + L::kOwnB + c * kBM * 128, &tm_do, own_bar, c * 64, q0, bh);
      }
    }
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kStages;
      const int k0 = (t0 + i) * kBN;
      uml::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (packed) {
        int* ids_s = reinterpret_cast<int*>(smem + L::kCols) + s * kBN;
        for (int j = lane; j < kBN; j += 32) ids_s[j] = k0 + j < Sk ? ids_b[k0 + j] : 0;
      }
      if (lane == 0) {
        uint8_t* kt = smem + L::kRing + s * 2 * L::kTile;
        uml::mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          uml::tma_load_3d(kt + c * kBN * 128, &tm_k, &full[s], c * 64, k0, bh);
          uml::tma_load_3d(kt + L::kTile + c * kBN * 128, &tm_v, &full[s], c * 64, k0, bh);
        }
      } else {
        uml::mbar_arrive(&full[s]);  // releases this lane's key ids
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0w .. q0w + 63; this warp rows
  // rw .. rw + 15; this thread rows row0 = rw + lane / 4 and row1 = row0 + 8
  const int wg = warp / 4;
  const int q0w = q0 + wg * 64;
  const int rw = q0w + (warp % 4) * 16;
  const int tq = lane & 3;
  const int row0 = rw + (lane >> 2), row1 = row0 + 8;
  int w_lo = 0, w_end = kv_len;  // the warpgroup's own scan
  if (causal) w_end = min(w_end, min(q0w + 64, Sq));
  if (packed) {
    w_lo = min(ranges_s[4 * wg], ranges_s[4 * wg + 2]);
    w_end = min(w_end, max(ranges_s[4 * wg + 1], ranges_s[4 * wg + 3]));
  }
  const int qid0 = packed && row0 < Sq ? ids_b[row0] : 0;
  const int qid1 = packed && row1 < Sq ? ids_b[row1] : 0;
  // rows past Sq: lse and delta 0 with Q and dO zero-filled by TMA give dS = 0
  const size_t base = static_cast<size_t>(bh) * Sq;
  const float lse0 = row0 < Sq ? lse[base + row0] * kLog2e : 0.f;
  const float lse1 = row1 < Sq ? lse[base + row1] * kLog2e : 0.f;
  const float dl0 = row0 < Sq ? delta[base + row0] : 0.f;
  const float dl1 = row1 < Sq ? delta[base + row1] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    sc[j] = 0.f;
    dp[j] = 0.f;
  }
  const float c2 = sm_scale * kLog2e;  // raw score -> log2 units
  const uint8_t* q_w = smem + L::kOwnA + wg * 64 * 128;
  const uint8_t* do_w = smem + L::kOwnB + wg * 64 * 128;
  if (n_t > 0) uml::mbar_wait(own_bar, 0);

  for (int i = 0; i < n_t; ++i) {
    const int s = i % kStages;
    const int k0 = (t0 + i) * kBN;
    uml::mbar_wait(&full[s], (i / kStages) & 1);
    if (k0 + kBN > w_lo && k0 < w_end) {  // warpgroup-uniform: the tile meets this warpgroup's scan
      const uint8_t* kt = smem + L::kRing + s * 2 * L::kTile;
      const uint8_t* vt = kt + L::kTile;
      const int* kid = reinterpret_cast<const int*>(smem + L::kCols) + s * kBN;

      // S = Q K^T and dP = dO V^T, one commit group
      uml::wgmma_fence();
      wgmma_ss_scores<D, kBM>(sc, q_w, kt);
      wgmma_ss_scores<D, kBM>(dp, do_w, vt);
      uml::wgmma_commit();
      uml::wgmma_wait<0>();

      // masks only where the tile straddles kv_len, the diagonal or an id boundary for this warp's rows
      bool need = k0 + kBN > kv_len || (causal && k0 + kBN - 1 > rw);  // warp-uniform
      if (packed && !need) {
        bool same = qid0 > 0 && qid1 == qid0;
#pragma unroll
        for (int c = 0; c < 8; ++c) same = same && kid[c * 8 + 2 * tq] == qid0 && kid[c * 8 + 2 * tq + 1] == qid0;
        need = !__all_sync(0xffffffffu, same);
      }
      // P = exp(S scale - lse), exactly 0 where masked (a select); dS = P (dP - delta),
      // rounded once to bf16 as the A fragments of the four 16-key steps
      uint32_t ds[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const bool r1 = j & 2;
        const float l2 = r1 ? lse1 : lse0, dl = r1 ? dl1 : dl0;
        float p0 = exp2f(fmaf(sc[j], c2, -l2)), p1 = exp2f(fmaf(sc[j + 1], c2, -l2));
        if (need) {
          const int row = r1 ? row1 : row0;
          const int qid = r1 ? qid1 : qid0;
          const int col = frag_col(j, tq);
          const int key = k0 + col;
          const bool ok0 = key < kv_len && (!causal || key <= row) && (!packed || (qid > 0 && kid[col] == qid));
          const bool ok1 =
              key + 1 < kv_len && (!causal || key + 1 <= row) && (!packed || (qid > 0 && kid[col + 1] == qid));
          p0 = ok0 ? p0 : 0.f;
          p1 = ok1 ? p1 : 0.f;
        }
        ds[j / 2] = uml::pack_bf16x2(p0 * (dp[j] - dl), p1 * (dp[j + 1] - dl));
      }

      // dQ += dS K, K the MN-major B operand
      uml::wgmma_fence();
      wgmma_rs_tile<D>(acc, ds, kt);
      uml::wgmma_commit();
      uml::wgmma_wait<0>();
    }
    uml::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Sq) continue;
    uint16_t* out = dq + (base + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(out + c * 8 + 2 * tq) =
          uml::pack_bf16x2(acc[4 * c + 2 * r] * sm_scale, acc[4 * c + 2 * r + 1] * sm_scale);
    }
  }
}

// K3 (dK, dV), bf16: see the header note
template <int D>
__global__ void __launch_bounds__(DkvShape<D>::kThreads, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ kv_lens,
    const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges, const int* __restrict__ order,
    uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int BH, int H, int Sq, int Sk, int seg_stride, int n_nt,
    int causal, float sm_scale) {
  constexpr int kWG = DkvShape<D>::kWG, kBM = DkvShape<D>::kBM;
  using L = BwdSmem<D, kBM, 3>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (uml::smem_u32(smem_raw) & 1023u)) & 1023u);
  int* ranges_s = reinterpret_cast<int*>(smem + L::kRanges);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* own_bar = empty + kStages;

  // the work item: heaviest key tiles first (see the header note)
  const int idx = static_cast<int>(blockIdx.x);
  int bh, n;
  if (order != nullptr) {
    const int tile = order[idx / H];
    bh = (tile / n_nt) * H + idx % H;
    n = tile % n_nt;
  } else {
    bh = idx % BH;
    n = idx / BH;
  }
  const int b = bh / H;
  const int k0 = n * kBM;
  const bool packed = seg_ids != nullptr;
  const int* ids_b = packed ? seg_ids + static_cast<size_t>(b) * seg_stride : nullptr;
  if (packed) uml::reduce_tile_ranges<kBM / 32>(seg_ranges + static_cast<size_t>(b) * Sk * 2, k0, Sk, Sq, ranges_s);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      uml::mbar_init(&full[s], 32);
      uml::mbar_init(&empty[s], 128 * kWG);
    }
    uml::mbar_init(own_bar, 1);
    uml::mbar_fence_init();
  }
  __syncthreads();

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(Sk, max(kv_lens[b], 0));
  // the CTA's query scan [lo, end): under causal from the first key on; a
  // key tile wholly at or past kv_len sees no query; never bounded by kv_len
  int lo = causal ? min(k0, Sq) : 0;
  int end = k0 < kv_len ? Sq : 0;
  if (packed) {
    int first = Sq, hi = 0;
#pragma unroll
    for (int g = 0; g < kBM / 32; ++g) {
      first = min(first, ranges_s[2 * g]);
      hi = max(hi, ranges_s[2 * g + 1]);
    }
    lo = max(lo, first);
    end = min(end, hi);
  }
  const int t0 = lo / kBN;
  const int n_t = end > lo ? (end + kBN - 1) / kBN - t0 : 0;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) & 31;

  if (warp == 4 * kWG) {  // producer: K and V once, then the Q/dO ring with lse, delta and ids
    if (lane == 0 && n_t > 0) {
      uml::mbar_arrive_expect_tx(own_bar, 2 * kBM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        uml::tma_load_3d(smem + L::kOwnA + c * kBM * 128, &tm_k, own_bar, c * 64, k0, bh);
        uml::tma_load_3d(smem + L::kOwnB + c * kBM * 128, &tm_v, own_bar, c * 64, k0, bh);
      }
    }
    const size_t base = static_cast<size_t>(bh) * Sq;
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kStages;
      const int q0 = (t0 + i) * kBN;
      uml::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      float* lse_s = reinterpret_cast<float*>(smem + L::kCols) + s * 3 * kBN;
      float* delta_s = lse_s + kBN;
      int* ids_s = reinterpret_cast<int*>(delta_s + kBN);
      // queries past Sq: lse and delta 0 with Q and dO zero-filled by TMA add exactly 0
      for (int j = lane; j < kBN; j += 32) {
        const bool in = q0 + j < Sq;
        lse_s[j] = in ? lse[base + q0 + j] * kLog2e : 0.f;
        delta_s[j] = in ? delta[base + q0 + j] : 0.f;
        if (packed) ids_s[j] = in ? ids_b[q0 + j] : 0;
      }
      if (lane == 0) {
        uint8_t* qt = smem + L::kRing + s * 2 * L::kTile;
        uml::mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          uml::tma_load_3d(qt + c * kBN * 128, &tm_q, &full[s], c * 64, q0, bh);
          uml::tma_load_3d(qt + L::kTile + c * kBN * 128, &tm_do, &full[s], c * 64, q0, bh);
        }
      } else {
        uml::mbar_arrive(&full[s]);  // releases this lane's columns
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0w .. k0w + 63; this warp keys rw ..
  // rw + 15; this thread keys row0 = rw + lane / 4 and row1 = row0 + 8 (the
  // rows of the transposed products Sᵀ, dPᵀ and of dK, dV)
  const int wg = warp / 4;
  const int k0w = k0 + wg * 64;
  const int rw = k0w + (warp % 4) * 16;
  const int tq = lane & 3;
  const int row0 = rw + (lane >> 2), row1 = row0 + 8;
  int w_lo = causal ? min(k0w, Sq) : 0;  // the warpgroup's own scan
  int w_end = k0w < kv_len ? Sq : 0;
  if (packed) {
    w_lo = max(w_lo, min(ranges_s[4 * wg], ranges_s[4 * wg + 2]));
    w_end = min(w_end, max(ranges_s[4 * wg + 1], ranges_s[4 * wg + 3]));
  }
  const int kid0 = packed && row0 < Sk ? ids_b[row0] : 0;
  const int kid1 = packed && row1 < Sk ? ids_b[row1] : 0;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    dk_acc[j] = 0.f;
    dv_acc[j] = 0.f;
  }
  float sc[32], dp[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    sc[j] = 0.f;
    dp[j] = 0.f;
  }
  const float c2 = sm_scale * kLog2e;
  const uint8_t* k_w = smem + L::kOwnA + wg * 64 * 128;
  const uint8_t* v_w = smem + L::kOwnB + wg * 64 * 128;
  if (n_t > 0) uml::mbar_wait(own_bar, 0);

  for (int i = 0; i < n_t; ++i) {
    const int s = i % kStages;
    const int q0 = (t0 + i) * kBN;
    uml::mbar_wait(&full[s], (i / kStages) & 1);
    if (q0 + kBN > w_lo && q0 < w_end) {  // warpgroup-uniform: the tile meets this warpgroup's scan
      const uint8_t* qt = smem + L::kRing + s * 2 * L::kTile;
      const uint8_t* dot = qt + L::kTile;
      const float* lse_s = reinterpret_cast<const float*>(smem + L::kCols) + s * 3 * kBN;
      const float* delta_s = lse_s + kBN;
      const int* qid = reinterpret_cast<const int*>(delta_s + kBN);

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, one commit group
      uml::wgmma_fence();
      wgmma_ss_scores<D, kBM>(sc, k_w, qt);
      wgmma_ss_scores<D, kBM>(dp, v_w, dot);
      uml::wgmma_commit();
      uml::wgmma_wait<0>();

      // masks only where this warp's keys straddle kv_len or the diagonal
      // (some query of the tile before some key), or an id boundary
      bool need = rw + 15 >= kv_len || (causal && q0 < rw + 15);  // warp-uniform
      if (packed && !need) {
        bool same = kid0 > 0 && kid1 == kid0;
#pragma unroll
        for (int c = 0; c < 8; ++c) same = same && qid[c * 8 + 2 * tq] == kid0 && qid[c * 8 + 2 * tq + 1] == kid0;
        need = !__all_sync(0xffffffffu, same);
      }
      // Pᵀ = exp(Sᵀ scale - lse of the column), exactly 0 where masked (a
      // select), as two bf16 parts hi = bf16(p) and lo = bf16(p - hi) (see
      // the header note); dSᵀ = Pᵀ (dPᵀ - delta of the column), rounded once;
      // the A fragments of the four 16-query steps
      uint32_t pa[16], pl[16], ds[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int col = frag_col(j, tq);
        float p0 = exp2f(fmaf(sc[j], c2, -lse_s[col])), p1 = exp2f(fmaf(sc[j + 1], c2, -lse_s[col + 1]));
        if (need) {
          const bool r1 = j & 2;
          const int key = r1 ? row1 : row0;
          const int kid = r1 ? kid1 : kid0;
          const int qi = q0 + col;
          const bool ok0 = key < kv_len && (!causal || qi >= key) && (!packed || (kid > 0 && qid[col] == kid));
          const bool ok1 =
              key < kv_len && (!causal || qi + 1 >= key) && (!packed || (kid > 0 && qid[col + 1] == kid));
          p0 = ok0 ? p0 : 0.f;
          p1 = ok1 ? p1 : 0.f;
        }
        pa[j / 2] = uml::pack_bf16x2(p0, p1);
        pl[j / 2] = uml::pack_bf16x2(p0 - uml::BF16::load(static_cast<uint16_t>(pa[j / 2] & 0xffffu)),
                                     p1 - uml::BF16::load(static_cast<uint16_t>(pa[j / 2] >> 16)));
        ds[j / 2] = uml::pack_bf16x2(p0 * (dp[j] - delta_s[col]), p1 * (dp[j + 1] - delta_s[col + 1]));
      }

      // dV += Pᵀ dO (both parts) and dK += dSᵀ Q, dO and Q the MN-major B operands
      uml::wgmma_fence();
      wgmma_rs_tile<D>(dv_acc, pa, dot);
      wgmma_rs_tile<D>(dv_acc, pl, dot);
      wgmma_rs_tile<D>(dk_acc, ds, qt);
      uml::wgmma_commit();
      uml::wgmma_wait<0>();
    }
    uml::mbar_arrive(&empty[s]);
  }

  // every key row < Sk is written: keys no query sees get exact zeros
  const size_t base = static_cast<size_t>(bh) * Sk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Sk) continue;
    uint16_t* dk_row = dk + (base + row) * D;
    uint16_t* dv_row = dv + (base + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dk_row + c * 8 + 2 * tq) =
          uml::pack_bf16x2(dk_acc[4 * c + 2 * r] * sm_scale, dk_acc[4 * c + 2 * r + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv_row + c * 8 + 2 * tq) =
          uml::pack_bf16x2(dv_acc[4 * c + 2 * r], dv_acc[4 * c + 2 * r + 1]);
    }
  }
}

// the four bf16 tensor maps of q, k, v and dO: the own axis's tiles take
// boxes of own_rows rows, the streamed axis's kBN rows; 0 or the reason there
// are none
int bwd_maps(CUtensorMap* tm, const void* q, const void* k, const void* v, const void* dout, int Sq, int Sk,
             int BH, int D, int q_rows, int k_rows) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(dout)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA reads 16-byte aligned tensors
  }
  const uml::EncodeTiled encode = uml::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (!uml::bf16_map(encode, &tm[0], q, Sq, BH, D, q_rows) || !uml::bf16_map(encode, &tm[1], k, Sk, BH, D, k_rows) ||
      !uml::bf16_map(encode, &tm[2], v, Sk, BH, D, k_rows) ||
      !uml::bf16_map(encode, &tm[3], dout, Sq, BH, D, q_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                    const float* delta, const int* kv_lens, const int* seg_ids, const int* seg_ranges, void* dq,
                    int B, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale, cudaStream_t stream) {
  using S = DqShape<D>;
  using L = BwdSmem<D, S::kBM, 1>;
  const int BH = B * H;
  CUtensorMap tm[4];
  const int maps = bwd_maps(tm, q, k, v, dout, Sq, Sk, BH, D, S::kBM, kBN);
  if (maps != 0) return maps;
  const int n_mt = (Sq + S::kBM - 1) / S::kBM;
  const long long n_ctas = static_cast<long long>(n_mt) * BH;
  if (n_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // with ids, the work order follows the (B, Sq, 2) ranges
  const int* order = seg_ids != nullptr ? seg_ranges + static_cast<size_t>(B) * Sq * 2 : nullptr;
  const cudaError_t attr = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_bwd_dq_wgmma_kernel<D><<<static_cast<unsigned>(n_ctas), S::kThreads, L::kAlloc, stream>>>(
      tm[0], tm[1], tm[2], tm[3], lse, delta, kv_lens, seg_ids, seg_ranges, order, static_cast<uint16_t*>(dq), BH,
      H, Sq, Sk, seg_stride, n_mt, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                     const float* delta, const int* kv_lens, const int* seg_ids, const int* seg_ranges, void* dk,
                     void* dv, int B, int H, int Sq, int Sk, int seg_stride, int causal, float sm_scale,
                     cudaStream_t stream) {
  using S = DkvShape<D>;
  using L = BwdSmem<D, S::kBM, 3>;
  if ((reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // the epilogue stores two bf16 per word
  }
  const int BH = B * H;
  CUtensorMap tm[4];
  const int maps = bwd_maps(tm, q, k, v, dout, Sq, Sk, BH, D, kBN, S::kBM);
  if (maps != 0) return maps;
  const int n_nt = (Sk + S::kBM - 1) / S::kBM;
  const long long n_ctas = static_cast<long long>(n_nt) * BH;
  if (n_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // with ids, the work order follows the (B, Sk, 2) ranges
  const int* order = seg_ids != nullptr ? seg_ranges + static_cast<size_t>(B) * Sk * 2 : nullptr;
  const cudaError_t attr = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_bwd_dkv_wgmma_kernel<D><<<static_cast<unsigned>(n_ctas), S::kThreads, L::kAlloc, stream>>>(
      tm[0], tm[1], tm[2], tm[3], lse, delta, kv_lens, seg_ids, seg_ranges, order, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), BH, H, Sq, Sk, seg_stride, n_nt, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core bodies), 1 = bfloat16 (the tensor-core
// bodies); lse and delta are float32 (B, H, Sq); kv_lens (int32, (B,)) may be
// null; seg_ids ((B, seg_stride) int32) may be null, and with it kv_lens and
// seg_ranges must be given ((B, Sq, 2) for flash_bwd_dq, (B, Sk, 2) for
// flash_bwd_dkv, each followed for bfloat16 by its work order: see the header
// note). Sq, Sk and B*H must be positive. Each returns cudaGetLastError()
// after its launch, or the reason there was none (cudaErrorInvalidValue for an
// unsupported dtype/head_dim, which the Python wrapper rejects first;
// cudaErrorMisalignedAddress for a bfloat16 tensor that is not 16-byte
// aligned).
#define UML_BWD_DISPATCH(LAUNCH, ...)                                      \
  if (seg_ids != nullptr && (seg_ranges == nullptr || kv_lens == nullptr)) \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  if (dtype == 0 && D == 64) {                                             \
    LAUNCH<64>(__VA_ARGS__);                                               \
  } else if (dtype == 0 && D == 128) {                                     \
    LAUNCH<128>(__VA_ARGS__);                                              \
  } else if (dtype == 1 && D == 64) {                                      \
    return LAUNCH##_wgmma<64>(__VA_ARGS__);                                \
  } else if (dtype == 1 && D == 128) {                                     \
    return LAUNCH##_wgmma<128>(__VA_ARGS__);                               \
  } else {                                                                 \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  }                                                                        \
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
