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
// carry its id (empty for padding). For bf16 it is followed by the work order,
// B * ceil(Sq / 128) int32 entries b * ceil(Sq / 128) + m naming the query
// tiles in launch order. The CTA reduces the ranges over its rows and scans
// only the key tiles inside [min first, max end) ∩ [0, kv_len) ∩ the causal
// limit, so a packed row costs O(sum of seg_len^2), not O(S^2); a tile of
// rows that straddles segments scans the union, and the in-tile id test
// keeps the union exact (as it keeps the superset ranges of ids that recur
// non-contiguously exact). Padding rows (id 0) see no key: they write zeros
// and an lse of -1e30, from which K2/K3 take exactly nothing (they select).
//
// Two bodies behind one entry point, chosen by dtype (not a fallback: each
// dtype always takes its own body, and a call the chosen body cannot take
// returns an error that the wrapper raises):
//
// bf16 -> flash_fwd_wgmma_kernel, the tensor-core body. What bounds it on the
// H100: the work is 4*D flops per visible (q, k) pair against q, k, v and o
// read or written once (plus the f32 lse). At the main path's shapes (BERT
// B64 H12 S128 with kv_lens; packed LM B8 H12 S1024 causal; serving's
// prefill buckets up to S256) that is 15-50 visible pairs per input byte
// pair, below the card's bf16 ridge (~295 flops per byte), so the bound is
// bytes (0.015 ms at the BERT and LM shapes); only causal attention at long S
// (above ~1.2k keys per row at D 64) is bounded by operations. Reaching
// either needs the products on the tensor cores. Design (Hopper):
//   - one CTA per (batch*head, tile of 128 query rows): two consumer
//     warpgroups of 64 rows each and one producer warp;
//   - TMA (host-built 3-D tensor maps over (D, S, batch*head), 128-byte
//     swizzle, zero fill past S) stages Q once and streams 64-key K/V tiles,
//     kept bf16, through a ring of two stages guarded by full/empty
//     mbarriers: the next tile's copy is in flight while the current one
//     computes, and no __syncthreads sits in the loop;
//   - S = Q K^T by wgmma m64n64k16 (both operands from shared-memory
//     descriptors, K-major as stored), the online softmax on the accumulator
//     fragments (row max across the four threads of a row, exp2 of pre-scaled
//     scores, the row sum from the f32 P so lse stays f32-accurate), then
//     O += P V by wgmma with P in registers as the A operand and V from
//     shared memory, MN-major through the transpose bit. P goes in as two
//     bf16 parts, hi = bf16(p) and lo = bf16(p - hi), two products: one bf16
//     rounding of the unnormalised P, at another point than the plain
//     version's rounding of the normalised weights, failed chip_smoke's bf16
//     greedy gate (a split at a top-2 logit gap >= 1e-2) for 8 of 10 weight
//     and prompt seeds of GPT-2 small, the two parts for 3 of 10; the second
//     product costs 12-33 % of the kernel's time (H100 80GB HBM3, 700 W);
//   - masks only on tiles that need them: a warp applies the kv_len, causal
//     and segment-id masks to its fragments only when the tile straddles
//     kv_len or the diagonal for its 16 rows, or its rows and the tile's keys
//     do not all carry one id; a masked entry contributes exactly 0, also on
//     a row that has seen no key yet;
//   - the packed skip map is reduced over 64-row groups (reduce_tile_ranges)
//     per warpgroup and over the CTA's 128 rows for the loads;
//   - heaviest tiles first: without ids the grid's first CTAs take the last
//     query tiles (the longest causal scans); with ids the wrapper passes a
//     work order (tiles by descending scan length) after the skip map.
//
// f32 -> flash_fwd_kernel, the CUDA-core body of the first port: a product of
// f32 inputs on the tensor cores would be TF32 (about three decimal digits),
// too coarse for the f32 checks (2e-5 against the plain version, identical
// greedy streams, 1e-4 gradients). One CTA of 128 threads per (batch*head,
// tile of 32 query rows); four threads share a query row, each holding a
// quarter of the head dim of the scaled query and of the accumulator in
// registers. The CTA walks K/V tiles staged once in shared memory with their
// key ids in packed mode and read by all 32 rows; scores of 8 keys at a time
// are reduced across the four threads by warp shuffles and folded into the
// running (max, sum, acc) state. Tiles outside the scan range are never
// loaded.
//
// Both bodies take any Sq and Sk (the ragged query and key tiles are masked),
// head_dim 64 or 128.

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;  // query rows per CTA, four threads per row
constexpr int kChunk = 8;    // keys scored per online-softmax update

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ kv_lens, const int* __restrict__ seg_ids, const int* __restrict__ seg_ranges,
    float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk, int seg_stride,
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
  const float* q_row = q + (static_cast<size_t>(bh) * Sq + (q_live ? qi : 0)) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[j * 4 + e] = q_row[(j * 4 + quad) * 4 + e] * sm_scale;
      acc[j * 4 + e] = 0.f;
    }
  }
  float m = uml::kNegInf, l = 0.f;

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
  float* o_row = o + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o_row[(j * 4 + quad) * 4 + e] = acc[j * 4 + e] / denom;
  }
  if (lse != nullptr && quad == 0) lse[static_cast<size_t>(bh) * Sq + qi] = m + logf(denom);
}

template <int D>
void launch(const void* q, const void* k, const void* v, const int* kv_lens, const int* seg_ids,
            const int* seg_ranges, void* o, float* lse, int B, int H, int Sq, int Sk, int seg_stride,
            int causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), kv_lens, seg_ids,
      seg_ranges, static_cast<float*>(o), lse, H, Sq, Sk, seg_stride, causal, sm_scale);
}


// ------------------------------------------------------ bf16: tensor cores

constexpr int kWG = 2;                      // consumer warpgroups per CTA, 64 query rows each
constexpr int kBM = 64 * kWG;               // query rows per CTA
constexpr int kBN = 64;                     // keys per K/V tile
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kTcThreads = 128 * kWG + 32;  // the consumers and one producer warp

// shared-memory layout (byte offsets from a 1024-byte aligned base); every
// tile is stored as blocks of 64 columns (128-byte rows, 128-byte swizzle)
template <int D>
struct TcSmem {
  static constexpr int kQ = 0;                        // [D/64][kBM rows][64]
  static constexpr int kTile = kBN * D * 2;           // one K or V tile: [D/64][kBN keys][64]
  static constexpr int kKV = kQ + kBM * D * 2;        // stage s: K at kKV + 2 s kTile, V after it
  static constexpr int kIds = kKV + kStages * 2 * kTile;  // [kStages][kBN] key ids (packed mode)
  static constexpr int kRanges = kIds + kStages * kBN * 4;  // [kBM / 32][2] scan ranges
  static constexpr int kBars = kRanges + kBM / 32 * 2 * 4;  // full[kStages], empty[kStages], q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // slack to align the base
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 2 : 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_lens, const int* __restrict__ seg_ids,
    const int* __restrict__ seg_ranges, const int* __restrict__ order, uint16_t* __restrict__ o,
    float* __restrict__ lse, int BH, int H, int Sq, int Sk, int seg_stride, int n_mt, int causal, float sm_scale) {
  using L = TcSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (uml::smem_u32(smem_raw) & 1023u)) & 1023u);
  int* ranges_s = reinterpret_cast<int*>(smem + L::kRanges);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

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
      uml::mbar_init(&full[s], 32);            // the producer warp's lanes
      uml::mbar_init(&empty[s], 128 * kWG);    // every consumer thread
    }
    uml::mbar_init(q_bar, 1);
    uml::mbar_fence_init();
  }
  __syncthreads();

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(Sk, max(kv_lens[b], 0));
  // the CTA's scan [lo, end) in keys, and its tiles [t0, t0 + n_t)
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

  if (warp == 4 * kWG) {  // producer: Q once, then the K/V ring
    if (lane == 0) {
      uml::mbar_arrive_expect_tx(q_bar, kBM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) uml::tma_load_3d(smem + L::kQ + c * kBM * 128, &tm_q, q_bar, c * 64, q0, bh);
    }
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kStages;
      const int k0 = (t0 + i) * kBN;
      uml::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (packed) {
        int* ids_s = reinterpret_cast<int*>(smem + L::kIds) + s * kBN;
        for (int j = lane; j < kBN; j += 32) ids_s[j] = k0 + j < Sk ? ids_b[k0 + j] : 0;
      }
      if (lane == 0) {
        uint8_t* kt = smem + L::kKV + s * 2 * L::kTile;
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

  // consumers: warpgroup wg owns rows q0w .. q0w + 63; this warp rows rw .. rw + 15;
  // this thread rows row0 = rw + lane / 4 and row1 = row0 + 8 of the fragments
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

  float acc[D / 2];
  float sc[32];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = 0.f;
  float m0 = uml::kNegInf, m1 = uml::kNegInf, l0 = 0.f, l1 = 0.f;  // running max (raw scores), partial sums
  const float c2 = sm_scale * 1.4426950408889634f;                  // raw score -> log2 units
  const uint8_t* q_w = smem + L::kQ + wg * 64 * 128;
  uml::mbar_wait(q_bar, 0);

  for (int i = 0; i < n_t; ++i) {
    const int s = i % kStages;
    const int k0 = (t0 + i) * kBN;
    uml::mbar_wait(&full[s], (i / kStages) & 1);
    if (k0 + kBN > w_lo && k0 < w_end) {  // warpgroup-uniform: the tile meets this warpgroup's scan
      const uint8_t* kt = smem + L::kKV + s * 2 * L::kTile;
      const uint8_t* vt = kt + L::kTile;
      const int* kid = reinterpret_cast<const int*>(smem + L::kIds) + s * kBN;

      uml::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * 128 * 64 + (kk % 4) * 32;  // 64-column block, then 16 columns in it
        uml::wgmma_ss_m64n64<0>(sc, uml::sw128_desc(q_w + (kk / 4) * kBM * 128 + (kk % 4) * 32, 16, 1024),
                                uml::sw128_desc(kt + off, 16, 1024), kk > 0 ? 1 : 0);
      }
      uml::wgmma_commit();
      uml::wgmma_wait<0>();

      // fragment j of this thread: row (j & 2 ? row1 : row0), key k0 + (j / 4) * 8 + 2 tq + (j & 1)
      bool need = k0 + kBN > kv_len || (causal && k0 + kBN - 1 > rw);  // warp-uniform
      if (packed && !need) {
        bool same = qid0 > 0 && qid1 == qid0;
#pragma unroll
        for (int c = 0; c < 8; ++c) same = same && kid[c * 8 + 2 * tq] == qid0 && kid[c * 8 + 2 * tq + 1] == qid0;
        need = !__all_sync(0xffffffffu, same);
      }
      uint32_t valid = 0xffffffffu;
      if (need) {
        valid = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = (j / 4) * 8 + 2 * tq + (j & 1);
          const int key = k0 + col;
          const int row = j & 2 ? row1 : row0;
          const int qid = j & 2 ? qid1 : qid0;
          const bool ok = key < kv_len && (!causal || key <= row) && (!packed || (qid > 0 && kid[col] == qid));
          valid |= ok ? (1u << j) : 0u;
          sc[j] = ok ? sc[j] : uml::kNegInf;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j & 2) {
          mx1 = fmaxf(mx1, sc[j]);
        } else {
          mx0 = fmaxf(mx0, sc[j]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = exp2f((m0 - mx0) * c2), corr1 = exp2f((m1 - mx1) * c2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * c2, mb1 = mx1 * c2;
      // P as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi): the A
      // fragments of the four 16-key steps (see the header note)
      uint32_t pa[16], pb[16];
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const float mb = j & 2 ? mb1 : mb0;
        float pa0 = exp2f(fmaf(sc[j], c2, -mb)), pa1 = exp2f(fmaf(sc[j + 1], c2, -mb));
        if (need) {  // a masked key contributes exactly 0, also while the row's max is still -1e30
          pa0 = (valid >> j) & 1u ? pa0 : 0.f;
          pa1 = (valid >> (j + 1)) & 1u ? pa1 : 0.f;
        }
        if (j & 2) {
          ps1 += pa0 + pa1;
        } else {
          ps0 += pa0 + pa1;
        }
        pa[j / 2] = uml::pack_bf16x2(pa0, pa1);
        pb[j / 2] = uml::pack_bf16x2(pa0 - uml::BF16::load(static_cast<uint16_t>(pa[j / 2] & 0xffffu)),
                                     pa1 - uml::BF16::load(static_cast<uint16_t>(pa[j / 2] >> 16)));
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c] *= corr0;
        acc[4 * c + 1] *= corr0;
        acc[4 * c + 2] *= corr1;
        acc[4 * c + 3] *= corr1;
      }

      uml::wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part) {
#pragma unroll
        for (int ks = 0; ks < kBN / 16; ++ks) {
          const uint32_t* p = part ? pb : pa;
          const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
          // V is the MN-major B operand: 16 keys of 128-byte rows per step,
          // the next 64 dims kBN rows further on
          const uint64_t desc_v = uml::sw128_desc(vt + ks * 16 * 128, kBN * 128, 1024);
          if constexpr (D == 64) {
            uml::wgmma_rs_m64n64<1>(acc, a, desc_v, 1);
          } else {
            uml::wgmma_rs_m64n128<1>(acc, a, desc_v, 1);
          }
        }
      }
      uml::wgmma_commit();
      uml::wgmma_wait<0>();
    }
    uml::mbar_arrive(&empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const size_t base = static_cast<size_t>(bh) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Sq) continue;
    const float l = r ? l1 : l0;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that saw no key writes zeros
    uint16_t* o_row = o + (base + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(o_row + c * 8 + 2 * tq) =
          uml::pack_bf16x2(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    }
    if (lse != nullptr && tq == 0) lse[base + row] = l > 0.f ? (r ? m1 : m0) * sm_scale + logf(l) : uml::kNegInf;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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
bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int BH, int D, int box_rows) {
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

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const int* kv_lens, const int* seg_ids,
                 const int* seg_ranges, void* o, float* lse, int B, int H, int Sq, int Sk, int seg_stride, int causal,
                 float sm_scale, cudaStream_t stream) {
  using L = TcSmem<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(o)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA reads 16-byte aligned tensors
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int BH = B * H;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!bf16_map(encode, &tm_q, q, Sq, BH, D, kBM) || !bf16_map(encode, &tm_k, k, Sk, BH, D, kBN) ||
      !bf16_map(encode, &tm_v, v, Sk, BH, D, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_mt = (Sq + kBM - 1) / kBM;
  const long long n_ctas = static_cast<long long>(n_mt) * BH;
  if (n_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // with ids, the work order follows the (B, Sq, 2) ranges
  const int* order = seg_ids != nullptr ? seg_ranges + static_cast<size_t>(B) * Sq * 2 : nullptr;
  const cudaError_t attr = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_fwd_wgmma_kernel<D><<<static_cast<unsigned>(n_ctas), kTcThreads, L::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, kv_lens, seg_ids, seg_ranges, order, static_cast<uint16_t*>(o), lse, BH, H, Sq, Sk,
      seg_stride, n_mt, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core
// body). kv_lens, seg_ids (with seg_ranges and seg_stride) and lse may be
// null; with seg_ids, kv_lens must be given, and for bfloat16 seg_ranges
// carries the work order after the ranges (see the header note). Returns
// cudaGetLastError() after the launch, or the reason there was none
// (cudaErrorInvalidValue for an unsupported dtype/head_dim, which the Python
// wrapper rejects first; cudaErrorMisalignedAddress for a bfloat16 tensor
// that is not 16-byte aligned).
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
    launch<64>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else if (dtype == 0 && D == 128) {
    launch<128>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else if (dtype == 1 && D == 64) {
    return launch_wgmma<64>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else if (dtype == 1 && D == 128) {
    return launch_wgmma<128>(q, k, v, lens, ids, ranges, o, lse_f, B, H, Sq, Sk, seg_stride, causal, sm_scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
