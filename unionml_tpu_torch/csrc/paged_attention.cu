// K4: paged attention straight off the KV block pool (int8 or full precision).
//
// Replaces the Pallas kernel `_paged_kernel` (unionml_tpu/ops/paged_attention.py
// :92) reached through `_paged_forward`. Same function: S queries of each row
// attend over the row's KV through its block table; logical key position
// w*bs + o lives in pool block table[b, w] at offset o and is visible to query
// s iff w*bs + o <= base[b] + s (and w < W). An int8 pool is dequantized as
// (codes.f32 * scale).astype(out_dtype) with per-(block, head) f32 scales, the
// same value rounding as the reference's gather-dequant; a full-precision pool
// is read as is. A query that sees no key writes zeros.
//
// Three bodies behind one entry point. The Python wrapper picks the body from
// host-known facts only (S, dtype, W, bs: `launch_plan` in
// ops/paged_attention.py) and passes it in; nothing reads base[] on the host.
// A combination no body takes is refused there, before launch.
//
// 1. Decode (S <= 8; paged_decode_kernel + paged_merge_kernel), on CUDA cores.
//    What bounds it: at S = 1 each stored K/V byte feeds one multiply-add, so
//    the bound is the bytes of the visible columns (12.4 MB at B8 H12 with
//    ~1000 keys per row: 3.7 us at 3.35 TB/s); a tensor core would have one
//    row to multiply. Design, flash-decoding: one CTA of 8 warps per (split,
//    query s and head h, row b). A split is a FIXED run of 16 table columns
//    (columns 16 i .. 16 i + 15), so a query's arithmetic depends only on its
//    own row's visible columns, never on W, B or the grid: one row's output is
//    bitwise the same alone, in a batch, or under a wider table. The host
//    sizes the grid by W; a split that starts past the row's last visible
//    column (base + s) / bs writes the neutral partial (m = -1e30, l = 0) and
//    exits. The CTA reads its 16 table entries and scales into shared memory,
//    then streams its columns with 16-byte cp.async copies through a ring of
//    four stages of whole columns (about 8 KB of K + V each; at int8, bs 16,
//    D 64 twelve of the split's 16 columns are in flight after the prologue), so the
//    loads of later columns overlap the math on earlier ones. Inside a stage
//    four lanes share a key (each a quarter of the head dim), 8 keys per warp
//    pass, 8 warps per CTA: at S = 1 there is little work per key, so what
//    hides the latency of each pass is the number of warps in flight;
//    codes are dequantized in registers with integer and FP32 operations (an
//    int8 -> f32 or f32 -> bf16 conversion instruction runs at an eighth of
//    the FP32 rate and held the first version of this body to the parent's
//    time); every warp keeps its own f32
//    online-softmax state, merged through shared memory into the CTA's partial
//    (m, l, acc[D]) in an f32 workspace the wrapper allocates. The merge kernel
//    then combines each query's partials over splits 0 .. its last, in that
//    fixed order: deterministic, no atomics on the output.
//
// 2. Query tile, bf16 (S > 8, bf16 q; paged_tile_wgmma_kernel), on the tensor
//    cores. What bounds it: a chunk of S queries reads each visible K/V column
//    once and does 4 D flops per visible (query, key) pair; at S 256 that is
//    far below the ridge, so it is bytes again, and the first design, which
//    re-read and re-dequantized every column once per query, lost 1.54x to a
//    gather + SDPA. Design: one CTA (one warpgroup, 128 threads) per (64-row
//    query tile, head, row), last tiles (the longest scans) first. `wgmma`
//    rather than `mma.sync`: K1's SW128 descriptors and m64n64 / m64n128
//    wrappers take the 64-row tile as it is, and the fragments, the online
//    softmax and the P layout are K1's, already checked on the card. Q and
//    64-key K/V tiles come in by cp.async through a three-stage ring; each
//    key's address comes from the table row, staged in shared memory at the
//    start. A bf16 pool block is copied straight into the 128-byte-swizzled
//    operand layout (the cp.async destination does the swizzle); an int8 block
//    lands raw in the ring and the warpgroup dequantizes it into a bf16 operand
//    tile, rounding (code * scale) to bf16 as the reference does. S = Q K^T and
//    O += P V by wgmma; masks only on tiles that straddle base + s or the
//    table's end. P enters P V as two bf16 parts, hi + lo, as in K1: with one
//    rounding of the unnormalised P the kernel path's greedy streams left the
//    plain bf16 path's beyond the serving gate in 9 of 90, with two parts in 7
//    (GPT-2 small, 10 weight and prompt seeds, chip_ab.py --serve-seeds, H100
//    80GB HBM3 at 700 W). No key split: at B1 S256 48 CTAs scan 5-16 tiles
//    each, 0.021-0.040 ms against a gather + SDPA's 0.067 (same card).
//
// 3. Query tile, f32 (S > 8, f32 q with an f32 or int8 pool;
//    paged_tile_f32_kernel), on CUDA cores: a tensor-core product of f32
//    inputs would be TF32, too coarse for the f32 checks (2e-5 against the
//    plain version, identical greedy streams). K1's f32 body with keys taken
//    through the table: 32 query rows per CTA, four threads per row, K/V tiles
//    staged once in shared memory (dequantized there) and read by all rows.
//
// All bodies take head_dim 64 or 128; the bf16 query tile takes block sizes
// that divide 64.

#include <string.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------ 1. decode

constexpr int kSplitCols = 16;        // table columns per split (fixed: see the header note)
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecStages = 4;         // cp.async ring depth, in stages of whole columns
constexpr int kDecStageBytes = 8192;  // K + V bytes a stage aims at
constexpr int kLanesPerKey = 4;       // lanes that share a key, each a quarter of the head dim
constexpr int kKeysPerPass = 32 / kLanesPerKey;

// columns per decode stage for a column of `col_bytes` (K + V)
__host__ __device__ __forceinline__ int decode_stage_cols(int col_bytes) {
  const int cols = kDecStageBytes / col_bytes;
  return cols < 1 ? 1 : (cols > kSplitCols ? kSplitCols : cols);
}

// a lane's share of a key row (DH elements) from shared memory, dequantized as the
// reference does: int8 as OUT::round(code * scale), a full-precision pool as is
template <typename KV, typename OUT, int DH>
__device__ __forceinline__ void load_row_part(const typename KV::T* src, float scale, float* out) {
  using T = typename KV::T;
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
  constexpr bool kQuant = sizeof(T) == 1;
  const uint4* vec = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < DH / kPerVec; ++i) {
    const uint4 raw = vec[i];
    if constexpr (kQuant) {  // integer and FP32 operations only: the conversion unit is the narrow one
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        float x[4];
        uml::i8x4_to_f32(words[wd], x);
#pragma unroll
        for (int e = 0; e < 4; ++e) out[i * 16 + wd * 4 + e] = OUT::round(x[e] * scale);
      }
    } else {
      T vals[kPerVec];
      memcpy(vals, &raw, 16);
#pragma unroll
      for (int e = 0; e < kPerVec; ++e) out[i * kPerVec + e] = KV::load(vals[e]);
    }
  }
}

// the last table column query position q_pos can see (-1: none)
__device__ __forceinline__ int last_visible_col(int q_pos, int bs, int W) {
  return q_pos < 0 ? -1 : min(q_pos / bs, W - 1);
}

template <typename OUT, typename KV, int D>
__global__ void __launch_bounds__(kDecThreads) paged_decode_kernel(
    const typename OUT::T* __restrict__ q, const typename KV::T* __restrict__ k_pool,
    const typename KV::T* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table, const int* __restrict__ base,
    float* __restrict__ ws, int H, int S, int bs, int W, int n_split, float sm_scale) {
  using T = typename KV::T;
  constexpr int DH = D / kLanesPerKey;  // dims per lane
  extern __shared__ __align__(16) uint8_t smem[];
  const int col_elems = bs * D;  // one column of K (or V) as stored
  const int stage_cols = decode_stage_cols(2 * col_elems * static_cast<int>(sizeof(T)));
  const int stage_elems = stage_cols * col_elems;
  T* ring = reinterpret_cast<T*>(smem);  // [kDecStages][K, V][stage_cols][bs][D]
  int* tbl_s = reinterpret_cast<int*>(smem + static_cast<size_t>(kDecStages) * 2 * stage_elems * sizeof(T));
  float* ks_s = reinterpret_cast<float*>(tbl_s + kSplitCols);
  float* vs_s = ks_s + kSplitCols;
  float* m_s = vs_s + kSplitCols;  // [kDecWarps]
  float* l_s = m_s + kDecWarps;    // [kDecWarps]
  float* acc_s = l_s + kDecWarps;  // [kDecWarps][D]

  const int split = blockIdx.x;
  const int s_idx = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % kLanesPerKey;  // this lane's quarter of the head dim
  const int key_slot = lane / kLanesPerKey;

  // the loads that depend on nothing: the row's base, the split's table
  // entries and the query, all in flight together
  const int c0 = split * kSplitCols;
  const int q_pos = base[b] + s_idx;
  const int blk = tid < kSplitCols && c0 + tid < W ? table[static_cast<size_t>(b) * W + c0 + tid] : 0;
  float qr[DH], acc[DH], kv[DH];
  const typename OUT::T* q_row = q + ((static_cast<size_t>(b) * H + h) * S + s_idx) * D + sub * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = OUT::load(q_row[d]);
    acc[d] = 0.f;
  }
  const int last_col = last_visible_col(q_pos, bs, W);
  float* part = ws + ((((static_cast<size_t>(b) * H + h) * S + s_idx) * n_split) + split) * (D + 2);
  if (c0 > last_col) {  // the neutral partial (never read by the merge, written all the same)
    if (tid == 0) {
      part[0] = uml::kNegInf;
      part[1] = 0.f;
    }
    return;
  }
  const int n_cols = min(kSplitCols, last_col + 1 - c0);
  if (tid < n_cols) tbl_s[tid] = blk;
  __syncthreads();

  const int n_stages = (n_cols + stage_cols - 1) / stage_cols;
  const int chunks = col_elems * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies per column
  auto load_stage = [&](int i) {
    if (i < n_stages) {
      T* kd = ring + static_cast<size_t>(i % kDecStages) * 2 * stage_elems;
      T* vd = kd + stage_elems;
      const int col_lo = i * stage_cols;
      const int cols = min(stage_cols, n_cols - col_lo);
      for (int idx = tid; idx < cols * chunks; idx += kDecThreads) {
        const int cc = idx / chunks;
        const size_t src = (static_cast<size_t>(tbl_s[col_lo + cc]) * H + h) * col_elems;
        const int off = (idx - cc * chunks) * 16;
        uml::cp_async16(reinterpret_cast<uint8_t*>(kd + cc * col_elems) + off,
                        reinterpret_cast<const uint8_t*>(k_pool + src) + off);
        uml::cp_async16(reinterpret_cast<uint8_t*>(vd + cc * col_elems) + off,
                        reinterpret_cast<const uint8_t*>(v_pool + src) + off);
      }
    }
    uml::cp_async_commit();  // an empty group past the end keeps the counting uniform
  };
#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) load_stage(i);
  if (tid < n_cols) {  // read at the first stage, after the barrier there
    const size_t bh = static_cast<size_t>(blk) * H + h;
    ks_s[tid] = k_scale != nullptr ? k_scale[bh] : 1.f;
    vs_s[tid] = v_scale != nullptr ? v_scale[bh] : 1.f;
  }
  float m = uml::kNegInf, l = 0.f;

  for (int i = 0; i < n_stages; ++i) {
    uml::cp_async_wait<kDecStages - 2>();
    __syncthreads();  // stage i landed for every thread's copies; stage i - 1 is consumed
    load_stage(i + kDecStages - 1);
    const T* kd = ring + static_cast<size_t>(i % kDecStages) * 2 * stage_elems;
    const T* vd = kd + stage_elems;
    const int col_lo = i * stage_cols;
    const int keys = min(stage_cols, n_cols - col_lo) * bs;
    const int key0 = (c0 + col_lo) * bs;  // logical position of the stage's first key
    for (int kb = warp * kKeysPerPass; kb < keys; kb += kDecWarps * kKeysPerPass) {
      const int j = kb + key_slot;
      const bool valid = j < keys && key0 + j <= q_pos;
      const int jr = min(j, keys - 1);
      const int col = col_lo + jr / bs;
      load_row_part<KV, OUT, DH>(kd + jr * D + sub * DH, ks_s[col], kv);
      float part_dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) part_dot += qr[d] * kv[d];
#pragma unroll
      for (int off = 1; off < kLanesPerKey; off <<= 1) part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
      const float score = valid ? part_dot * sm_scale : uml::kNegInf;
      float m_new = score;
#pragma unroll
      for (int off = kLanesPerKey; off < 32; off <<= 1) m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
      m_new = fmaxf(m, m_new);
      const float corr = expf(m - m_new);
      // a masked key contributes exactly 0 (exp(0) would be 1 while every
      // key seen so far is masked)
      const float p = valid ? expf(score - m_new) : 0.f;
      l = l * corr + (sub == 0 ? p : 0.f);  // each key counted once
      load_row_part<KV, OUT, DH>(vd + jr * D + sub * DH, vs_s[col], kv);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = acc[d] * corr + p * kv[d];
      m = m_new;
    }
  }
  uml::cp_async_wait<0>();

  // merge the key slots of each warp (lanes with the same part of the head dim), then warps
#pragma unroll
  for (int off = kLanesPerKey; off < 32; off <<= 1) {
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane < kLanesPerKey) {
#pragma unroll
    for (int d = 0; d < DH; ++d) acc_s[warp * D + sub * DH + d] = acc[d];
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (tid < D) {
    float m_all = uml::kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) m_all = fmaxf(m_all, m_s[w]);
    float l_all = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = expf(m_s[w] - m_all);  // 0 for a warp that saw no key
      l_all += l_s[w] * f;
      out += acc_s[w * D + tid] * f;
    }
    part[2 + tid] = out;
    if (tid == 0) {
      part[0] = m_all;
      part[1] = l_all;
    }
  }
}

// one CTA of D threads per (query s and head h, row b): the partials of splits
// 0 .. the query's last, in that order
template <typename OUT, int D>
__global__ void __launch_bounds__(D) paged_merge_kernel(const float* __restrict__ ws, const int* __restrict__ base,
                                                        typename OUT::T* __restrict__ o, int H, int S, int bs, int W,
                                                        int n_split) {
  const int s_idx = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int b = blockIdx.y;
  const int last_col = last_visible_col(base[b] + s_idx, bs, W);
  const int n = last_col < 0 ? 0 : last_col / kSplitCols + 1;
  const size_t row = (static_cast<size_t>(b) * H + h) * S + s_idx;
  const float* rec = ws + row * n_split * (D + 2);
  float m_all = uml::kNegInf;
  for (int j = 0; j < n; ++j) m_all = fmaxf(m_all, rec[j * (D + 2)]);
  float l = 0.f, out = 0.f;
  for (int j = 0; j < n; ++j) {
    const float f = expf(rec[j * (D + 2)] - m_all);
    l += rec[j * (D + 2) + 1] * f;
    out += rec[j * (D + 2) + 2 + threadIdx.x] * f;
  }
  o[row * D + threadIdx.x] = OUT::store(l > 0.f ? out / l : 0.f);  // a query that sees no key writes zeros
}

template <typename OUT, typename KV, int D>
size_t decode_smem(int bs) {
  const int col_bytes = 2 * bs * D * static_cast<int>(sizeof(typename KV::T));
  return static_cast<size_t>(kDecStages) * decode_stage_cols(col_bytes) * col_bytes +
         (3 * kSplitCols + 2 * kDecWarps + kDecWarps * D) * 4;
}

template <typename OUT, typename KV, int D>
int launch_decode(const void* q, const void* k, const void* v, const float* ks, const float* vs, const int* table,
                  const int* base, void* o, float* ws, int B, int H, int S, int bs, int W, int n_split,
                  float sm_scale, cudaStream_t stream) {
  if (n_split != (W + kSplitCols - 1) / kSplitCols || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = decode_smem<OUT, KV, D>(bs);
  const cudaError_t attr = cudaFuncSetAttribute(paged_decode_kernel<OUT, KV, D>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_decode_kernel<OUT, KV, D><<<dim3(n_split, S * H, B), kDecThreads, smem, stream>>>(
      static_cast<const typename OUT::T*>(q), static_cast<const typename KV::T*>(k),
      static_cast<const typename KV::T*>(v), ks, vs, table, base, ws, H, S, bs, W, n_split, sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_merge_kernel<OUT, D><<<dim3(S * H, B), D, 0, stream>>>(ws, base, static_cast<typename OUT::T*>(o), H, S, bs,
                                                              W, n_split);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- 2. query tile, bf16

constexpr int kTileRows = 64;  // query rows per CTA: one warpgroup
constexpr int kTileKeys = 64;  // keys per K/V tile
constexpr int kTcStages = 3;   // cp.async ring depth
constexpr int kTcThreads = 128;

// shared-memory layout (byte offsets from a 1024-byte aligned base); operand
// tiles are blocks of 64 columns (128-byte rows, 128-byte swizzle)
template <bool Quant, int D>
struct TileSmem {
  static constexpr int kOpTile = kTileKeys * D * 2;            // a bf16 K or V operand tile
  static constexpr int kQ = 0;                                 // [D/64][64 rows][64]
  static constexpr int kRawTile = Quant ? kTileKeys * D : kOpTile;  // a staged K or V tile
  static constexpr int kRing = kQ + kTileRows * D * 2;         // stage s: K at kRing + 2 s kRawTile, V after
  static constexpr int kOp = kRing + kTcStages * 2 * kRawTile;  // int8: the dequantized K, V operand tiles
  static constexpr int kTable = kOp + (Quant ? 2 * kOpTile : 0);  // W ints, then (int8) W + W scales
  static constexpr int kFixed = kTable + 1024;                 // + slack to align the base
};

// byte offset of 16-byte chunk c (8 bf16 of columns 8c .. 8c + 7) of row r in
// a 128-byte-swizzled tile of `rows` rows
__device__ __forceinline__ int sw128_offset(int r, int c, int rows) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) * 16);
}

template <bool Quant, int D>
__global__ void __launch_bounds__(kTcThreads) paged_tile_wgmma_kernel(
    const uint16_t* __restrict__ q, const void* __restrict__ k_pool, const void* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ base, uint16_t* __restrict__ o, int H, int S, int bs, int W, float sm_scale) {
  using L = TileSmem<Quant, D>;
  constexpr int kEsize = Quant ? 1 : 2;
  constexpr int kKeyChunks = D * kEsize / 16;  // 16-byte copies per key row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (uml::smem_u32(smem_raw) & 1023u)) & 1023u);
  int* tbl_s = reinterpret_cast<int*>(smem + L::kTable);
  float* ks_s = reinterpret_cast<float*>(tbl_s + W);
  float* vs_s = ks_s + W;

  const int n_mt = (S + kTileRows - 1) / kTileRows;
  const int mt = n_mt - 1 - static_cast<int>(blockIdx.x);  // heaviest (last) query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = mt * kTileRows;
  const int tid = threadIdx.x;
  const int bpos = base[b];
  const int cap = W * bs;
  // keys [0, end) are visible to some row of the tile
  const int end = min(cap, max(0, bpos + min(q0 + kTileRows, S)));
  const int n_t = (end + kTileKeys - 1) / kTileKeys;
  const int n_cols = (end + bs - 1) / bs;
  for (int c = tid; c < n_cols; c += kTcThreads) {
    const int blk = table[static_cast<size_t>(b) * W + c];
    tbl_s[c] = blk;
    if constexpr (Quant) {
      ks_s[c] = k_scale[static_cast<size_t>(blk) * H + h];
      vs_s[c] = v_scale[static_cast<size_t>(blk) * H + h];
    }
  }
  __syncthreads();

  const uint8_t* kp = static_cast<const uint8_t*>(k_pool);
  const uint8_t* vp = static_cast<const uint8_t*>(v_pool);
  const uint16_t* q_bh = q + (static_cast<size_t>(b) * H + h) * S * D;
  for (int idx = tid; idx < kTileRows * D / 8; idx += kTcThreads) {  // Q, zeros past S
    const int r = idx / (D / 8), c = idx % (D / 8);
    const bool in = q0 + r < S;
    uml::cp_async16(smem + L::kQ + sw128_offset(r, c, kTileRows), q_bh + static_cast<size_t>(in ? q0 + r : 0) * D + c * 8,
                    in);
  }
  auto load_tile = [&](int t) {  // K/V keys t * 64 .. t * 64 + 63, zeros past `end`
    if (t < n_t) {
      uint8_t* kd = smem + L::kRing + (t % kTcStages) * 2 * L::kRawTile;
      uint8_t* vd = kd + L::kRawTile;
      for (int idx = tid; idx < kTileKeys * kKeyChunks; idx += kTcThreads) {
        const int kk = idx / kKeyChunks, c = idx % kKeyChunks;
        const int key = t * kTileKeys + kk;
        const bool in = key < end;
        const int col = in ? key / bs : 0;
        const size_t src = ((static_cast<size_t>(tbl_s[col]) * H + h) * bs + key % bs) * D * kEsize + c * 16;
        const int dst = Quant ? kk * D + c * 16 : sw128_offset(kk, c, kTileKeys);
        uml::cp_async16(kd + dst, kp + src, in);
        uml::cp_async16(vd + dst, vp + src, in);
      }
    }
    uml::cp_async_commit();  // the first group carries Q too
  };
#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) load_tile(t);

  // warp w owns query rows q0 + 16 w .. + 15; this thread rows row0 and row1 = row0 + 8
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int tq = lane & 3;
  const int rw = q0 + warp * 16;
  const int row0 = rw + (lane >> 2), row1 = row0 + 8;
  const int pos0 = bpos + row0, pos1 = bpos + row1;
  float acc[D / 2];
  float sc[32];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = 0.f;
  float m0 = uml::kNegInf, m1 = uml::kNegInf, l0 = 0.f, l1 = 0.f;  // running max (raw scores), partial sums
  const float c2 = sm_scale * 1.4426950408889634f;                  // raw score -> log2 units
  const uint8_t* q_s = smem + L::kQ;

  for (int t = 0; t < n_t; ++t) {
    const int k0 = t * kTileKeys;
    uml::cp_async_wait<kTcStages - 2>();
    uml::fence_proxy_async();
    __syncthreads();  // tile t landed for every thread's copies; tile t - 1 is consumed
    load_tile(t + kTcStages - 1);
    const uint8_t* kt = smem + L::kRing + (t % kTcStages) * 2 * L::kRawTile;
    const uint8_t* vt = kt + L::kRawTile;
    if constexpr (Quant) {  // dequantize into the bf16 operand tiles: 16 codes -> two swizzled chunks
      uint8_t* ko = smem + L::kOp;
      for (int idx = tid; idx < 2 * kTileKeys * (D / 16); idx += kTcThreads) {
        const int which = idx / (kTileKeys * (D / 16));
        const int rem = idx % (kTileKeys * (D / 16));
        const int kk = rem / (D / 16), c = rem % (D / 16);
        const int key = k0 + kk;
        const float scale = key < end ? (which ? vs_s : ks_s)[key / bs] : 0.f;
        const uint4 raw = *reinterpret_cast<const uint4*>(kt + which * L::kRawTile + kk * D + c * 16);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t w[8];
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {  // the reference's (codes.f32 * scale).astype(bf16)
          float x[4];
          uml::i8x4_to_f32(words[wd], x);
          w[2 * wd] = uml::pack_bf16x2(x[0] * scale, x[1] * scale);
          w[2 * wd + 1] = uml::pack_bf16x2(x[2] * scale, x[3] * scale);
        }
        uint8_t* dst = ko + which * L::kOpTile;
        *reinterpret_cast<uint4*>(dst + sw128_offset(kk, 2 * c, kTileKeys)) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + sw128_offset(kk, 2 * c + 1, kTileKeys)) = make_uint4(w[4], w[5], w[6], w[7]);
      }
      uml::fence_proxy_async();
      __syncthreads();
      kt = ko;
      vt = ko + L::kOpTile;
    }

    uml::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kTileKeys * 128 + (kk % 4) * 32;  // 64-column block, then 16 columns in it
      uml::wgmma_ss_m64n64<0>(sc, uml::sw128_desc(q_s + (kk / 4) * kTileRows * 128 + (kk % 4) * 32, 16, 1024),
                              uml::sw128_desc(kt + off, 16, 1024), kk > 0 ? 1 : 0);
    }
    uml::wgmma_commit();
    uml::wgmma_wait<0>();

    // fragment j of this thread: row (j & 2 ? row1 : row0), key k0 + (j / 4) * 8 + 2 tq + (j & 1);
    // a warp masks only a tile that reaches past its first row's position or the table's end
    const bool need = k0 + kTileKeys - 1 > bpos + rw || k0 + kTileKeys > cap;  // warp-uniform
    uint32_t valid = 0xffffffffu;
    if (need) {
      valid = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int key = k0 + (j / 4) * 8 + 2 * tq + (j & 1);
        const bool ok = key <= (j & 2 ? pos1 : pos0) && key < cap;
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
      for (int ks = 0; ks < kTileKeys / 16; ++ks) {
        const uint32_t* p = part ? pb : pa;
        const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
        // V is the MN-major B operand: 16 keys of 128-byte rows per step, the
        // next 64 dims kTileKeys rows further on
        const uint64_t desc_v = uml::sw128_desc(vt + ks * 16 * 128, kTileKeys * 128, 1024);
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
  uml::cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  uint16_t* o_bh = o + (static_cast<size_t>(b) * H + h) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= S) continue;
    const float l = r ? l1 : l0;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a query that sees no key writes zeros
    uint16_t* o_row = o_bh + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(o_row + c * 8 + 2 * tq) =
          uml::pack_bf16x2(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    }
  }
}

template <bool Quant, int D>
int launch_tile_wgmma(const void* q, const void* k, const void* v, const float* ks, const float* vs, const int* table,
                      const int* base, void* o, int B, int H, int S, int bs, int W, float sm_scale,
                      cudaStream_t stream) {
  using L = TileSmem<Quant, D>;
  if (kTileKeys % bs != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(o)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);  // cp.async copies 16-byte chunks
  }
  const size_t smem = L::kFixed + static_cast<size_t>(W) * (Quant ? 12 : 4);
  const cudaError_t attr = cudaFuncSetAttribute(paged_tile_wgmma_kernel<Quant, D>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kTileRows - 1) / kTileRows, H, B);
  paged_tile_wgmma_kernel<Quant, D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), k, v, ks, vs, table, base, static_cast<uint16_t*>(o), H, S, bs, W, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------- 3. query tile, f32

constexpr int kF32Rows = 32;  // query rows per CTA, four threads per row
constexpr int kChunk = 8;     // keys scored per online-softmax update

template <typename KV, int D>
__global__ void __launch_bounds__(128) paged_tile_f32_kernel(
    const float* __restrict__ q, const typename KV::T* __restrict__ k_pool, const typename KV::T* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ base, float* __restrict__ o, int H, int S, int bs, int W, float sm_scale) {
  constexpr int BK = D == 64 ? 64 : 32;  // keys per shared-memory tile (16 KB each of K and V)
  constexpr int NV = D / 16;             // float4 columns per thread
  constexpr int DT = NV * 4;             // dims per thread
  __shared__ float4 k_tile[BK * D / 4];
  __shared__ float4 v_tile[BK * D / 4];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int quad = tid & 3;
  const int q0 = static_cast<int>(blockIdx.x) * kF32Rows;
  const int qi = q0 + (tid >> 2);
  const bool q_live = qi < S;
  const int bpos = base[b];
  const int q_pos = bpos + qi;
  // keys [0, n_keys) are visible to some row of the tile
  const int n_keys = min(W * bs, max(0, bpos + min(q0 + kF32Rows, S)));

  float qr[DT], acc[DT];
  const float* q_row = q + ((static_cast<size_t>(b) * H + h) * S + (q_live ? qi : 0)) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[j * 4 + e] = q_row[(j * 4 + quad) * 4 + e] * sm_scale;
      acc[j * 4 + e] = 0.f;
    }
  }
  float m = uml::kNegInf, l = 0.f;
  float* k_flat = reinterpret_cast<float*>(k_tile);
  float* v_flat = reinterpret_cast<float*>(v_tile);
  const int* tbl = table + static_cast<size_t>(b) * W;

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * D; idx += 128) {
      const int key = k0 + idx / D;
      float kx = 0.f, vx = 0.f;
      if (key < n_keys) {
        const int blk = tbl[key / bs];
        const size_t bh = static_cast<size_t>(blk) * H + h;
        const size_t src = (bh * bs + key % bs) * D + idx % D;
        kx = KV::load(k_pool[src]);
        vx = KV::load(v_pool[src]);
        if (k_scale != nullptr) {  // (codes.f32 * scale).astype(f32)
          kx *= k_scale[bh];
          vx *= v_scale[bh];
        }
      }
      k_flat[idx] = kx;
      v_flat[idx] = vx;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < BK; c += kChunk) {
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
          part += qr[j * 4 + 0] * kk.x + qr[j * 4 + 1] * kk.y + qr[j * 4 + 2] * kk.z + qr[j * 4 + 3] * kk.w;
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int key = k0 + c + u;
        const bool ok = key < n_keys && key <= q_pos;
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
        // a masked key contributes exactly 0, also on a row that sees no key yet
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
  const float inv = l > 0.f ? 1.f / l : 0.f;  // a query that sees no key writes zeros
  float* o_row = o + ((static_cast<size_t>(b) * H + h) * S + qi) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o_row[(j * 4 + quad) * 4 + e] = acc[j * 4 + e] * inv;
  }
}

template <typename KV, int D>
int launch_tile_f32(const void* q, const void* k, const void* v, const float* ks, const float* vs, const int* table,
                    const int* base, void* o, int B, int H, int S, int bs, int W, float sm_scale,
                    cudaStream_t stream) {
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, H, B);
  paged_tile_f32_kernel<KV, D><<<grid, 128, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const typename KV::T*>(k), static_cast<const typename KV::T*>(v), ks,
      vs, table, base, static_cast<float*>(o), H, S, bs, W, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch

template <typename OUT, int D>
int dispatch(const void* q, const void* k, const void* v, const float* ks, const float* vs, const int* table,
             const int* base, void* o, float* ws, int B, int H, int S, int bs, int W, int kv_int8, int body,
             int n_split, float sm_scale, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(typename OUT::T) == 2;
  if (body == 0) {
    return kv_int8 ? launch_decode<OUT, uml::I8, D>(q, k, v, ks, vs, table, base, o, ws, B, H, S, bs, W, n_split,
                                                    sm_scale, stream)
                   : launch_decode<OUT, OUT, D>(q, k, v, nullptr, nullptr, table, base, o, ws, B, H, S, bs, W,
                                                n_split, sm_scale, stream);
  }
  if (body != 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kBf16) {
    return kv_int8 ? launch_tile_wgmma<true, D>(q, k, v, ks, vs, table, base, o, B, H, S, bs, W, sm_scale, stream)
                   : launch_tile_wgmma<false, D>(q, k, v, nullptr, nullptr, table, base, o, B, H, S, bs, W, sm_scale,
                                                 stream);
  } else {
    return kv_int8 ? launch_tile_f32<uml::I8, D>(q, k, v, ks, vs, table, base, o, B, H, S, bs, W, sm_scale, stream)
                   : launch_tile_f32<uml::F32, D>(q, k, v, nullptr, nullptr, table, base, o, B, H, S, bs, W, sm_scale,
                                                  stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 — of q, of the output and, when kv_int8 is
// 0, of the pool. kv_int8 = 1: the pool holds int8 codes and k_scale/v_scale
// hold one f32 per (block, head). body: 0 = decode (with n_split = ceil(W / 16)
// and an f32 workspace of B * H * S * n_split * (D + 2) floats), 1 = query
// tile (the workspace is not used). Returns cudaGetLastError() after the
// launches, or the reason there was none (cudaErrorInvalidValue for a
// combination the Python wrapper rejects first; cudaErrorMisalignedAddress for
// a bf16 query tile whose tensors are not 16-byte aligned).
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                               const void* table, const void* base, void* o, void* workspace, int B, int H, int S,
                               int D, int bs, int W, int dtype, int kv_int8, int body, int n_split, float sm_scale,
                               void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* bse = static_cast<const int*>(base);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) {
    return dispatch<uml::F32, 64>(q, k, v, ks, vs, tbl, bse, o, ws, B, H, S, bs, W, kv_int8, body, n_split, sm_scale, s);
  } else if (dtype == 0 && D == 128) {
    return dispatch<uml::F32, 128>(q, k, v, ks, vs, tbl, bse, o, ws, B, H, S, bs, W, kv_int8, body, n_split, sm_scale,
                                   s);
  } else if (dtype == 1 && D == 64) {
    return dispatch<uml::BF16, 64>(q, k, v, ks, vs, tbl, bse, o, ws, B, H, S, bs, W, kv_int8, body, n_split, sm_scale,
                                   s);
  } else if (dtype == 1 && D == 128) {
    return dispatch<uml::BF16, 128>(q, k, v, ks, vs, tbl, bse, o, ws, B, H, S, bs, W, kv_int8, body, n_split,
                                    sm_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
