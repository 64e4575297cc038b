// Paged attention over the serving page pool: decode, chunked prefill and
// the fused mixed step, as CUDA kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX package:
//   decode   -> src/repro/kernels/paged_attention.py:paged_attention_bkgd
//               (_paged_kernel)
//   prefill  -> src/repro/kernels/paged_attention.py:paged_prefill_attention_ckgd
//               (_paged_prefill_kernel)
//   mixed    -> src/repro/kernels/paged_attention.py:paged_mixed_attention_rkgd
//               (_paged_mixed_kernel)
//
// What they compute (the plain versions are src/repro_torch/kernels/ref.py):
// every query row r has a last attendable absolute position lp[r] and
// attends positions 0..lp[r] of its sequence, read through that sequence's
// block-table row; lp < 0 is a dead row and yields exact zeros (the
// max(l, 1e-30) finalize). Decode rows use lp = length - 1; mixed rows
// carry lp themselves; chunk row i of a prefill uses lp = start + i while
// i < valid and -1 past it (the Pallas kernel's mask kpos <= start + row//G,
// row//G < valid); pages at or past start + valid are never read, and
// start and valid stay device scalars.
//
// Layouts (all contiguous): q/out (N, KVH, G, D), f32 or bf16; k/v pages
// (P, page, KVH, D) in q's dtype, or int8 with f32 scales k_scale/v_scale
// (P, page, KVH); block tables int32 (N, MP) or (MP,). Accumulation is
// f32, the output is in q's dtype. D is 64, 80 or 128.
//
// int8 pages (the tiered cache's quantized pool; the int8 branch of the
// three Pallas kernels, paged_attention.py:83-107, :226-254, :382-407):
// element j of kv head h is float(x) * scale[(phys*page + j)*KVH + h]. The
// pool is read once in int8 and nothing dequantized is ever written to
// device memory: the f32 kernels multiply as they stage each page into
// shared memory; the bf16 prefill kernel stages the int8 values as bf16
// (exact: |x| <= 127) and applies the scales in registers, each score
// column times its K scale and each probability times its V scale before
// it is rounded for P.V, so no K or V value is rounded to bf16.
//
// What bounds them on the H100: the bytes of K/V read (int8 pages with
// their scales: 2 D + 8 bytes per position and kv head against 4 D in
// bf16, 0.53x at D 64). One engine step at the main path's shapes (8
// slots, KVH 5, D 64, bf16) reads a few MB per layer against 3.35 TB/s,
// i.e. microseconds; a 64-token chunk over a 320-key prefix reads 0.2 MB.
// At these sizes launch latency, load latency and each block's serial walk
// over the pages decide the time.
//
// Chunked prefill, bf16 q (paged_prefill_mma_kernel, both pool types):
// attention_mma.cuh's tile engine, as flash_attention.cu uses it. A block
// owns 64 of the chunk's C x G flattened rows for one kv head (C 64 x G 3,
// KVH 5: 3 x 5 = 15 blocks); it reads its own block-table entries and
// assembles each 64-key K/V tile from 64 / page pages (page 8 and 16
// alike; a tile that is not a whole number of live pages is masked): each
// (position, kv head) row is D contiguous elements at stride KVH x D in
// the pool, one 16-byte cp.async per chunk of a row, for bf16 and for int8
// (64 B rows at D 64). Stages go through a ring of two, so the next
// stage's loads overlap this one's products; int8 stages (and their
// scales) land raw and are widened to bf16 just before use. QK^T and P.V
// run on mma.sync m16n8k16 with f32 m, l and acc in registers. A chunk's
// grid is far smaller than the card, so its blocks are two warp groups
// that split the keys (merged by logsumexp at the end); a grid of more
// blocks than SMs (a long chunk) keeps one. Why mma.sync and not wgmma:
// the kernel is bound by latency at ~1 us of work; wgmma's 64-row
// warpgroup tiles and shared-memory descriptors add risk and no time at
// 15-32 blocks.
//
// Everything else (decode and mixed at both q types, and prefill with f32
// q) is the first version's template: one block owns a TILE of query rows
// for ONE kv head, all reading the same block-table row (the G grouped
// heads of one token for decode and mixed, grid N x KVH; 32 flattened
// chunk rows for f32 prefill). It walks the row's live pages one at a
// time, stages K and V as f32 in shared memory, computes the scores one
// thread per (row, key), an f32 online softmax one thread per row (m, l,
// acc in shared memory) and P.V one thread per (row, column). f32 stays on
// CUDA cores because it serves the f32 parity runs (TF32 off), whose
// streams must equal the plain version's; tensor-core products in TF32
// would need the 1e-3 bound loosened. Decode and mixed at bf16 are the
// next redesigns.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(), a negative code for an unsupported head dim or dtype
// (which the Python wrapper rules out before calling), or -2 when a
// pointer of the bf16 prefill kernel is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kPrefillTile = 32;

enum Mode { kDecode = 0, kPrefill = 1, kMixed = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in 4-byte words: q[tile][D], acc[tile][D], s[tile][page],
// k[page][D+1] (padded: the score loop reads k rows across lanes),
// v[page][D], m/l/corr[tile], lp[tile] (int).
__host__ __device__ inline size_t smem_words(int tile, int page, int d) {
  return (size_t)tile * (2 * d + page + 4) + (size_t)page * (2 * d + 1);
}

// T: q/out type; KV: page storage type (T, or int8_t with f32 scales)
template <typename T, typename KV, int D, int MODE>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos,    // decode: lengths (N,); mixed: last_pos
                                    // (N,); prefill: &start
    const int* __restrict__ valid,  // prefill only: &valid
    T* __restrict__ out, int n_rows, int tile, int kvh, int group, int page,
    int mp, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* acc = qs + tile * D;
  float* ss = acc + tile * D;
  float* ms = ss + tile * page;
  float* ls = ms + tile;
  float* cs = ls + tile;
  int* lps = reinterpret_cast<int*>(cs + tile);
  float* ks = reinterpret_cast<float*>(lps + tile);
  float* vs = ks + page * (D + 1);

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int base = blockIdx.x * tile;       // first flattened (token, g) row
  const int rows = min(tile, n_rows - base);
  const int* table =
      MODE == kPrefill ? tables : tables + (size_t)(base / group) * mp;

  // per-row state and the row's query, staged as f32
  for (int i = tid; i < rows; i += kThreads) {
    const int c = (base + i) / group;  // token row (chunk position for prefill)
    int lp;
    if (MODE == kDecode) {
      lp = pos[c] - 1;
    } else if (MODE == kMixed) {
      lp = pos[c];
    } else {
      lp = c < *valid ? *pos + c : -1;
    }
    lps[i] = lp;
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int gr = base + i, c = gr / group, g = gr % group;
    qs[idx] = to_f32(q[(((size_t)c * kvh + h) * group + g) * D + d]);
    acc[idx] = 0.f;
  }
  __syncthreads();

  int max_lp = -1;
  for (int i = 0; i < rows; ++i) max_lp = max(max_lp, lps[i]);
  const int n_pages = max_lp < 0 ? 0 : min(max_lp / page + 1, mp);

  for (int p = 0; p < n_pages; ++p) {
    const size_t phys = (size_t)table[p];
    for (int idx = tid; idx < page * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const size_t row = (phys * page + j) * kvh + h;  // (page, pos, head)
      const size_t off = row * D + d;
      float kx = to_f32(k_pages[off]), vx = to_f32(v_pages[off]);
      if constexpr (std::is_same<KV, int8_t>::value) {
        kx *= k_scale[row];  // dequantized on the way into shared memory
        vx *= v_scale[row];
      }
      ks[j * (D + 1) + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    // scores, masked to NEG_INF past each row's last position
    for (int idx = tid; idx < rows * page; idx += kThreads) {
      const int i = idx / page, j = idx % page;
      float s = kNegInf;
      if (p * page + j <= lps[i]) {
        const float* qr = qs + i * D;
        const float* kr = ks + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      ss[idx] = s;
    }
    __syncthreads();

    // online softmax, one thread per row; masked slots contribute exact 0
    for (int i = tid; i < rows; i += kThreads) {
      float* sr = ss + i * page;
      const float m_prev = ms[i];
      float m_new = m_prev;
      for (int j = 0; j < page; ++j) m_new = fmaxf(m_new, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < page; ++j) {
        const float e = p * page + j <= lps[i] ? expf(sr[j] - m_new) : 0.f;
        sr[j] = e;
        sum += e;
      }
      const float corr = expf(m_prev - m_new);
      ls[i] = ls[i] * corr + sum;
      ms[i] = m_new;
      cs[i] = corr;
    }
    __syncthreads();

    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      const float* pr = ss + i * page;
      float a = acc[idx] * cs[i];
      for (int j = 0; j < page; ++j) a += pr[j] * vs[j * D + d];
      acc[idx] = a;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int gr = base + i, c = gr / group, g = gr % group;
    out[(((size_t)c * kvh + h) * group + g) * D + d] =
        from_f32<T>(acc[idx] / fmaxf(ls[i], 1e-30f));
  }
}

template <typename T, typename KV, int D, int MODE>
int launch_typed(const void* q, const void* k, const void* v,
                 const float* k_scale, const float* v_scale,
                 const int* tables, const int* pos, const int* valid,
                 void* out, int n_tokens, int kvh, int group, int page, int mp,
                 float scale, cudaStream_t stream) {
  const int n_rows = n_tokens * group;
  const int tile = MODE == kPrefill ? kPrefillTile : group;
  const size_t smem = smem_words(tile, page, D) * 4;
  auto kernel = paged_attention_kernel<T, KV, D, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_rows > 0) {
    dim3 grid((n_rows + tile - 1) / tile, kvh);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), k_scale, v_scale, tables, pos, valid,
        static_cast<T*>(out), n_rows, tile, kvh, group, page, mp, scale);
  }
  return (int)cudaGetLastError();
}

// dtype: q's type, 0 = float32, 1 = bfloat16. The pages are int8 when
// k_scale is not null (v_scale with it), else of q's type.
template <int MODE>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* tables, const int* pos,
           const int* valid, void* out, int n_tokens, int kvh, int group,
           int head_dim, int page, int mp, float scale, int dtype,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr)) return -1;
#define PAGED_CASE(T, KV, DIM)                                               \
  return launch_typed<T, KV, DIM, MODE>(q, k, v, k_scale, v_scale, tables,   \
                                        pos, valid, out, n_tokens, kvh,      \
                                        group, page, mp, scale, s)
#define PAGED_DIMS(T, KV)                                                    \
  if (head_dim == 64) PAGED_CASE(T, KV, 64);                                 \
  if (head_dim == 80) PAGED_CASE(T, KV, 80);                                 \
  if (head_dim == 128) PAGED_CASE(T, KV, 128);                               \
  return -1
  if (dtype == 0 && !quant) { PAGED_DIMS(float, float); }
  if (dtype == 0 && quant) { PAGED_DIMS(float, int8_t); }
  if constexpr (MODE != kPrefill) {  // bf16 prefill: paged_prefill_mma_kernel
    if (dtype == 1 && !quant) { PAGED_DIMS(__nv_bfloat16, __nv_bfloat16); }
    if (dtype == 1 && quant) { PAGED_DIMS(__nv_bfloat16, int8_t); }
  }
#undef PAGED_DIMS
#undef PAGED_CASE
  return -1;
}

// ---------------------------------------------------------------------------
// chunked prefill with bf16 q: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace mma = attn_mma;

template <typename KV, int D, int G>
struct PrefillTile {
  using Cfg = mma::Config<D, G>;
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kStages = 2;  // K/V stages in the ring
  // q [kRows][kLd], then bf16 pages: K and V [kStages][G x kKeys][kLd];
  // int8 pages: K and V [G x kKeys][kLd] (the int8 values as bf16), raw K
  // and V [kStages][G x kKeys][D] int8, their scales [kStages][G x kKeys]
  // f32.
  // The merge of the groups reuses the K/V tiles.
  static constexpr size_t kTileBytes =
      (size_t)2 * (kQuant ? 1 : kStages) * Cfg::kStage * 2;
  static constexpr size_t kRawBytes =
      kQuant ? (size_t)kStages * Cfg::kStageKeys * (2 * D + 8) : 0;
  static_assert(Cfg::kMergeBytes <= kTileBytes, "merge buffer");
  static_assert(Cfg::kThreads == 2 * Cfg::kStageKeys, "one scale a thread");
  static constexpr size_t kSmemBytes =
      (size_t)mma::kRows * Cfg::kLd * 2 + kTileBytes + kRawBytes;
  // the int8 path's scale loads need a few more registers than 128 at D 64
  static constexpr int kMinBlocks =
      kQuant && G == 1 && D <= 64 ? 3 : Cfg::kMinBlocks;
};

// 8 int8 values -> 8 bf16, exactly (|x| <= 127 needs 7 bits; one 16-byte
// store)
__device__ __forceinline__ void widen8(__nv_bfloat16* dst,
                                       const int8_t* src) {
  const uint2 w = *reinterpret_cast<const uint2*>(src);
  const int8_t* x = reinterpret_cast<const int8_t*>(&w);
  uint4 o;
  o.x = mma::pack_bf16((float)x[0], (float)x[1]);
  o.y = mma::pack_bf16((float)x[2], (float)x[3]);
  o.z = mma::pack_bf16((float)x[4], (float)x[5]);
  o.w = mma::pack_bf16((float)x[6], (float)x[7]);
  *reinterpret_cast<uint4*>(dst) = o;
}

template <typename KV, int D, int G>
__global__ void __launch_bounds__(mma::Config<D, G>::kThreads,
                                  PrefillTile<KV, D, G>::kMinBlocks)
    paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const KV* __restrict__ k_pages,
                             const KV* __restrict__ v_pages,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ table,
                             const int* __restrict__ start_p,
                             const int* __restrict__ valid_p,
                             __nv_bfloat16* __restrict__ out, int n_rows,
                             int kvh, int group, int page, int mp,
                             float scale_log2) {
  using Cfg = mma::Config<D, G>;
  using Tile = PrefillTile<KV, D, G>;
  constexpr bool kQuant = Tile::kQuant;
  constexpr int LD = Cfg::kLd, CH = Cfg::kChunks, NT = Cfg::kThreads;
  constexpr int ROWS = mma::kRows;
  constexpr int NS = Tile::kStages, SK = Cfg::kStageKeys;
  constexpr int RCH = kQuant ? D / 16 : CH;  // 16-byte chunks of a pool row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + ROWS * LD;
  __nv_bfloat16* vs = ks + (kQuant ? 1 : NS) * Cfg::kStage;
  // int8 pages only: the raw ring and its scales
  int8_t* kraw = reinterpret_cast<int8_t*>(vs + (kQuant ? 1 : NS) * Cfg::kStage);
  int8_t* vraw = kraw + NS * SK * D;
  float* ksc = reinterpret_cast<float*>(vraw + NS * SK * D);
  float* vsc = ksc + NS * SK;

  const int start = *start_p, valid = *valid_p;
  const int h = blockIdx.y;
  const int base = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / mma::kGroupThreads;  // warp group: its key tiles
  const int wr = (tid % mma::kGroupThreads) >> 5;  // warp: its 16 rows
  // the last position a flattened (chunk row, g) row attends; -1: dead
  auto lim_of = [&](int r) {
    return r < n_rows && r / group < valid ? start + r / group : -1;
  };
  // the block's last live row decides how far its pages go
  const int r_hi = min(min(base + ROWS, n_rows), valid * group) - 1;
  const int n_keys = r_hi < base ? 0 : min(lim_of(r_hi) + 1, mp * page);
  const int n_stages = (n_keys + SK - 1) / SK;

  for (int idx = tid; idx < ROWS * CH; idx += NT) {
    const int i = idx / CH, c = idx % CH, r = base + i;
    const bool ok = lim_of(r) >= 0;  // dead rows stage zeros
    const __nv_bfloat16* src =
        ok ? q + (((size_t)(r / group) * kvh + h) * group + r % group) * D +
                 c * 8
           : q;
    mma::cp_async_16(qs + i * LD + c * 8, src, ok);
  }
  // the pool row of key position kpos for this kv head
  auto pool_row = [&](int kpos) {
    return ((size_t)table[kpos / page] * page + kpos % page) * kvh + h;
  };
  auto load_kv = [&](int t) {  // stage t into slot t % NS; zeros past n_keys
    const int k0 = t * SK;
    for (int idx = tid; idx < SK * RCH; idx += NT) {
      const int j = idx / RCH, c = idx % RCH;
      const bool ok = k0 + j < n_keys;
      const size_t src = ok ? pool_row(k0 + j) * D + c * (16 / sizeof(KV)) : 0;
      if constexpr (kQuant) {
        const int dst = ((t % NS) * SK + j) * D + c * 16;
        mma::cp_async_16(kraw + dst, k_pages + src, ok);
        mma::cp_async_16(vraw + dst, v_pages + src, ok);
      } else {
        const int dst = (t % NS) * Cfg::kStage + j * LD + c * 8;
        mma::cp_async_16(ks + dst, k_pages + src, ok);
        mma::cp_async_16(vs + dst, v_pages + src, ok);
      }
    }
    if constexpr (kQuant) {  // the first SK threads: K scales, the rest: V
      const int j = tid % SK;
      const bool ok = k0 + j < n_keys;
      const size_t row = ok ? pool_row(k0 + j) : 0;
      const bool is_k = tid < SK;
      mma::cp_async_4((is_k ? ksc : vsc) + (t % NS) * SK + j,
                      (is_k ? k_scale : v_scale) + row, ok);
    }
  };
  // one commit group per stage (the q rows ride with stage 0), NS - 1 ahead
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < n_stages) load_kv(t);
    mma::cp_async_commit();
  }

  const int wrow0 = base + wr * 16;  // the warp's first row
  const mma::RowLimits lim(lim_of(wrow0 + (lane & 15)));
  mma::WarpAttention<D> att;
  att.init();
  __nv_bfloat16* qw = qs + wr * 16 * LD;
  for (int t = 0; t < n_stages; ++t) {
    mma::cp_async_wait<NS - 2>();
    __syncthreads();  // stage t visible; every warp is done with t - 1
    if (t + NS - 1 < n_stages) load_kv(t + NS - 1);  // the slot of t - 1
    mma::cp_async_commit();
    const int k0 = t * SK + wg * mma::kKeys;  // this group's tile
    if constexpr (kQuant) {  // raw slot t % NS -> the bf16 tiles
      constexpr int C8 = D / 8;
      for (int idx = tid; idx < SK * C8; idx += NT) {
        const int j = idx / C8, c = idx % C8;
        const int src = ((t % NS) * SK + j) * D + c * 8;
        widen8(ks + j * LD + c * 8, kraw + src);
        widen8(vs + j * LD + c * 8, vraw + src);
      }
      __syncthreads();
      const int sc = (t % NS) * SK + wg * mma::kKeys;
      if (lim.live(k0))
        att.template tile<true>(qw, ks + wg * mma::kKeys * LD,
                                vs + wg * mma::kKeys * LD, k0, lim,
                                lim.masked(k0), scale_log2, ksc + sc,
                                vsc + sc);
    } else {
      const size_t off = (size_t)(t % NS) * Cfg::kStage + wg * mma::kKeys * LD;
      if (lim.live(k0))
        att.tile(qw, ks + off, vs + off, k0, lim, lim.masked(k0), scale_log2);
    }
  }
  if (n_stages == 0) {  // no live row: the q copies must land first
    mma::cp_async_wait<0>();
    __syncthreads();
  }
  mma::merge_groups<D, G>(att, reinterpret_cast<float*>(ks));
  if (wg == 0)
    att.finish(qw, [&](int i) -> __nv_bfloat16* {
      const int r = wrow0 + i;
      if (r >= n_rows) return nullptr;
      return out + (((size_t)(r / group) * kvh + h) * group + r % group) * D;
    });
}

template <typename KV, int D, int G>
int launch_prefill_groups(const void* q, const void* k, const void* v,
                          const float* k_scale, const float* v_scale,
                          const int* table, const int* start,
                          const int* valid, void* out, int c, int kvh,
                          int group, int page, int mp, float scale,
                          cudaStream_t stream) {
  using Cfg = mma::Config<D, G>;
  const size_t smem = PrefillTile<KV, D, G>::kSmemBytes;
  auto kernel = paged_prefill_mma_kernel<KV, D, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int threads = Cfg::kThreads;
  const int n_rows = c * group;
  if (n_rows > 0) {
    dim3 grid((n_rows + mma::kRows - 1) / mma::kRows, kvh);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), k_scale, v_scale, table, start, valid,
        static_cast<__nv_bfloat16*>(out), n_rows, kvh, group, page, mp,
        scale * mma::kLog2e);
  }
  return (int)cudaGetLastError();
}

template <typename KV, int D>
int launch_prefill_mma(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale,
                       const int* table, const int* start, const int* valid,
                       void* out, int c, int kvh, int group, int page, int mp,
                       float scale, cudaStream_t stream) {
  if (!mma::aligned16(q, k, v, out)) return -2;
  const int blocks = (c * group + mma::kRows - 1) / mma::kRows * kvh;
  if (mma::warp_groups(blocks) == 2)
    return launch_prefill_groups<KV, D, 2>(q, k, v, k_scale, v_scale, table,
                                           start, valid, out, c, kvh, group,
                                           page, mp, scale, stream);
  return launch_prefill_groups<KV, D, 1>(q, k, v, k_scale, v_scale, table,
                                         start, valid, out, c, kvh, group,
                                         page, mp, scale, stream);
}

template <typename KV, int D, int G>
int prefill_mma_info_groups(int* info) {
  auto kernel = paged_prefill_mma_kernel<KV, D, G>;
  const int smem = (int)PrefillTile<KV, D, G>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, mma::Config<D, G>::kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return 0;
}

template <typename KV, int D>
int prefill_mma_info(int groups, int* info) {
  if (groups == 1) return prefill_mma_info_groups<KV, D, 1>(info);
  if (groups == 2) return prefill_mma_info_groups<KV, D, 2>(info);
  return -1;
}

}  // namespace

extern "C" {

// Every entry point takes k_scale/v_scale (P, page, KVH) f32 for int8
// pages, or two null pointers for pages of q's type.

// q (B, KVH, G, D); block_tables (B, MP); lengths (B,) -> out (B, KVH, G, D)
int paged_attention_decode(const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scale,
                           const float* v_scale, const int* block_tables,
                           const int* lengths, void* out, int b, int kvh,
                           int group, int head_dim, int page, int mp,
                           float scale, int dtype, void* stream) {
  return launch<kDecode>(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                         lengths, nullptr, out, b, kvh, group, head_dim, page,
                         mp, scale, dtype, stream);
}

// q (C, KVH, G, D); block_table (MP,); start, valid: device int32 scalars
int paged_attention_prefill(const void* q, const void* k_pages,
                            const void* v_pages, const float* k_scale,
                            const float* v_scale, const int* block_table,
                            const int* start, const int* valid, void* out,
                            int c, int kvh, int group, int head_dim, int page,
                            int mp, float scale, int dtype, void* stream) {
  if (dtype == 1) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((k_scale != nullptr) != (v_scale != nullptr)) return -1;
#define MMA_CASE(KV, DIM)                                                    \
  return launch_prefill_mma<KV, DIM>(q, k_pages, v_pages, k_scale, v_scale,  \
                                     block_table, start, valid, out, c, kvh, \
                                     group, page, mp, scale, s)
#define MMA_DIMS(KV)                                                         \
  if (head_dim == 64) MMA_CASE(KV, 64);                                      \
  if (head_dim == 80) MMA_CASE(KV, 80);                                      \
  if (head_dim == 128) MMA_CASE(KV, 128);                                    \
  return -1
    if (k_scale == nullptr) { MMA_DIMS(__nv_bfloat16); }
    MMA_DIMS(int8_t);
#undef MMA_DIMS
#undef MMA_CASE
  }
  return launch<kPrefill>(q, k_pages, v_pages, k_scale, v_scale, block_table,
                          start, valid, out, c, kvh, group, head_dim, page,
                          mp, scale, dtype, stream);
}

// The bf16 prefill kernel at head_dim over bf16 (quant 0) or int8 (quant 1)
// pages with 1 or 2 warp groups, as the card runs it: info[0] registers a
// thread, [1] local (spilled) bytes a thread, [2] dynamic shared memory
// bytes a block, [3] blocks resident per SM. Returns 0 or a CUDA error.
int paged_attention_prefill_mma_info(int head_dim, int quant, int groups,
                                     int* info) {
#define INFO_DIMS(KV)                                                        \
  if (head_dim == 64) return prefill_mma_info<KV, 64>(groups, info);         \
  if (head_dim == 80) return prefill_mma_info<KV, 80>(groups, info);         \
  if (head_dim == 128) return prefill_mma_info<KV, 128>(groups, info);       \
  return -1
  if (quant) { INFO_DIMS(int8_t); }
  INFO_DIMS(__nv_bfloat16);
#undef INFO_DIMS
}

// q (R, KVH, G, D); block_tables (R, MP); last_pos (R,) -> out (R, KVH, G, D)
int paged_attention_mixed(const void* q, const void* k_pages,
                          const void* v_pages, const float* k_scale,
                          const float* v_scale, const int* block_tables,
                          const int* last_pos, void* out, int r, int kvh,
                          int group, int head_dim, int page, int mp,
                          float scale, int dtype, void* stream) {
  return launch<kMixed>(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                        last_pos, nullptr, out, r, kvh, group, head_dim, page,
                        mp, scale, dtype, stream);
}

}  // extern "C"
