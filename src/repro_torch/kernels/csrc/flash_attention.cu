// Dense grouped-query flash attention (forward) as CUDA kernels for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention.py:flash_attention_bhsd (_flash_kernel)
//
// What it computes (the plain versions are src/repro_torch/kernels/ref.py
// flash_attention_ref / flash_attention_chunked): for every batch row b and
// query head h, softmax(scale * q k^T) v over kv head h / G (G = H / KVH),
// K/V never repeated. Causal: the Sq queries are the LAST Sq of the Skv
// positions (q_offset = Skv - Sq) and query i attends keys <= q_offset + i.
// The softmax is online over 64-key tiles in f32 (m, l, acc), l floored at
// 1e-30, the output cast to q's dtype, as in the Pallas kernel.
//
// Layouts (all contiguous): q/out (B, H, Sq, D); k/v (B, KVH, Skv, D).
// Inputs f32 or bf16 (one type for all three), D 64, 80 or 128.
//
// The Pallas kernel walks a sequential grid of (b, h, q block, kv block)
// with the online-softmax state in VMEM scratch. Here blocks run in
// parallel and nothing carries between them, so a block owns one
// (b, kv head) and a tile of flattened (query position, grouped head) rows
// and loops over the K/V tiles itself; each staged K/V tile serves every
// grouped head of the block. Both kernels below are built so, and in both
// causal blocks read no K/V tile past their last query; warps skip tiles
// that lie wholly after their own queries and mask only the tiles that
// need it; ragged
// last query and key tiles are masked in the kernel, so any Sq <= Skv
// works (the JAX op's Skv-multiple-of-256 rule is the caller's); row
// tiles are issued heaviest first.
//
// What bounds it on the H100: at the engine's shapes (lockstep B 8 x 256
// tokens, whole-prompt B 1 x 512; 15 q / 5 kv heads, D 64, bf16) the least
// time is the bytes of q, k, v and out (10.5 MB and 2.6 MB: ~3.1 and ~0.8
// us at 3.35 TB/s); the ~1 GFLOP of the lockstep shape takes ~1 us at the
// bf16 tensor-core peak. At these sizes a launch is a few hundred short
// blocks, so what decides the time is the launch itself, each block's
// first loads and last stores, and the serial chain of K/V tiles a block
// walks: the tile work must be short, run on tensor cores, and overlap the
// next tile's loads.
//
// bf16 (flash_attention_mma_kernel): attention_mma.cuh's tile engine. A
// block owns 64 flattened rows, 16 a warp; K/V stages stay bf16 in shared
// memory, in a ring of two filled by cp.async, so the next stage's loads
// overlap this one's products; QK^T and P.V both run on mma.sync m16n8k16
// with m, l and acc in f32 registers and P reused from registers as the A
// operand; each probability costs one FFMA and one ex2.approx, and a
// masked score is -inf, so masking is one select. D 64, 80 and 128 map
// without padding (k-steps D/16, n-tiles D/8). When the grid has no more
// blocks than the card has SMs (whole-prompt: 1536 / 64 rows x 5 kv heads
// = 120) a block is two warp groups that split its keys (alternate 64-key
// tiles, merged by logsumexp at the end), which halves its serial chain;
// a larger grid (lockstep: 12 x 5 x 8 = 480, or 32 heads at D 128 / 80)
// keeps one group, so that more blocks fit per SM. Shared memory: q 64 x
// (D + 8) x 2 B plus the ring, 46 KB (one group) / 83 KB (two) at D 64.
// Why mma.sync and not wgmma: at 1-3 us of work the kernel is bound by
// latency, not by tensor-core rate; wgmma needs 64-row warpgroup tiles
// and shared-memory descriptors with a fixed swizzle, which add risk and
// no time at 120-480 blocks.
//
// f32 (flash_attention_kernel, unchanged from the first version but for
// the row statistics below): CUDA-core f32 FMAs, 8 warps over 192 / 128
// rows (12-24 a warp), K/V staged as f32 (D 80 staged as 96 zero-padded
// columns). It stays on CUDA cores because it serves the f32 parity runs
// (TF32 off), whose token streams must equal the plain version's:
// tensor-core products in TF32 would need the 1e-3 bound loosened.
//
// Row statistics: given a non-null lse pointer (f32 (B, H, Sq)), either
// kernel also writes each row's natural-log logsumexp of its scaled, masked
// scores, m + ln(max(l, 1e-30)) (a row with no key: -1e30 + ln(1e-30)),
// which the backward (flash_backward.cu) reads instead of recomputing the
// softmax. It is a template flag (kLse): the serving launches, which pass
// no pointer, compile to the kernels they were before it.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(), -1 for an unsupported head dim or dtype (which the
// Python wrapper rules out before calling), or -2 when a bf16 pointer is
// not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;  // keys per K/V tile: two per lane

template <int D>
struct Tile {
  static constexpr int kDP = (D + 31) / 32 * 32;  // staged columns
  static constexpr int kRowsPerWarp = D == 64 ? 24 : D == 80 ? 16 : 12;
  static constexpr int kRows = kWarps * kRowsPerWarp;
  static constexpr int kCols = kDP / 32;    // output columns per lane
  static constexpr int kKStride = kDP + 4;  // padded K rows: float4 reads
                                            // across lanes hit distinct banks
  // shared memory, in floats: q [rows][DP], K [kBK][DP+4], V [kBK][DP],
  // P [warps][rows per warp][kBK]
  static constexpr size_t kSmemFloats = (size_t)kRows * kDP +
                                        (size_t)kBK * kKStride +
                                        (size_t)kBK * kDP +
                                        (size_t)kRows * kBK;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int h, int kvh, int sq, int skv, int causal, float scale) {
  using Cfg = Tile<D>;
  constexpr int RPW = Cfg::kRowsPerWarp;
  constexpr int ROWS = Cfg::kRows;
  constexpr int COLS = Cfg::kCols;
  constexpr int KS = Cfg::kKStride;
  constexpr int DP = Cfg::kDP;
  constexpr bool kPadded = DP != D;  // D 80: guard the columns past D
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + ROWS * DP;
  float* vs = ks + kBK * KS;
  float* ps = vs + kBK * DP;

  const int group = h / kvh;
  const int n_rows = sq * group;  // flattened (position, g) rows
  const int base = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int q_offset = skv - sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the block's queries, f32 and scaled before the dot (the reference's
  // order); rows past the last query and columns past D are zeros, and
  // neither is written back
  for (int idx = tid; idx < ROWS * DP; idx += kThreads) {
    const int i = idx / DP, d = idx % DP, r = base + i;
    float x = 0.f;
    if (r < n_rows && (!kPadded || d < D)) {
      const int pos = r / group, g = r % group;
      x = to_f32(q[(((size_t)b * h + hk * group + g) * sq + pos) * D + d]) *
          scale;
    }
    qs[idx] = x;
  }

  const int wrow0 = base + warp * RPW;  // this warp's first flattened row
  const int wrows = max(0, min(RPW, n_rows - wrow0));
  const int wpos_lo = wrow0 / group;
  const int wpos_hi = (wrow0 + max(wrows, 1) - 1) / group;
  const int last_row = min(base + ROWS, n_rows) - 1;
  const int n_keys = causal ? min(skv, q_offset + last_row / group + 1) : skv;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  float* pw = ps + warp * RPW * kBK;

  float acc[RPW][COLS], m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const size_t kv_base = (((size_t)b * kvh + hk) * skv + k0) * D;
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int j = idx / DP, d = idx % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < skv && (!kPadded || d < D)) {
        const size_t off = kPadded ? (size_t)j * D + d : idx;
        kx = to_f32(k[kv_base + off]);
        vx = to_f32(v[kv_base + off]);
      }
      ks[j * KS + d] = kx;
      vs[idx] = vx;
    }
    __syncthreads();

    // a warp with no live rows, or (causal) whose queries all precede the
    // tile, has nothing to add: every key of the tile is masked for it
    if (wrows > 0 && (!causal || k0 <= q_offset + wpos_hi)) {
      float s[RPW][2];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i][0] = s[i][1] = 0.f;
      const float* ka_p = ks + lane * KS;
      const float* kb_p = ks + (lane + 32) * KS;
      const float* qw = qs + warp * RPW * DP;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(ka_p + d);
        const float4 kb = *reinterpret_cast<const float4*>(kb_p + d);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + i * DP + d);
          s[i][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
          s[i][1] += qv.x * kb.x + qv.y * kb.y + qv.z * kb.z + qv.w * kb.w;
        }
      }
      // no mask needed when every key of the tile is real and at or before
      // every live row's position
      const bool full = k0 + kBK <= skv && wrows == RPW &&
                        (!causal || k0 + kBK - 1 <= q_offset + wpos_lo);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        bool ok0 = true, ok1 = true;
        if (!full) {
          const int lim = i >= wrows ? -1
                          : causal   ? min(skv - 1, q_offset + (wrow0 + i) / group)
                                     : skv - 1;
          ok0 = k0 + lane <= lim;
          ok1 = k0 + lane + 32 <= lim;
        }
        const float s0 = ok0 ? s[i][0] : kNegInf;
        const float s1 = ok1 ? s[i][1] : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
        const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
        const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p0 + p1);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] *= corr;
        pw[i * kBK + lane] = p0;
        pw[i * kBK + lane + 32] = p1;
      }
      __syncwarp();
#pragma unroll 2
      for (int j = 0; j < kBK; j += 4) {
        float vv[4][COLS];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            vv[u][c] = vs[(j + u) * DP + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + i * kBK + j);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            acc[i][c] += p4.x * vv[0][c] + p4.y * vv[1][c] + p4.z * vv[2][c] +
                         p4.w * vv[3][c];
        }
      }
    }
    __syncthreads();  // the tile is consumed before the next one lands
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i < wrows) {
      const int r = wrow0 + i, pos = r / group, g = r % group;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* o = out + (((size_t)b * h + hk * group + g) * sq + pos) * D;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (!kPadded || lane + 32 * c < D)
          o[lane + 32 * c] = from_f32<T>(acc[i][c] * inv);
      if constexpr (kLse) {
        if (lane == 0)
          lse[((size_t)b * h + hk * group + g) * sq + pos] =
              m[i] + logf(fmaxf(l[i], 1e-30f));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace mma = attn_mma;

template <int D, int G>
struct MmaTile {
  using Cfg = mma::Config<D, G>;
  static constexpr int kStages = 2;  // K/V stages in the ring
  // q [kRows][kLd], then K and V [kStages][G x kKeys][kLd]; the merge of
  // the groups reuses the ring
  static constexpr size_t kRingBytes =
      (size_t)2 * kStages * Cfg::kStage * sizeof(__nv_bfloat16);
  static_assert(Cfg::kMergeBytes <= kRingBytes, "merge buffer");
  static constexpr size_t kSmemBytes =
      (size_t)mma::kRows * Cfg::kLd * sizeof(__nv_bfloat16) + kRingBytes;
};

template <int D, int G, bool kLse>
__global__ void __launch_bounds__(mma::Config<D, G>::kThreads,
                                  mma::Config<D, G>::kMinBlocks)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, int h, int kvh,
                               int sq, int skv, int causal,
                               float scale_log2) {
  using Cfg = mma::Config<D, G>;
  constexpr int LD = Cfg::kLd, CH = Cfg::kChunks, NT = Cfg::kThreads;
  constexpr int ROWS = mma::kRows;
  constexpr int NS = MmaTile<D, G>::kStages, SK = Cfg::kStageKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + ROWS * LD;  // [NS][SK][LD]
  __nv_bfloat16* vs = ks + NS * Cfg::kStage;

  const int group = h / kvh;
  const int n_rows = sq * group;  // flattened (position, g) rows
  const int base = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_offset = skv - sq;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / mma::kGroupThreads;  // warp group: its key tiles
  const int wr = (tid % mma::kGroupThreads) >> 5;  // warp: its 16 rows
  // the last key a flattened row attends; -1 past the last row
  auto lim_of = [&](int r) {
    return r >= n_rows ? -1
           : causal    ? min(skv - 1, q_offset + r / group)
                       : skv - 1;
  };
  const int n_keys = lim_of(min(base + ROWS, n_rows) - 1) + 1;
  const int n_stages = (n_keys + SK - 1) / SK;
  const __nv_bfloat16* kh = k + ((size_t)b * kvh + hk) * skv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * kvh + hk) * skv * D;

  // the block's query rows (zeros past the last), in the first group
  for (int idx = tid; idx < ROWS * CH; idx += NT) {
    const int i = idx / CH, c = idx % CH, r = base + i;
    const bool ok = r < n_rows;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * h + hk * group + r % group) * sq + r / group) *
                     D + c * 8
           : q;
    mma::cp_async_16(qs + i * LD + c * 8, src, ok);
  }
  auto load_kv = [&](int t) {  // stage t into slot t % NS; zeros past skv
    const int k0 = t * SK;
    __nv_bfloat16* kd = ks + (t % NS) * Cfg::kStage;
    __nv_bfloat16* vd = vs + (t % NS) * Cfg::kStage;
    for (int idx = tid; idx < SK * CH; idx += NT) {
      const int j = idx / CH, c = idx % CH;
      const bool ok = k0 + j < skv;
      const size_t off = ok ? (size_t)(k0 + j) * D + c * 8 : 0;
      mma::cp_async_16(kd + j * LD + c * 8, kh + off, ok);
      mma::cp_async_16(vd + j * LD + c * 8, vh + off, ok);
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
    const size_t off = (size_t)(t % NS) * Cfg::kStage + wg * mma::kKeys * LD;
    if (lim.live(k0))
      att.tile(qw, ks + off, vs + off, k0, lim, lim.masked(k0), scale_log2);
  }
  if (n_stages == 0) {  // no key at all: the q copies must land first
    mma::cp_async_wait<0>();
    __syncthreads();
  }
  mma::merge_groups<D, G>(att, reinterpret_cast<float*>(ks));
  if (wg == 0) {
    if constexpr (kLse) {  // m is log2-domain: lse = (m + log2 l) ln 2
      const float l0 = mma::quad_sum(att.l[0]), l1 = mma::quad_sum(att.l[1]);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = wrow0 + (lane >> 2) + 8 * e;
          if (r < n_rows)
            lse[((size_t)b * h + hk * group + r % group) * sq + r / group] =
                (att.m[e] + log2f(fmaxf(e ? l1 : l0, 1e-30f))) * kLn2;
        }
      }
    }
    att.finish(qw, [&](int i) -> __nv_bfloat16* {
      const int r = wrow0 + i;
      if (r >= n_rows) return nullptr;
      return out +
             (((size_t)b * h + hk * group + r % group) * sq + r / group) * D;
    });
  }
}

template <int D, int G, bool kLse>
int launch_groups(const void* q, const void* k, const void* v, void* out,
                  float* lse, int b, int h, int kvh, int sq, int skv,
                  int causal, float scale, cudaStream_t stream) {
  using Cfg = mma::Config<D, G>;
  const size_t smem = MmaTile<D, G>::kSmemBytes;
  auto kernel = flash_attention_mma_kernel<D, G, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int threads = Cfg::kThreads;
  const int n_rows = sq * (h / kvh);
  if (b > 0 && n_rows > 0) {
    dim3 grid((n_rows + mma::kRows - 1) / mma::kRows, kvh, b);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, h, kvh, sq, skv, causal,
        scale * mma::kLog2e);
  }
  return (int)cudaGetLastError();
}

template <int D, bool kLse>
int launch_lse(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int h, int kvh, int sq, int skv, int causal,
               float scale, cudaStream_t stream) {
  const int blocks = (sq * (h / kvh) + mma::kRows - 1) / mma::kRows * kvh * b;
  if (mma::warp_groups(blocks) == 2)
    return launch_groups<D, 2, kLse>(q, k, v, out, lse, b, h, kvh, sq, skv,
                                     causal, scale, stream);
  return launch_groups<D, 1, kLse>(q, k, v, out, lse, b, h, kvh, sq, skv,
                                   causal, scale, stream);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int b, int h, int kvh, int sq, int skv, int causal,
               float scale, cudaStream_t stream) {
  if (!mma::aligned16(q, k, v, out)) return -2;
  if (lse != nullptr)
    return launch_lse<D, true>(q, k, v, out, lse, b, h, kvh, sq, skv, causal,
                               scale, stream);
  return launch_lse<D, false>(q, k, v, out, lse, b, h, kvh, sq, skv, causal,
                              scale, stream);
}

template <int D, int G>
int mma_info_groups(int* info) {
  auto kernel = flash_attention_mma_kernel<D, G, false>;
  const int smem = (int)MmaTile<D, G>::kSmemBytes;
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

template <int D>
int mma_info(int groups, int* info) {
  if (groups == 1) return mma_info_groups<D, 1>(info);
  if (groups == 2) return mma_info_groups<D, 2>(info);
  return -1;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel above
// ---------------------------------------------------------------------------

template <typename T, int D, bool kLse>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int b, int h, int kvh, int sq, int skv,
                 int causal, float scale, cudaStream_t stream) {
  using Cfg = Tile<D>;
  const size_t smem = Cfg::kSmemFloats * sizeof(float);
  auto kernel = flash_attention_kernel<T, D, kLse>;
  // the opt-in above 48 KB is per device: made on every launch
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = sq * (h / kvh);
  if (b > 0 && n_rows > 0) {
    dim3 grid((n_rows + mma::kRows - 1) / mma::kRows, kvh, b);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, h, kvh, sq,
        skv, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, D); k/v (B, KVH, Skv, D) -> out (B, H, Sq, D) and, where
// lse is not null, each row's logsumexp into lse (B, H, Sq) f32.
// dtype: 0 = float32, 1 = bfloat16
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* out, void* lse_ptr, int b, int h, int kvh,
                            int sq, int skv, int head_dim, int causal,
                            float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
#define FLASH_CASE(DIM)                                                       \
  return lse ? launch_typed<float, DIM, true>(q, k, v, out, lse, b, h, kvh,   \
                                              sq, skv, causal, scale, s)      \
             : launch_typed<float, DIM, false>(q, k, v, out, lse, b, h, kvh,  \
                                               sq, skv, causal, scale, s)
#define MMA_CASE(DIM) \
  return launch_mma<DIM>(q, k, v, out, lse, b, h, kvh, sq, skv, causal, scale, s)
  if (dtype == 0 && head_dim == 64) FLASH_CASE(64);
  if (dtype == 0 && head_dim == 80) FLASH_CASE(80);
  if (dtype == 0 && head_dim == 128) FLASH_CASE(128);
  if (dtype == 1 && head_dim == 64) MMA_CASE(64);
  if (dtype == 1 && head_dim == 80) MMA_CASE(80);
  if (dtype == 1 && head_dim == 128) MMA_CASE(128);
#undef MMA_CASE
#undef FLASH_CASE
  return -1;
}

// The bf16 kernel at head_dim with 1 or 2 warp groups as the card runs it:
// info[0] registers a thread, [1] local (spilled) bytes a thread, [2]
// dynamic shared memory bytes a block, [3] blocks resident per SM. Returns
// 0 or a CUDA error.
int flash_attention_mma_info(int head_dim, int groups, int* info) {
  if (head_dim == 64) return mma_info<64>(groups, info);
  if (head_dim == 80) return mma_info<80>(groups, info);
  if (head_dim == 128) return mma_info<128>(groups, info);
  return -1;
}

}  // extern "C"
