// Dense grouped-query flash attention (forward) as a CUDA kernel for Hopper
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
// Inputs f32 or bf16 (one type for all three), D 64, 80 or 128. The staged
// q, K and V tiles are DP = D rounded up to a multiple of 32 columns wide
// (96 for D 80; zeros past D), so every lane owns DP / 32 whole output
// columns; the zero columns add nothing to a dot product and are never
// written back.
//
// Design. The Pallas kernel walks a sequential grid of (b, h, q block, kv
// block) with the online-softmax state in VMEM scratch. Here blocks run in
// parallel and nothing carries between them, so one block owns one
// (b, kv head) and a tile of flattened (query position, grouped head) rows
// — 192 rows at D 64, i.e. 64 query positions of all 3 heads of a smollm
// group — and loops over the K/V tiles itself. Each K/V tile is staged in
// shared memory (as f32) once and serves every grouped head of the block.
// Each of the 8 warps owns 24 rows (12 at D 128): a lane computes the
// scores of two keys for all of the warp's rows (CUDA-core f32 FMAs over
// float4 reads of the staged q and K), the row max and sum are warp
// shuffles, the probabilities go through the warp's slice of shared memory,
// and a lane accumulates P.V for D/32 output columns; m, l and acc live in
// registers. Causal blocks read no K/V tile past their last query, warps
// skip tiles that lie wholly after their own queries, and the ragged last
// query and key tiles are masked inside the kernel, so any Sq <= Skv works
// (the JAX op's Skv-multiple-of-256 rule is the caller's, not this
// kernel's). Row tiles are issued heaviest first.
//
// What bounds it on the H100: at the engine's shapes (lockstep B 8 x 256
// tokens, whole-prompt B 1 x 512; 15 q / 5 kv heads, D 64, bf16) the least
// time is the bytes of q, k, v and out (10.5 MB and 2.6 MB: ~3.1 and ~0.8
// us at 3.35 TB/s); the ~1 GFLOP of the lockstep shape takes ~1 us at the
// bf16 tensor-core peak. This first version does its products on CUDA
// cores in f32 (67 TFLOP/s: ~15 us for that GFLOP) and loads synchronously,
// with one 129 KB block per SM, so it is bound by FMA issue and shared-
// memory reads, not bytes. Tensor cores (mma.sync / wgmma) for both
// products and asynchronous tile loads are the next steps.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or -1 for an unsupported head dim or dtype, which the
// Python wrapper rules out before calling).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int h, int kvh, int sq,
    int skv, int causal, float scale) {
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
    }
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int b, int h, int kvh, int sq, int skv, int causal,
                 float scale, cudaStream_t stream) {
  using Cfg = Tile<D>;
  const size_t smem = Cfg::kSmemFloats * sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  // the opt-in above 48 KB is per device: made on every launch
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = sq * (h / kvh);
  if (b > 0 && n_rows > 0) {
    dim3 grid((n_rows + Cfg::kRows - 1) / Cfg::kRows, kvh, b);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), h, kvh, sq, skv,
        causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, D); k/v (B, KVH, Skv, D) -> out (B, H, Sq, D).
// dtype: 0 = float32, 1 = bfloat16
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* out, int b, int h, int kvh, int sq, int skv,
                            int head_dim, int causal, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(T, DIM) \
  return launch_typed<T, DIM>(q, k, v, out, b, h, kvh, sq, skv, causal, scale, s)
  if (dtype == 0 && head_dim == 64) FLASH_CASE(float, 64);
  if (dtype == 0 && head_dim == 80) FLASH_CASE(float, 80);
  if (dtype == 0 && head_dim == 128) FLASH_CASE(float, 128);
  if (dtype == 1 && head_dim == 64) FLASH_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 80) FLASH_CASE(__nv_bfloat16, 80);
  if (dtype == 1 && head_dim == 128) FLASH_CASE(__nv_bfloat16, 128);
#undef FLASH_CASE
  return -1;
}

}  // extern "C"
