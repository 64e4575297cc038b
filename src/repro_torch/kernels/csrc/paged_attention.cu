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
// i < valid and -1 past it.
//
// Layouts (all contiguous): q/out (N, KVH, G, D), f32 or bf16; k/v pages
// (P, page, KVH, D) in q's dtype, or int8 with f32 scales k_scale/v_scale
// (P, page, KVH); block tables int32 (N, MP) or (MP,). Accumulation is
// f32, the output is in q's dtype. D is 64, 80 or 128.
//
// int8 pages (the tiered cache's quantized pool; the int8 branch of the
// three Pallas kernels, paged_attention.py:83-107, :226-254, :382-407):
// each element is dequantized as float(k) * k_scale[(phys*page + j)*KVH + h]
// while the page is staged into the f32 shared tile, so the pool is read
// once in int8 and nothing dequantized is ever written to device memory.
// The rest of each mode is the same code as for bf16/f32 pages.
//
// Design. One thread block owns a TILE of query rows for ONE kv head, all
// reading the same block-table row: the G grouped heads of one token for
// decode and mixed (grid N x KVH), or a tile of the chunk's C*G flattened
// rows for prefill (grid ceil(C*G/TILE) x KVH). The block walks the row's
// live pages only (pages past the tile's largest lp are never touched);
// for each page it stages K and V once in shared memory as f32, computes
// the TILE x page scores, folds them into an f32 online softmax (m, l, acc
// kept in shared memory) and accumulates P.V. The tile is the reason for
// the prefill kernel's shape: each page is loaded once for all rows of the
// tile instead of once per row.
//
// What bounds them on the H100: the bytes of K/V read (int8 pages with
// their scales: 2 D + 8 bytes per position and kv head against 4 D in
// bf16, 0.53x at D 64). Decode reads each
// live (page, kv head) once per sequence; one engine step at the main
// path's shapes (8 slots, KVH 5, D 64, bf16) reads a few MB per layer
// against 3.35 TB/s, i.e. microseconds, so at these grid sizes (40 blocks
// for decode on 132 SMs) launch latency and the serial page walk dominate.
// Nothing here hides memory latency yet (no cp.async/TMA, no split over
// pages, no tensor cores): the page walk is synchronous. Those are the
// known next steps; this version is the simple, exact one.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or a negative code for an unsupported head dim or
// dtype, which the Python wrapper rules out before calling).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  if (dtype == 1 && !quant) { PAGED_DIMS(__nv_bfloat16, __nv_bfloat16); }
  if (dtype == 0 && quant) { PAGED_DIMS(float, int8_t); }
  if (dtype == 1 && quant) { PAGED_DIMS(__nv_bfloat16, int8_t); }
#undef PAGED_DIMS
#undef PAGED_CASE
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
  return launch<kPrefill>(q, k_pages, v_pages, k_scale, v_scale, block_table,
                          start, valid, out, c, kvh, group, head_dim, page,
                          mp, scale, dtype, stream);
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
