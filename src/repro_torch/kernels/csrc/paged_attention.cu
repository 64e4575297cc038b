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
// device memory: the decode and f32 prefill kernels multiply each element
// by its scale in f32 registers (as the plain version dequantizes); the
// bf16 prefill kernel stages the int8 values as bf16 (exact: |x| <= 127)
// and applies the scales in registers, each score column times its K scale
// and each probability times its V scale before it is rounded for P.V, so
// no K or V value is rounded to bf16.
//
// What bounds them on the H100: the bytes of K/V read (int8 pages with
// their scales: 2 D + 8 bytes per position and kv head against 4 D in
// bf16, 0.53x at D 64). One engine step at the main path's shapes (8
// slots, KVH 5, D 64, bf16) reads ~3.5 MB per layer against 3.35 TB/s,
// about a microsecond; a 64-token chunk over a 320-key prefix reads 0.2 MB.
// At these sizes launch latency, load latency and the length of each
// block's serial chain decide the time, so every design below is about
// putting enough blocks on the card and keeping loads in flight.
//
// Decode, and every row of a mixed step without the chunk hint
// (paged_decode_split_kernel + paged_decode_merge_kernel, every q and page
// type): one block of 4 warps owns one (row, kv head, split), a split
// being a run of consecutive logical pages; the caller picks the split
// count from the table width so the grid holds about two blocks per SM
// (decode_splits in kernels/paged_attention.py: 8 rows x 5 kv heads x 7
// splits of 7 pages at the main path's 44-entry tables, where one block per
// (row, head) left 40 blocks for 132 SMs, each walking up to 40 pages one
// after another). A block first copies its split's block-table entries to
// shared memory (so no stage waits on a global read before it can issue
// its copies), then stages the split's K/V in stages of 32 keys with
// 16-byte cp.async, up to four stages in flight, the next stages' copies
// issued before this one is computed. Each lane quad owns one key of a
// stage: its 4 lanes split the head dim for the G dot products (two
// shuffles finish each), each warp keeps its own online softmax over its
// keys in registers (a 3-shuffle max per row per stage, l summed per lane),
// and P.V is lane-per-column with the probabilities shuffled from their
// quads. Products stay on CUDA cores in f32: a kv head has G <= 8 query
// rows, so an mma.sync tile of 16 rows would be mostly empty; the work is
// bytes and latency, not operations; and f32 stays exact for the f32
// parity runs (no TF32). The row loops are compiled per G for G 1-4 (a
// loop over absent rows still issues its instructions: with one 8-row
// instance for every G, compute was most of the kernel's time, the same at
// G 1 as at G 3), G 5-8 as 8. At the end the warps merge through shared
// memory, a one-split launch writes its rows, and otherwise each split
// writes its (m, l, acc) to a partials buffer the wrapper allocates; the
// merge kernel combines a row's live splits by logsumexp in split order
// (no atomics: deterministic), each split's weight computed once in shared
// memory. The merge is the split kernel's programmatic dependent launch,
// so its launch overlaps the split kernel. A split that starts past its
// row's length exits at once and the merge does not read it; a row with
// no live split gets exact zeros.
//
// Chunked prefill, bf16 q (paged_prefill_mma_kernel, both pool types), and
// the chunk rows of a mixed step with the hint: attention_mma.cuh's tile
// engine, as flash_attention.cu uses it. A block owns 64 of the chunk's
// C x G flattened rows for one kv head (C 64 x G 3, KVH 5: 3 x 5 = 15
// blocks); it reads its own block-table entries and assembles each 64-key
// K/V tile from 64 / page pages (page 8 and 16 alike; a tile that is not a
// whole number of live pages is masked): each (position, kv head) row is D
// contiguous elements at stride KVH x D in the pool, one 16-byte cp.async
// per chunk of a row, for bf16 and for int8 (64 B rows at D 64). Stages go
// through a ring of two, so the next stage's loads overlap this one's
// products; int8 stages (and their scales) land raw and are widened to
// bf16 just before use. QK^T and P.V run on mma.sync m16n8k16 with f32 m,
// l and acc in registers. A chunk's grid is far smaller than the card, so
// its blocks are two warp groups that split the keys (merged by logsumexp
// at the end); a grid of more blocks than SMs (a long chunk) keeps one. A
// row-limit policy (a template parameter) says what each chunk row
// attends: start + row within valid (prefill), or the row's own last_pos
// (the fused step's chunk rows, which share one block-table row, so the
// chunk's pages are read once per kv head and not once per row). Why
// mma.sync and not wgmma: the kernel is bound by latency at ~1 us of work;
// wgmma's 64-row warpgroup tiles and shared-memory descriptors add risk
// and no time at 15-32 blocks.
//
// Chunked prefill with f32 q (paged_prefill_f32_kernel; it serves the f32
// parity runs only) is the first version's template: one block owns 32
// flattened chunk rows for one kv head, walks the chunk's pages one at a
// time, stages K and V as f32 in shared memory and computes scores, an
// online softmax one thread per row and P.V on CUDA cores.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(), a negative code for an unsupported head dim, group
// or dtype (which the Python wrapper rules out before calling), or -2 when
// a pointer a cp.async kernel copies from or to is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

namespace mma = attn_mma;

constexpr float kNegInf = -1e30f;

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

// Lets `kernel` take up to the device's opt-in dynamic shared memory. For
// kernels whose shared memory varies from launch to launch: one fixed cap,
// set again before every launch, so no launch (on any thread) is refused
// because another set the cap to its own, smaller need.
template <typename K>
cudaError_t allow_dynamic_smem(K kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return err;
}

// the keys a row attends: its length clamped to [0, the table's width]
__device__ __forceinline__ int row_keys(int len, int max_keys) {
  return min(max(len, 0), max_keys);
}

// ---------------------------------------------------------------------------
// decode (and mixed rows without the chunk hint): the split page walk
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitKeys = 32;      // keys a stage: one per lane quad
constexpr int kMaxGroup = 8;        // q heads per kv head the kernel takes

// The group count a split kernel instance is compiled for: G 1-4 exactly
// (a loop over rows that are not there still issues its instructions), 5-8
// as 8 with the rows past G skipped; f32 q (the parity runs) takes 8.
__host__ __device__ constexpr int group_bucket(int group) {
  return group <= 4 ? group : kMaxGroup;
}

template <typename KV, int D>
struct SplitTile {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kRowBytes = D * (int)sizeof(KV);  // a pool row
  // K rows are read by the 8 quads of a warp at once, 64 bytes a quad a
  // step: a stride of 64 mod 128 bytes puts neighbouring rows' windows on
  // disjoint banks. V rows are read one at a time by the whole warp.
  static constexpr int kKLd = kRowBytes + (192 - kRowBytes % 128) % 128;
  static constexpr int kStageBytes =
      kSplitKeys * (kKLd + kRowBytes) + (kQuant ? 2 * kSplitKeys * 4 : 0);
  // stages in the ring: as many as fit in 64 KB, between 2 and 4
  static constexpr int kFit = 65536 / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kEpc = 16 / (int)sizeof(KV);  // elements a 16 B chunk
  static constexpr int kChunks = kRowBytes / 16;     // 16 B chunks of a row
  static constexpr int kLaneChunks = (kChunks + 3) / 4;  // a lane's share
  static constexpr int kPairs = (D / 2 + 31) / 32;   // column pairs a lane
  static_assert(kRowBytes % 16 == 0, "rows of whole 16-byte chunks");

  // q (G x D f32), the split's block-table entries (16-byte padded), then
  // the ring; the warps' merge reuses the ring
  __host__ __device__ static size_t table_bytes(int pages_per_split) {
    return ((size_t)pages_per_split * 4 + 15) / 16 * 16;
  }
  __host__ __device__ static size_t smem_bytes(int group, int pages_per_split) {
    const size_t ring = (size_t)kStages * kStageBytes;
    const size_t merge = (size_t)kSplitWarps * group * (D + 2) * 4;
    return (size_t)group * D * 4 + table_bytes(pages_per_split) +
           (ring > merge ? ring : merge);
  }
};

// 16 bytes of a pool row as f32, at most 8 elements at a time (an int8
// chunk in two halves, to keep registers down): elements 8 half .. of the
// chunk at p
template <typename KV>
__device__ __forceinline__ void chunk_to_f32(float* f, const unsigned char* p,
                                             int half) {
  if constexpr (std::is_same<KV, float>::value) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(x[i] << 16);  // the low half is the first
      f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
    }
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p + 8 * half);
    const uint32_t x[2] = {w.x, w.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)  // sign-extending byte b
        f[4 * i + b] = (float)((int32_t)(x[i] << (24 - 8 * b)) >> 24);
  }
}

// elements col, col + 1 of a pool row (col even) as f32
template <typename KV>
__device__ __forceinline__ float2 pair_to_f32(const unsigned char* row,
                                              int col) {
  if constexpr (std::is_same<KV, float>::value) {
    return *reinterpret_cast<const float2*>(row + col * 4);
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + col * 2);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  } else {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + col);
    return make_float2((float)((int32_t)(w << 24) >> 24),
                       (float)((int32_t)(w << 16) >> 24));
  }
}

// One block: one (row, kv head, split) of a decode batch. lens[row] +
// len_add is the row's length (decode: lengths, add 0; mixed rows:
// last_pos, add 1). part_acc / part_ml: the splits' partial states, laid
// out [row][kv head][split][g] (D floats of acc; m and l), written when
// splits > 1; one split writes out directly. GM: group_bucket(group).
template <typename T, typename KV, int D, int GM>
__global__ void __launch_bounds__(kSplitThreads) paged_decode_split_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lens, int len_add, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int kvh,
    int group, int page, int mp, int splits, int pages_per_split,
    float scale_log2) {
  using Tile = SplitTile<KV, D>;
  constexpr bool kQuant = Tile::kQuant;
  constexpr int SK = kSplitKeys, NS = Tile::kStages, RB = Tile::kRowBytes;
  constexpr int KLD = Tile::kKLd, EPC = Tile::kEpc, NT = kSplitThreads;
  constexpr int HE = EPC < 8 ? EPC : 8;  // elements converted at a time
  const int ng = GM < kMaxGroup ? GM : group;  // live rows of the GM
  // the merge kernel may be scheduled now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  int* tbl = reinterpret_cast<int*>(smem_raw + (size_t)group * D * 4);
  unsigned char* ring = smem_raw + (size_t)group * D * 4 +
                        Tile::table_bytes(pages_per_split);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bid = blockIdx.x / splits;  // row * kvh + h
  const int sp = blockIdx.x % splits;
  const int row = bid / kvh, h = bid % kvh;
  const int n_keys = row_keys(lens[row] + len_add, mp * page);
  const int k_lo = sp * pages_per_split * page;
  const int k_hi = min(k_lo + pages_per_split * page, n_keys);
  const bool direct = splits == 1;
  if (k_hi <= k_lo && !direct) return;  // the merge skips this split
  const int n_stages = k_hi > k_lo ? (k_hi - k_lo + SK - 1) / SK : 0;
  const int p_lo = sp * pages_per_split;  // the split's first logical page

  // the split's live block-table entries, so no stage waits on a global
  // read before it can issue its copies; the row's G queries as f32,
  // pre-scaled so scores come out in log2 units
  const int* table = tables + (size_t)row * mp + p_lo;
  for (int i = tid; i < (k_hi - k_lo + page - 1) / page; i += NT)
    tbl[i] = table[i];
  const T* qrow = q + (size_t)bid * group * D;
  for (int idx = tid; idx < group * D; idx += NT)
    qs[idx] = to_f32(qrow[idx]) * scale_log2;
  __syncthreads();

  auto load_stage = [&](int t) {  // keys k_lo + t*SK.. into slot t % NS
    unsigned char* st = ring + (t % NS) * Tile::kStageBytes;
    const int k0 = k_lo + t * SK;
    for (int idx = tid; idx < SK * Tile::kChunks; idx += NT) {
      const int j = idx / Tile::kChunks, c = idx % Tile::kChunks;
      const int kpos = k0 + j;
      const bool ok = kpos < k_hi;
      const size_t src =
          ok ? (((size_t)tbl[kpos / page - p_lo] * page + kpos % page) * kvh +
                h) * RB + c * 16
             : 0;
      mma::cp_async_16(st + j * KLD + c * 16,
                       reinterpret_cast<const unsigned char*>(k_pages) + src,
                       ok);
      mma::cp_async_16(st + SK * KLD + j * RB + c * 16,
                       reinterpret_cast<const unsigned char*>(v_pages) + src,
                       ok);
    }
    if constexpr (kQuant) {  // threads 0..SK-1: K scales, SK..2SK-1: V
      if (tid < 2 * SK) {
        const int j = tid % SK, kpos = k0 + j;
        const bool ok = kpos < k_hi;
        const size_t r =
            ok ? ((size_t)tbl[kpos / page - p_lo] * page + kpos % page) *
                         kvh + h
               : 0;
        float* sc = reinterpret_cast<float*>(st + SK * (KLD + RB));
        mma::cp_async_4(sc + (tid < SK ? 0 : SK) + j,
                        (tid < SK ? k_scale : v_scale) + r, ok);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < n_stages) load_stage(t);
    mma::cp_async_commit();
  }

  // this warp's online softmax over its keys: m per row (log2 units, the
  // same on every lane), l a per-lane partial of its quad's keys, acc the
  // lane's column pairs 2 (lane + 32 i)
  float m[GM], l[GM], acc[GM][Tile::kPairs][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < Tile::kPairs; ++i) acc[g][i][0] = acc[g][i][1] = 0.f;
  }
  const int quad = lane >> 2, ql = lane & 3;
  const int jq = warp * 8 + quad;  // the quad's key in every stage
  for (int t = 0; t < n_stages; ++t) {
    mma::cp_async_wait<NS - 2>();
    __syncthreads();  // stage t (and q) visible; every warp is done with t-1
    if (t + NS - 1 < n_stages) load_stage(t + NS - 1);  // the slot of t - 1
    mma::cp_async_commit();
    const unsigned char* st = ring + (t % NS) * Tile::kStageBytes;
    const float* sc = reinterpret_cast<const float*>(st + SK * (KLD + RB));
    // the quad's key against the G rows: its lanes split the chunks
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    const float ksc = kQuant ? sc[jq] : 1.f;
#pragma unroll
    for (int i = 0; i < Tile::kLaneChunks; ++i) {
      const int c = ql + 4 * i;
      if (c < Tile::kChunks) {
#pragma unroll
        for (int half = 0; half < EPC / HE; ++half) {
          float kf[HE];
          chunk_to_f32<KV>(kf, st + jq * KLD + c * 16, half);
          if constexpr (kQuant) {
#pragma unroll
            for (int e = 0; e < HE; ++e) kf[e] *= ksc;
          }
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < ng) {
              const float4* qg = reinterpret_cast<const float4*>(
                  qs + g * D + c * EPC + half * HE);
#pragma unroll
              for (int e = 0; e < HE / 4; ++e) {
                const float4 qv = qg[e];
                s[g] = fmaf(qv.x, kf[4 * e], s[g]);
                s[g] = fmaf(qv.y, kf[4 * e + 1], s[g]);
                s[g] = fmaf(qv.z, kf[4 * e + 2], s[g]);
                s[g] = fmaf(qv.w, kf[4 * e + 3], s[g]);
              }
            }
          }
        }
      }
    }
    const bool live = k_lo + t * SK + jq < k_hi;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < ng) {
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
        if (!live) s[g] = -INFINITY;  // exp2 gives an exact 0
        float mx = fmaxf(s[g], __shfl_xor_sync(0xffffffffu, s[g], 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[g], mx);
        const float corr = exp2f(m[g] - mn);
        s[g] = exp2f(s[g] - mn);
        m[g] = mn;
        l[g] = l[g] * corr + s[g];
#pragma unroll
        for (int i = 0; i < Tile::kPairs; ++i) {
          acc[g][i][0] *= corr;
          acc[g][i][1] *= corr;
        }
      }
    }
    // P.V over the warp's 8 keys; masked keys have p = 0 and zero-filled V
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int key = warp * 8 + jj;
      const unsigned char* vrow = st + SK * KLD + key * RB;
      const float vsc = kQuant ? sc[SK + key] : 1.f;
      float p[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < ng) p[g] = __shfl_sync(0xffffffffu, s[g], jj * 4);
#pragma unroll
      for (int i = 0; i < Tile::kPairs; ++i) {
        const int col = 2 * (lane + 32 * i);
        if (col < D) {
          float2 v = pair_to_f32<KV>(vrow, col);
          if constexpr (kQuant) {
            v.x *= vsc;
            v.y *= vsc;
          }
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < ng) {
              acc[g][i][0] = fmaf(p[g], v.x, acc[g][i][0]);
              acc[g][i][1] = fmaf(p[g], v.y, acc[g][i][1]);
            }
          }
        }
      }
    }
  }

  // merge the 4 warps through the (now idle) ring: [warp][g][D acc, m, l]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < ng) {  // l: the sum over the warp's 8 quads
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], 4);
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], 8);
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], 16);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* wbuf = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < ng) {
      float* wr = wbuf + (size_t)(warp * group + g) * (D + 2);
#pragma unroll
      for (int i = 0; i < Tile::kPairs; ++i) {
        const int col = 2 * (lane + 32 * i);
        if (col < D) {
          wr[col] = acc[g][i][0];
          wr[col + 1] = acc[g][i][1];
        }
      }
      if (lane == 0) {
        wr[D] = m[g];
        wr[D + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < group * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mw = fmaxf(mw, wbuf[(w * group + g) * (D + 2) + D]);
    float lw = 0.f, aw = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* wr = wbuf + (w * group + g) * (D + 2);
      const float f = exp2f(wr[D] - mw);
      lw = fmaf(wr[D + 1], f, lw);
      aw = fmaf(wr[d], f, aw);
    }
    if (direct) {
      out[(size_t)bid * group * D + idx] = from_f32<T>(aw / fmaxf(lw, 1e-30f));
    } else {
      const size_t slot = ((size_t)bid * splits + sp) * group + g;
      part_acc[slot * D + d] = aw;
      if (d == 0) {
        part_ml[slot * 2] = mw;
        part_ml[slot * 2 + 1] = lw;
      }
    }
  }
}

// One block: one (row, kv head). Combines the row's live splits, in split
// order, by logsumexp; a row with none gets exact zeros. Each split's
// weight 2^(m - M) / L is worked out once, in shared memory, so every
// output element reads its splits' partials as independent loads.
// Launched as the split kernel's programmatic dependent (Hopper): it is
// scheduled while the split kernel runs, reads the row's length (written
// before the split kernel started), and waits for the split kernel's
// partials at griddepcontrol.wait.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads) paged_decode_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lens, int len_add, T* __restrict__ out, int kvh,
    int group, int d, int splits, int split_keys, int max_keys) {
  extern __shared__ float wsh[];  // [split][g]: m, then the weight
  const int bid = blockIdx.x, row = bid / kvh;
  const int n_keys = row_keys(lens[row] + len_add, max_keys);
  const int live = (n_keys + split_keys - 1) / split_keys;
  const size_t base = (size_t)bid * splits * group;
  float* lsh = wsh + splits * group;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = threadIdx.x; i < live * group; i += blockDim.x) {
    wsh[i] = part_ml[(base + i) * 2];
    lsh[i] = part_ml[(base + i) * 2 + 1];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < group; g += blockDim.x) {
    float mx = kNegInf, lsum = 0.f;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, wsh[s * group + g]);
    for (int s = 0; s < live; ++s)
      lsum = fmaf(lsh[s * group + g], exp2f(wsh[s * group + g] - mx), lsum);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    for (int s = 0; s < live; ++s)
      wsh[s * group + g] = exp2f(wsh[s * group + g] - mx) * inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * d; idx += blockDim.x) {
    const int g = idx / d, dd = idx % d;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      a = fmaf(part_acc[(base + s * group + g) * d + dd], wsh[s * group + g],
               a);
    out[(size_t)bid * group * d + idx] = from_f32<T>(a);
  }
}

template <typename T, typename KV, int D, int GM>
int launch_decode_typed(const void* q, const void* k, const void* v,
                        const float* k_scale, const float* v_scale,
                        const int* tables, const int* lens, int len_add,
                        void* out, float* partials, int rows, int kvh,
                        int group, int page, int mp, int splits,
                        int pages_per_split, float scale,
                        cudaStream_t stream) {
  using Tile = SplitTile<KV, D>;
  if (splits < 1 || pages_per_split < 1 ||
      (splits > 1 && partials == nullptr))
    return -1;
  if (!mma::aligned16(k, v, k, v)) return -2;
  const size_t smem = Tile::smem_bytes(group, pages_per_split);
  auto kernel = paged_decode_split_kernel<T, KV, D, GM>;
  const cudaError_t err = allow_dynamic_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    float* part_acc = partials;
    float* part_ml =
        partials ? partials + (size_t)rows * kvh * splits * group * D : nullptr;
    kernel<<<rows * kvh * splits, kSplitThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), k_scale, v_scale, tables, lens, len_add,
        static_cast<T*>(out), part_acc, part_ml, kvh, group, page, mp, splits,
        pages_per_split, scale * mma::kLog2e);
    if (splits > 1) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(rows * kvh);
      cfg.blockDim = dim3(kSplitThreads);
      cfg.dynamicSmemBytes = (size_t)splits * group * 2 * 4;
      cfg.stream = stream;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t lerr = cudaLaunchKernelEx(
          &cfg, paged_decode_merge_kernel<T>, (const float*)part_acc,
          (const float*)part_ml, lens, len_add, static_cast<T*>(out), kvh,
          group, (int)D, splits, pages_per_split * page, mp * page);
      if (lerr != cudaSuccess) return (int)lerr;
    }
  }
  return (int)cudaGetLastError();
}

// Calls F<T, KV, D, GM>::run(args...) for q's dtype (0 = float32, 1 =
// bfloat16), the page type (int8 when quant, else q's), head_dim and the
// group's bucket (f32 q: 8); -1 for anything else.
template <template <typename, typename, int, int> class F, typename... A>
int dispatch_split(int dtype, bool quant, int head_dim, int group,
                   A... args) {
  if (group < 1 || group > kMaxGroup) return -1;
  const int gm = dtype == 0 ? kMaxGroup : group_bucket(group);
#define SPLIT_GM(T, KV, DIM)                                                 \
  switch (gm) {                                                              \
    case 1: return F<T, KV, DIM, 1>::run(args...);                           \
    case 2: return F<T, KV, DIM, 2>::run(args...);                           \
    case 3: return F<T, KV, DIM, 3>::run(args...);                           \
    case 4: return F<T, KV, DIM, 4>::run(args...);                           \
    default: return F<T, KV, DIM, kMaxGroup>::run(args...);                  \
  }
#define SPLIT_DIMS(T, KV)                                                    \
  if (head_dim == 64) { SPLIT_GM(T, KV, 64) }                                \
  if (head_dim == 80) { SPLIT_GM(T, KV, 80) }                                \
  if (head_dim == 128) { SPLIT_GM(T, KV, 128) }                              \
  return -1
  if (dtype == 0 && !quant) { SPLIT_DIMS(float, float); }
  if (dtype == 0 && quant) { SPLIT_DIMS(float, int8_t); }
  if (dtype == 1 && !quant) { SPLIT_DIMS(__nv_bfloat16, __nv_bfloat16); }
  if (dtype == 1 && quant) { SPLIT_DIMS(__nv_bfloat16, int8_t); }
#undef SPLIT_DIMS
#undef SPLIT_GM
  return -1;
}

template <typename T, typename KV, int D, int GM>
struct DecodeLaunch {
  static int run(const void* q, const void* k, const void* v,
                 const float* k_scale, const float* v_scale,
                 const int* tables, const int* lens, int len_add, void* out,
                 float* partials, int rows, int kvh, int group, int page,
                 int mp, int splits, int pages_per_split, float scale,
                 cudaStream_t s) {
    if constexpr (std::is_same<T, float>::value && GM != kMaxGroup) {
      return -1;  // f32 q is built for the 8-row bucket only
    } else {
      return launch_decode_typed<T, KV, D, GM>(
          q, k, v, k_scale, v_scale, tables, lens, len_add, out, partials,
          rows, kvh, group, page, mp, splits, pages_per_split, scale, s);
    }
  }
};

int launch_decode(const void* q, const void* k, const void* v,
                  const float* k_scale, const float* v_scale,
                  const int* tables, const int* lens, int len_add, void* out,
                  float* partials, int rows, int kvh, int group, int head_dim,
                  int page, int mp, int splits, int pages_per_split,
                  float scale, int dtype, cudaStream_t s) {
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr)) return -1;
  return dispatch_split<DecodeLaunch>(
      dtype, quant, head_dim, group, q, k, v, k_scale, v_scale, tables, lens,
      len_add, out, partials, rows, kvh, group, page, mp, splits,
      pages_per_split, scale, s);
}

template <typename T, typename KV, int D, int GM>
struct DecodeInfo {
  static int run(int group, int pages_per_split, int* info) {
    if constexpr (std::is_same<T, float>::value && GM != kMaxGroup) {
      return -1;
    } else {
      auto kernel = paged_decode_split_kernel<T, KV, D, GM>;
      const int smem =
          (int)SplitTile<KV, D>::smem_bytes(group, pages_per_split);
      cudaError_t err = allow_dynamic_smem(kernel);
      cudaFuncAttributes attr;
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
      int blocks = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, kSplitThreads, smem);
      if (err != cudaSuccess) return (int)err;
      info[0] = attr.numRegs;
      info[1] = (int)attr.localSizeBytes;
      info[2] = smem;
      info[3] = blocks;
      return 0;
    }
  }
};

// ---------------------------------------------------------------------------
// chunked prefill with f32 q: the first version's CUDA-core template
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kPrefillTile = 32;

// Shared memory, in 4-byte words: q[tile][D], acc[tile][D], s[tile][page],
// k[page][D+1] (padded: the score loop reads k rows across lanes),
// v[page][D], m/l/corr[tile], lp[tile] (int).
__host__ __device__ inline size_t smem_words(int tile, int page, int d) {
  return (size_t)tile * (2 * d + page + 4) + (size_t)page * (2 * d + 1);
}

// KV: page storage type (float, or int8_t with f32 scales)
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_f32_kernel(
    const float* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ start_p, const int* __restrict__ valid_p,
    float* __restrict__ out, int n_rows, int kvh, int group, int page,
    int mp, float scale) {
  constexpr int tile = kPrefillTile;
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
  const int base = blockIdx.x * tile;  // first flattened (chunk row, g) row
  const int rows = min(tile, n_rows - base);

  // per-row state and the row's query
  for (int i = tid; i < rows; i += kThreads) {
    const int c = (base + i) / group;  // chunk row
    lps[i] = c < *valid_p ? *start_p + c : -1;
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int gr = base + i, c = gr / group, g = gr % group;
    qs[idx] = q[(((size_t)c * kvh + h) * group + g) * D + d];
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
        acc[idx] / fmaxf(ls[i], 1e-30f);
  }
}

template <typename KV, int D>
int launch_prefill_f32(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale,
                       const int* table, const int* start, const int* valid,
                       void* out, int c, int kvh, int group, int page, int mp,
                       float scale, cudaStream_t stream) {
  const int n_rows = c * group;
  const size_t smem = smem_words(kPrefillTile, page, D) * 4;
  auto kernel = paged_prefill_f32_kernel<KV, D>;
  const cudaError_t err = allow_dynamic_smem(kernel);  // smem varies with page
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    dim3 grid((n_rows + kPrefillTile - 1) / kPrefillTile, kvh);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), k_scale, v_scale, table, start, valid,
        static_cast<float*>(out), n_rows, kvh, group, page, mp, scale);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// chunk rows with bf16 q: the tensor-core kernel
// ---------------------------------------------------------------------------

// Row-limit policies of the tensor-core chunk kernel: the last key
// position chunk row c attends (-1: a dead row), and the largest limit over
// chunk rows c0..c1 (which decides how far the block reads the pages).
struct PrefillLimits {  // chunked prefill: start + c while c < valid
  int start, valid;
  __device__ __forceinline__ PrefillLimits(const int* a, const int* b)
      : start(*a), valid(*b) {}
  __device__ __forceinline__ int operator()(int c) const {
    return c < valid ? start + c : -1;
  }
  __device__ __forceinline__ int hi(int c0, int c1) const {
    const int c = min(c1, valid - 1);
    return c < c0 ? -1 : start + c;
  }
};

struct MixedChunkLimits {  // the fused step's chunk rows: their own last_pos
  const int* lp;
  __device__ __forceinline__ MixedChunkLimits(const int* a, const int*)
      : lp(a) {}
  __device__ __forceinline__ int operator()(int c) const { return lp[c]; }
  __device__ __forceinline__ int hi(int c0, int c1) const {
    int m = -1;
    for (int c = c0; c <= c1; ++c) m = max(m, lp[c]);
    return m;
  }
};

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

// Lim: PrefillLimits (lim_a = &start, lim_b = &valid) or MixedChunkLimits
// (lim_a = the chunk rows' last_pos)
template <typename KV, int D, int G, typename Lim>
__global__ void __launch_bounds__(mma::Config<D, G>::kThreads,
                                  PrefillTile<KV, D, G>::kMinBlocks)
    paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const KV* __restrict__ k_pages,
                             const KV* __restrict__ v_pages,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ table,
                             const int* __restrict__ lim_a,
                             const int* __restrict__ lim_b,
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

  const Lim limits(lim_a, lim_b);
  const int h = blockIdx.y;
  const int base = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / mma::kGroupThreads;  // warp group: its key tiles
  const int wr = (tid % mma::kGroupThreads) >> 5;  // warp: its 16 rows
  // the last position a flattened (chunk row, g) row attends; -1: dead
  auto lim_of = [&](int r) { return r < n_rows ? limits(r / group) : -1; };
  // the block's largest limit decides how far its pages go
  const int hi = limits.hi(base / group, (min(base + ROWS, n_rows) - 1) / group);
  const int n_keys = hi < 0 ? 0 : min(hi + 1, mp * page);
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

template <typename KV, int D, int G, typename Lim>
int launch_prefill_groups(const void* q, const void* k, const void* v,
                          const float* k_scale, const float* v_scale,
                          const int* table, const int* lim_a,
                          const int* lim_b, void* out, int c, int kvh,
                          int group, int page, int mp, float scale,
                          cudaStream_t stream) {
  using Cfg = mma::Config<D, G>;
  const size_t smem = PrefillTile<KV, D, G>::kSmemBytes;
  auto kernel = paged_prefill_mma_kernel<KV, D, G, Lim>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int threads = Cfg::kThreads;
  const int n_rows = c * group;
  if (n_rows > 0) {
    dim3 grid((n_rows + mma::kRows - 1) / mma::kRows, kvh);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), k_scale, v_scale, table, lim_a, lim_b,
        static_cast<__nv_bfloat16*>(out), n_rows, kvh, group, page, mp,
        scale * mma::kLog2e);
  }
  return (int)cudaGetLastError();
}

template <typename Lim, typename KV, int D>
int launch_prefill_mma(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale,
                       const int* table, const int* lim_a, const int* lim_b,
                       void* out, int c, int kvh, int group, int page, int mp,
                       float scale, cudaStream_t stream) {
  if (!mma::aligned16(q, k, v, out)) return -2;
  const int blocks = (c * group + mma::kRows - 1) / mma::kRows * kvh;
  if (mma::warp_groups(blocks) == 2)
    return launch_prefill_groups<KV, D, 2, Lim>(q, k, v, k_scale, v_scale,
                                                table, lim_a, lim_b, out, c,
                                                kvh, group, page, mp, scale,
                                                stream);
  return launch_prefill_groups<KV, D, 1, Lim>(q, k, v, k_scale, v_scale,
                                              table, lim_a, lim_b, out, c,
                                              kvh, group, page, mp, scale,
                                              stream);
}

// bf16 q over bf16 or int8 pages (k_scale null or not)
template <typename Lim>
int launch_chunk_mma(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* table, const int* lim_a, const int* lim_b,
                     void* out, int c, int kvh, int group, int head_dim,
                     int page, int mp, float scale, cudaStream_t s) {
  if ((k_scale != nullptr) != (v_scale != nullptr)) return -1;
#define MMA_CASE(KV, DIM)                                                    \
  return launch_prefill_mma<Lim, KV, DIM>(q, k, v, k_scale, v_scale, table,  \
                                          lim_a, lim_b, out, c, kvh, group,  \
                                          page, mp, scale, s)
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

template <typename KV, int D, int G>
int prefill_mma_info_groups(int* info) {
  auto kernel = paged_prefill_mma_kernel<KV, D, G, PrefillLimits>;
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
// pages, or two null pointers for pages of q's type. The decode and mixed
// entries take the split count and pages per split the caller chose
// (decode_splits) and, for more than one split, a partials buffer of
// rows x KVH x splits x G x (D + 2) f32 (rows: the rows that go through
// the split kernel).

// q (B, KVH, G, D); block_tables (B, MP); lengths (B,) -> out (B, KVH, G, D)
int paged_attention_decode(const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scale,
                           const float* v_scale, const int* block_tables,
                           const int* lengths, void* out, float* partials,
                           int b, int kvh, int group, int head_dim, int page,
                           int mp, int splits, int pages_per_split,
                           float scale, int dtype, void* stream) {
  return launch_decode(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                       lengths, 0, out, partials, b, kvh, group, head_dim,
                       page, mp, splits, pages_per_split, scale, dtype,
                       static_cast<cudaStream_t>(stream));
}

// q (C, KVH, G, D); block_table (MP,); start, valid: device int32 scalars
int paged_attention_prefill(const void* q, const void* k_pages,
                            const void* v_pages, const float* k_scale,
                            const float* v_scale, const int* block_table,
                            const int* start, const int* valid, void* out,
                            int c, int kvh, int group, int head_dim, int page,
                            int mp, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_chunk_mma<PrefillLimits>(
        q, k_pages, v_pages, k_scale, v_scale, block_table, start, valid,
        out, c, kvh, group, head_dim, page, mp, scale, s);
  if (dtype != 0 || (k_scale != nullptr) != (v_scale != nullptr)) return -1;
#define F32_CASE(KV, DIM)                                                    \
  return launch_prefill_f32<KV, DIM>(q, k_pages, v_pages, k_scale, v_scale,  \
                                     block_table, start, valid, out, c, kvh, \
                                     group, page, mp, scale, s)
#define F32_DIMS(KV)                                                         \
  if (head_dim == 64) F32_CASE(KV, 64);                                      \
  if (head_dim == 80) F32_CASE(KV, 80);                                      \
  if (head_dim == 128) F32_CASE(KV, 128);                                    \
  return -1
  if (k_scale == nullptr) { F32_DIMS(float); }
  F32_DIMS(int8_t);
#undef F32_DIMS
#undef F32_CASE
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

// The decode split kernel at head_dim with q of dtype (0 f32, 1 bf16) over
// pages of q's type (quant 0) or int8 (quant 1), for `group` q heads per kv
// head and splits of pages_per_split pages: info[0..3] as
// paged_attention_prefill_mma_info's.
int paged_attention_decode_info(int head_dim, int dtype, int quant, int group,
                                int pages_per_split, int* info) {
  return dispatch_split<DecodeInfo>(dtype, quant != 0, head_dim, group, group,
                                    pages_per_split, info);
}

// q (R, KVH, G, D); block_tables (R, MP); last_pos (R,) -> out (R, KVH, G, D).
// num_decode: 0, or (bf16 q only) the fused step's structure hint
// 0 < num_decode < R: rows [num_decode, R) are one prefill chunk sharing
// the block-table row block_tables[num_decode], with contiguous positions
// and dead rows as a suffix. Rows [0, num_decode) then go through the
// decode split kernel (splits and partials sized for num_decode rows) and
// the chunk rows through the tensor-core chunk kernel, which reads the
// chunk's pages once per kv head. With 0 every row goes through the split
// kernel on its own table row.
int paged_attention_mixed(const void* q, const void* k_pages,
                          const void* v_pages, const float* k_scale,
                          const float* v_scale, const int* block_tables,
                          const int* last_pos, void* out, float* partials,
                          int r, int kvh, int group, int head_dim, int page,
                          int mp, int splits, int pages_per_split,
                          int num_decode, float scale, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_decode == 0)
    return launch_decode(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                         last_pos, 1, out, partials, r, kvh, group, head_dim,
                         page, mp, splits, pages_per_split, scale, dtype, s);
  if (dtype != 1 || num_decode < 0 || num_decode >= r) return -1;
  const int err = launch_decode(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, last_pos, 1, out,
      partials, num_decode, kvh, group, head_dim, page, mp, splits,
      pages_per_split, scale, dtype, s);
  if (err != 0) return err;
  const size_t off = (size_t)num_decode * kvh * group * head_dim;
  return launch_chunk_mma<MixedChunkLimits>(
      static_cast<const __nv_bfloat16*>(q) + off, k_pages, v_pages, k_scale,
      v_scale, block_tables + (size_t)num_decode * mp, last_pos + num_decode,
      nullptr, static_cast<__nv_bfloat16*>(out) + off, r - num_decode, kvh,
      group, head_dim, page, mp, scale, s);
}

}  // extern "C"
