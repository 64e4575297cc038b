// The tensor-core tile engine shared by the bf16 attention kernels
// (flash_attention.cu's dense kernel and paged_attention.cu's chunked
// prefill): asynchronous 16-byte tile loads, ldmatrix fragment loads, the
// m16n8k16 bf16 mma.sync, the online softmax on accumulator fragments, and
// the merge of partial softmax states across warp groups. Plain inline PTX
// for sm_90a (no CUTLASS/CuTe: they would add minutes to every build).
//
// The shape every user of this header shares: a block owns kRows = 64 query
// rows of ONE kv head and is G warp groups of 4 warps; warp w of a group
// owns rows 16w..16w+15. K and V arrive in stages of G x 64 keys, bf16 in
// shared memory, rows padded to kLd = D + 8 elements (the 8 rows an
// ldmatrix phase reads fall on distinct banks; 16-byte cp.async
// destinations stay aligned). Group g takes the stage's g-th 64-key tile,
// so the block's key range is split G ways and its serial chain of tiles
// is G times shorter; each group keeps its own softmax state, and at the
// end groups 1..G-1 hand theirs to group 0 through shared memory, which
// merges them by logsumexp and writes the rows. Each tile costs a warp two
// products on tensor cores:
//   S (16 x 64)  = Q (16 x D) . K^T     D/16 k-steps x 8 n-tiles
//   O (16 x D)  += P (16 x 64) . V      4 k-steps x D/8 n-tiles
// with f32 accumulation. A lane owns rows g = lane/4 and g + 8 of its warp
// (the mma accumulator layout), so a row's max is two __shfl_xor_sync over
// the lane quad. P is rounded to bf16 in registers and is the A operand of
// P.V as it stands (the S accumulator layout of two n-tiles is the A
// fragment layout of one k-step): no trip through shared memory. m is kept
// in the log2 domain (scores scaled by scale * log2 e); each probability is
// one FFMA and one ex2.approx; l is summed unrounded and per lane, and
// reduced over the quad once, at the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_mma {

constexpr int kGroupThreads = 128;  // one warp group: 4 warps
constexpr int kRows = 64;           // query rows per block: 16 a warp
constexpr int kKeys = 64;           // keys per warp group's tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// D: head dim; G: warp groups splitting the key range
template <int D, int G>
struct Config {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(G == 1 || G == 2, "1 or 2 warp groups");
  static constexpr int kThreads = G * kGroupThreads;
  static constexpr int kLd = D + 8;      // padded shared row, in elements
  static constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
  static constexpr int kStageKeys = G * kKeys;
  static constexpr int kStage = kStageKeys * kLd;  // elements of K (or V)
  // blocks per SM asked of __launch_bounds__: a register cap that holds
  // D / 2 accumulators and 32 scores a thread without spilling
  static constexpr int kMinBlocks =
      G == 1 ? (D <= 64 ? 4 : D <= 80 ? 3 : 2) : (D <= 64 ? 2 : 1);
  // floats a thread hands over in the merge: m and l of its rows, acc
  static constexpr int kPartial = 4 + D / 2;
  static constexpr size_t kMergeBytes =
      (size_t)(G - 1) * kPartial * kGroupThreads * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that does not block the thread. With !pred
// nothing is read and the 16 bytes are zero-filled (src must still be a
// valid pointer).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// The same for one 4-byte word (an int8 page row's f32 scale).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Each row's mask is one number: the last key position it attends (-1: a
// dead row, which yields exact zeros). RowLimits gathers the warp's 16.
struct RowLimits {
  int lim0, lim1;  // rows g and g + 8 of the warp
  int lo, hi;      // the least and the largest over the warp's 16 rows

  // lim: the limit of this lane's row (lane & 15) of the warp
  __device__ __forceinline__ explicit RowLimits(int lim) {
    const int lane = threadIdx.x & 31;
    lo = __reduce_min_sync(0xffffffffu, lim);
    hi = __reduce_max_sync(0xffffffffu, lim);
    lim0 = __shfl_sync(0xffffffffu, lim, lane >> 2);
    lim1 = __shfl_sync(0xffffffffu, lim, (lane >> 2) + 8);
  }
  // whether the tile from key k0 holds a key some row attends
  __device__ __forceinline__ bool live(int k0) const { return k0 <= hi; }
  // whether some key of the tile lies past some row's limit
  __device__ __forceinline__ bool masked(int k0) const {
    return k0 + kKeys - 1 > lo;
  }
};

// One warp's 16 rows: the f32 accumulator and online-softmax state.
template <int D>
struct WarpAttention {
  static constexpr int kLd = D + 8;
  float acc[D / 8][4];
  float m[2], l[2];  // rows g and g + 8, log2 domain; l a per-lane partial

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // Folds one staged 64-key K/V tile (ks, vs: kKeys rows of kLd) into the
  // warp's rows (qw: the warp's first query row in shared memory). k0 is
  // the tile's first key position; lim the rows' limits; with masked false
  // every key of the tile is attended by every row. kScaled: the tile holds
  // int8 values (exact in bf16) whose per-key scales are ksc and vsc (the
  // tile's 64 f32 each, in shared memory): each score column is multiplied
  // by its K scale, and each probability by its V scale as it becomes P.V's
  // operand (l sums the unscaled ones), so no K or V value is rounded.
  template <bool kScaled = false>
  __device__ __forceinline__ void tile(const __nv_bfloat16* qw,
                                       const __nv_bfloat16* ks,
                                       const __nv_bfloat16* vs, int k0,
                                       const RowLimits& lim, bool masked,
                                       float scale_log2,
                                       const float* ksc = nullptr,
                                       const float* vsc = nullptr) {
    const int lane = threadIdx.x & 31;
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // S = Q K^T: A fragments from the query rows, B from K's rows (the
    // "col" operand is K as stored, key-major)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qw + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < kKeys / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4(b, ks + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nn], a, b[0], b[1]);
        mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
      }
    }
    // the lane holds keys 8j + 2(lane % 4) + {0, 1} of rows g and g + 8
    const int kl = k0 + (lane & 3) * 2;
    if constexpr (kScaled) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float2 sc =
            *reinterpret_cast<const float2*>(ksc + j * 8 + (lane & 3) * 2);
        s[j][0] *= sc.x;
        s[j][1] *= sc.y;
        s[j][2] *= sc.x;
        s[j][3] *= sc.y;
      }
    }
    // online softmax on the raw scores. A masked score is -inf, so its
    // probability is ex2(-inf) = 0 exactly, also while a row has seen no
    // key yet: the running max starts at (finite) kNegInf.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked) {
          const int key = kl + j * 8 + e;
          if (key > lim.lim0) s[j][e] = -INFINITY;
          if (key > lim.lim1) s[j][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    // scale_log2 > 0: the max of the scaled scores is the scaled max
    const float mn0 = fmaxf(m[0], quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m[1], quad_max(mx1) * scale_log2);
    const float c0 = ex2(m[0] - mn0), c1 = ex2(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], scale_log2, -mn0));
        s[j][2 + e] = ex2(fmaf(s[j][2 + e], scale_log2, -mn1));
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l[0] = l[0] * c0 + sum0;
    l[1] = l[1] * c1 + sum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    if constexpr (kScaled) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float2 sc =
            *reinterpret_cast<const float2*>(vsc + j * 8 + (lane & 3) * 2);
        s[j][0] *= sc.x;
        s[j][1] *= sc.y;
        s[j][2] *= sc.x;
        s[j][3] *= sc.y;
      }
    }
    // O += P V: P from registers, B fragments from V's rows transposed
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (kk * 16 + (lane & 15)) * kLd + dn * 16 +
                         (lane >> 4) * 8);
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
  }

  // The merge across warp groups. A slot holds kPartial floats of each of
  // a group's 128 threads, laid out [value][thread] so a warp's accesses
  // are consecutive words. The lane of warp w in group g holds the same
  // rows and columns as the lane of warp w in group 0, so slots pair up
  // thread by thread.
  __device__ __forceinline__ void store_partial(float* slot) const {
    const int t = threadIdx.x % kGroupThreads;
    slot[t] = m[0];
    slot[kGroupThreads + t] = m[1];
    slot[2 * kGroupThreads + t] = l[0];
    slot[3 * kGroupThreads + t] = l[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        slot[(4 + n * 4 + e) * kGroupThreads + t] = acc[n][e];
  }

  __device__ __forceinline__ void merge_partial(const float* slot) {
    const int t = threadIdx.x % kGroupThreads;
    const float om0 = slot[t], om1 = slot[kGroupThreads + t];
    const float mn0 = fmaxf(m[0], om0), mn1 = fmaxf(m[1], om1);
    const float a0 = ex2(m[0] - mn0), b0 = ex2(om0 - mn0);
    const float a1 = ex2(m[1] - mn1), b1 = ex2(om1 - mn1);
    l[0] = l[0] * a0 + slot[2 * kGroupThreads + t] * b0;
    l[1] = l[1] * a1 + slot[3 * kGroupThreads + t] * b1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * (e < 2 ? a0 : a1) +
                    slot[(4 + n * 4 + e) * kGroupThreads + t] *
                        (e < 2 ? b0 : b1);
    m[0] = mn0;
    m[1] = mn1;
  }

  // Divides by l (floored at 1e-30), rounds to bf16 and writes the warp's
  // rows: staged in ow (the warp's own 16 rows of kLd in shared memory,
  // which no other warp reads by now), then 16-byte stores to out_row(r),
  // the global address of the warp's row r, or nullptr for a row not
  // written.
  template <typename OutRow>
  __device__ __forceinline__ void finish(__nv_bfloat16* ow,
                                         OutRow out_row) const {
    constexpr int kChunks = D / 8;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, c = (lane & 3) * 2;
    const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
    const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
    __syncwarp();  // the warp's last ldmatrix of ow is done
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ow + g * kLd + n * 8 + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * kLd + n * 8 + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * kChunks; idx += 32) {
      const int r = idx / kChunks, ch = idx % kChunks;
      __nv_bfloat16* dst = out_row(r);
      if (dst != nullptr)
        *reinterpret_cast<uint4*>(dst + ch * 8) =
            *reinterpret_cast<const uint4*>(ow + r * kLd + ch * 8);
    }
  }
};

// After the key loop: groups 1..G-1 hand their state to group 0 through
// buf (the K/V ring, free by now), which merges it. Every thread of the
// block calls this; it holds two barriers when G > 1.
template <int D, int G>
__device__ __forceinline__ void merge_groups(WarpAttention<D>& att,
                                             float* buf) {
  if constexpr (G > 1) {
    constexpr int kSlot = Config<D, G>::kPartial * kGroupThreads;
    const int group = threadIdx.x / kGroupThreads;
    __syncthreads();  // every group is done with the ring
    if (group > 0) att.store_partial(buf + (group - 1) * kSlot);
    __syncthreads();
    if (group == 0) {
#pragma unroll
      for (int s = 0; s < G - 1; ++s) att.merge_partial(buf + s * kSlot);
    }
  }
}

// Warp groups a launch of `blocks` blocks takes. Splitting each block's
// keys over 2 groups shortens its serial chain of tiles but halves the
// blocks an SM holds, so it pays only while the grid leaves SMs idle: at
// most one block per SM (whole-prompt B 1 x S 512: 120 blocks; a prefill
// chunk: 15-32), not lockstep's 480 or 256 at 32 heads.
__host__ inline int warp_groups(int blocks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return blocks <= sms ? 2 : 1;
}

// true when every pointer is 16-byte aligned (cp.async and the 16-byte
// stores need it; torch's allocations are)
__host__ __forceinline__ bool aligned16(const void* a, const void* b,
                                        const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

}  // namespace attn_mma
