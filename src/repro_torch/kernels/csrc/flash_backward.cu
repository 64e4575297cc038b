// Dense grouped-query flash attention, backward, as CUDA kernels for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel and
// trains by differentiating XLA's flash_attention_chunked
// (src/repro/kernels/ref.py), whose jax.checkpoint body recomputes the
// logits. This is the backward of the port's autograd Function around the
// forward kernel (kernels/ops.py FlashAttentionFunction), which before it
// recomputed the plain chunked forward under autograd and differentiated
// that: every score, probability and their gradients went through device
// memory, 88% of a smollm-360m step's bytes at B 4 x S 4096.
//
// What it computes (the plain version is src/repro_torch/kernels/ref.py
// flash_attention_bwd), from q, k, v, the forward's output o, the upstream
// gradient dO and the forward's row statistics lse (f32 (B, H, Sq): the
// natural-log logsumexp of each row's scaled, masked scores, which
// flash_attention_forward writes when given the pointer), with
// P = exp(scale q k^T - lse) and masked entries 0:
//   di = rowsum(dO * o)                        f32 (B, H, Sq)
//   dV = sum over the G = H / KVH grouped heads of P^T dO
//   dS = P * (dO V^T - di)
//   dK = scale * sum over the G heads of dS^T q
//   dQ = scale * dS k
// Causal: the Sq queries are the LAST Sq of the Skv positions (the
// forward's convention); ragged query and key tiles are masked here, so
// any Sq <= Skv works. A row with no key (not reachable under the op's
// contract) has lse = -1e30 + ln(1e-30) and gives zero gradients.
//
// Layouts (all contiguous): q/o/dO/dq (B, H, Sq, D); k/v/dk/dv
// (B, KVH, Skv, D); inputs f32 or bf16 (one type for all), D 64, 80 or
// 128. Outputs in the input type, every sum in f32.
//
// Three kernels, FA2's backward with the dQ pass split out, so that no two
// blocks write one element: deterministic, no atomics (f32 chaos replay
// must give the same losses run to run):
//   (a) flash_bwd_dot_kernel: di, one warp a row;
//   (b) dK/dV: a block owns (b, kv head, 64 keys) and walks every tile of
//       flattened (query position, grouped head) rows, so the GQA sum over
//       the G heads stays in its registers; under causal masking it starts
//       at the first tile whose rows attend its first key;
//   (c) dQ: a block owns (b, kv head, 64 flattened rows), as the forward
//       does, and walks the K/V tiles its rows attend.
//
// What bounds it on the H100: at the trainer's shapes the five products
// (S, dV, dP, dQ, dK; the kernels run seven, S and dP twice) are 0.2-0.5
// GFLOP a call at B 16 x S 64 and ~160 GFLOP at B 4 x S 4096 (causal:
// half), against ~4 MB and ~90 MB of q, k, v, o, dO and the gradients: the
// long sequence is bound by operations, the short one by the launch and
// each block's serial chain. The design keeps P, dP and dS in registers
// (never in device memory), runs every product on tensor cores in bf16, and
// overlaps the next tile's loads with this one's products.
//
// bf16 (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel):
// attention_mma.cuh's parts (mma.sync m16n8k16, ldmatrix, cp.async). A
// block is 4 warps; a warp owns 16 keys (dK/dV) or 16 rows (dQ), the M
// side of every product. In the dK/dV kernel the scores are computed
// transposed, S^T = K Q^T, so a lane's accumulators hold P^T and dS^T in
// the A-fragment layout of dV += P^T dO and dK += dS^T Q (no trip through
// shared memory); the (query, d) operands of those products are read with
// ldmatrix .trans. The query tiles (q, dO, lse, di and each row's last key)
// stream through a ring of two stages filled by cp.async; K and V of the
// block's keys stay in shared memory. D 128 takes 32-row query tiles (64
// accumulators of dK and of dV a thread), D 64 and 80 take 64. P and dS are
// rounded to bf16 only as mma operands.
// Why mma.sync and not wgmma: at B 16 x S 64 a block walks one to three
// tiles and the call is bound by latency, not by tensor-core rate; at
// B 4 x S 4096 the products dominate, and wgmma (64-row warpgroup tiles
// read through shared-memory descriptors with a fixed swizzle, the
// transposed operands as MN-major descriptors) would raise the rate at the
// cost of a second tile engine beside the forward's. This first backward
// reuses the forward's fragment layouts; a later PR may take wgmma at long
// sequences.
//
// f32 (flash_bwd_stats_f64_kernel, flash_bwd_dkdv_kernel,
// flash_bwd_dq_kernel): CUDA cores (TF32 off, as the forward's f32 kernel),
// 8 warps a block, 4 keys or rows a warp, lanes over 64 tile columns for
// the dot products and over D for the sums; D 80 staged as 96 zero-padded
// columns. They serve the f32 parity runs, which hold f32 training through
// the kernels against the plain f32 path and its distance to f64: so they
// take every score, each row's logsumexp and di (their own, in f64: the
// forward's lse is rounded to f32), P, dP and the sums of dQ, dK and dV in
// f64 from the f32 inputs (q scaled first in f32, as the plain version
// scales it) and round once, adding no f32 rounding of their own.
//
// Every launch goes on the caller's stream and allocates nothing (di is the
// caller's scratch: f32 (B, H, Sq) for bf16, f64 (B, H, Sq, 2) for f32);
// the entry returns cudaGetLastError() of the first failing launch, -1 for
// an unsupported head dim or dtype (the Python wrapper rules both out
// before calling), or -2 when a bf16 input pointer is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

namespace mma = attn_mma;
using bf16 = __nv_bfloat16;

constexpr int kBlockKeys = 64;  // keys a dK/dV block owns; keys a dQ stage
constexpr int kBlockRows = 64;  // flattened rows a dQ block owns

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------------
// (a) di = rowsum(dO * o), f32: one warp a (b, h, position) row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dot_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ di, int n_rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const bf16* op = o + (size_t)row * D;
  const bf16* dp = dout + (size_t)row * D;
  float acc = 0.f;
  for (int c = lane * 2; c < D; c += 64) {
    const float2 a = load2(op + c), g = load2(dp + c);
    acc += a.x * g.x + a.y * g.y;
  }
  acc = warp_sum(acc);
  if (lane == 0) di[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products on one warp's 16 rows
// ---------------------------------------------------------------------------

// c[N/8][4] += A . B^T: A the warp's 16 rows of K columns (row-major, ld
// elements a row, in shared memory), B N rows of K columns (row-major): the
// "col" operand as stored. The forward's S = Q K^T.
template <int K, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], const bf16* a,
                                        const bf16* b, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    mma::ldsm_x4(af, a + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t bf[4];
      mma::ldsm_x4(bf, b + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                           kk * 16 + ((lane >> 3) & 1) * 8);
      mma::mma_bf16(c[2 * nn], af, bf[0], bf[1]);
      mma::mma_bf16(c[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// c[N/8][4] += P . B: P the warp's 16 x K accumulators p[K/8][4] (rounded
// to bf16 here: the accumulator layout of two n-tiles is the A fragment of
// one k-step), B K rows of N columns (row-major, read transposed). The
// forward's O += P V.
template <int K, int N>
__device__ __forceinline__ void mma_pb(float (&c)[N / 8][4],
                                       const float (&p)[K / 8][4],
                                       const bf16* b, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a[4] = {mma::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           mma::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           mma::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           mma::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < N / 16; ++dn) {
      uint32_t bf[4];
      mma::ldsm_x4_t(bf, b + (kk * 16 + (lane & 15)) * ld + dn * 16 +
                             (lane >> 4) * 8);
      mma::mma_bf16(c[2 * dn], a, bf[0], bf[1]);
      mma::mma_bf16(c[2 * dn + 1], a, bf[2], bf[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

template <int D>
struct BwdMma {
  static constexpr int kThreads = 128;  // 4 warps, 16 keys or rows each
  static constexpr int kLd = D + 8;     // padded shared row, in elements
  static constexpr int kChunks = D / 8;
  static constexpr int kStages = 2;
  // dK/dV: query rows a stage (D 128: 32, to hold dK and dV's 2 x 64
  // accumulators a thread)
  static constexpr int kQ = D <= 80 ? 64 : 32;
  // dK/dV: K, V [64][kLd]; per stage q, dO [kQ][kLd] bf16 and lse, di,
  // each row's last key [kQ] (4 bytes each)
  static constexpr size_t kDkdvSmem =
      (size_t)(2 * kBlockKeys + kStages * 2 * kQ) * kLd * sizeof(bf16) +
      (size_t)kStages * kQ * 3 * 4;
  // dQ: q, dO [64][kLd]; per stage K, V [64][kLd]
  static constexpr size_t kDqSmem =
      (size_t)(2 * kBlockRows + kStages * 2 * kBlockKeys) * kLd * sizeof(bf16);
};

// (b) dK and dV of 64 keys of one (b, kv head), bf16 on tensor cores
template <int D>
__global__ void __launch_bounds__(128, 2) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int kvh, int sq,
    int skv, int causal, float scale) {
  using Cfg = BwdMma<D>;
  constexpr int LD = Cfg::kLd, CH = Cfg::kChunks, QT = Cfg::kQ;
  constexpr int NS = Cfg::kStages, NT = Cfg::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* vs = ks + kBlockKeys * LD;
  bf16* qs = vs + kBlockKeys * LD;   // [NS][QT][LD]
  bf16* dos = qs + NS * QT * LD;     // [NS][QT][LD]
  float* lses = reinterpret_cast<float*>(dos + NS * QT * LD);  // [NS][QT]
  float* dis = lses + NS * QT;
  int* lims = reinterpret_cast<int*>(dis + NS * QT);

  const int group = h / kvh;
  const int n_rows = sq * group;  // flattened (position, g) rows
  const int k0 = blockIdx.x * kBlockKeys;  // tile 0, the heaviest, first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_offset = skv - sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the last key a flattened row attends; -1 past the last row
  auto lim_of = [&](int r) {
    return r >= n_rows ? -1
           : causal    ? min(skv - 1, q_offset + r / group)
                       : skv - 1;
  };
  // (b, head, position) of flattened row r, in rows of D
  auto row_of = [&](int r) {
    return ((size_t)b * h + hk * group + r % group) * sq + r / group;
  };
  // causal: the rows before the first that attends key k0 are skipped
  const int t_first =
      (causal ? max(0, k0 - q_offset) * group : 0) / QT;
  const int n_tiles = (n_rows + QT - 1) / QT;

  // the block's K and V, zeros past skv (they ride with the first stage)
  const bf16* kh = k + ((size_t)b * kvh + hk) * skv * D;
  const bf16* vh = v + ((size_t)b * kvh + hk) * skv * D;
  for (int idx = tid; idx < kBlockKeys * CH; idx += NT) {
    const int j = idx / CH, c = idx % CH;
    const bool ok = k0 + j < skv;
    const size_t off = ok ? (size_t)(k0 + j) * D + c * 8 : 0;
    mma::cp_async_16(ks + j * LD + c * 8, kh + off, ok);
    mma::cp_async_16(vs + j * LD + c * 8, vh + off, ok);
  }
  auto load_rows = [&](int t) {  // stage t into slot t % NS; zeros past n_rows
    const int r0 = t * QT, slot = t % NS;
    bf16* qd = qs + slot * QT * LD;
    bf16* dd = dos + slot * QT * LD;
    for (int idx = tid; idx < QT * CH; idx += NT) {
      const int i = idx / CH, c = idx % CH, r = r0 + i;
      const bool ok = r < n_rows;
      const size_t off = ok ? row_of(r) * D + c * 8 : 0;
      mma::cp_async_16(qd + i * LD + c * 8, q + off, ok);
      mma::cp_async_16(dd + i * LD + c * 8, dout + off, ok);
    }
    for (int i = tid; i < QT; i += NT) {
      const int r = r0 + i;
      const bool ok = r < n_rows;
      const size_t off = ok ? row_of(r) : 0;
      mma::cp_async_4(lses + slot * QT + i, lse + off, ok);
      mma::cp_async_4(dis + slot * QT + i, di + off, ok);
      lims[slot * QT + i] = lim_of(r);  // seen after the next barrier
    }
  };
  if (t_first < n_tiles) load_rows(t_first);
  mma::cp_async_commit();

  const int kw = k0 + warp * 16;  // the warp's first key
  const int key0 = kw + (lane >> 2), key1 = key0 + 8;  // the lane's two
  const float scale_log2 = scale * mma::kLog2e;
  float dka[D / 8][4], dva[D / 8][4];
  zero(dka);
  zero(dva);
  for (int t = t_first; t < n_tiles; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();  // stage t visible; every warp is done with t - 1
    if (t + 1 < n_tiles) load_rows(t + 1);  // the slot of t - 1
    mma::cp_async_commit();
    const int r0 = t * QT, slot = t % NS;
    // rows attend a prefix of keys that grows with the row: the tile's
    // last live row attends the most, its first the least
    if (kw > lim_of(min(r0 + QT, n_rows) - 1)) continue;  // nothing attended
    const bool masked = kw + 15 > lim_of(r0) || r0 + QT > n_rows;
    const bf16* qt = qs + slot * QT * LD;
    const bf16* dot = dos + slot * QT * LD;
    const float* lse_t = lses + slot * QT;
    const float* di_t = dis + slot * QT;
    const int* lim_t = lims + slot * QT;

    // S^T = K_w Q^T: the lane holds keys key0 / key1 (rows g, g + 8) of
    // columns (tile rows) 8j + 2 (lane % 4) + {0, 1}
    float s[QT / 8][4];
    zero(s);
    mma_abt<D, QT>(s, ks + warp * 16 * LD, qt, LD);
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + (lane & 3) * 2 + e;
        const float l2 = lse_t[col] * mma::kLog2e;
        float p0 = mma::ex2(fmaf(s[j][e], scale_log2, -l2));
        float p1 = mma::ex2(fmaf(s[j][2 + e], scale_log2, -l2));
        if (masked) {
          const int lim = lim_t[col];
          if (key0 > lim) p0 = 0.f;
          if (key1 > lim) p1 = 0.f;
        }
        s[j][e] = p0;
        s[j][2 + e] = p1;
      }
    }
    mma_pb<QT, D>(dva, s, dot, LD);  // dV += P^T dO
    float dp[QT / 8][4];
    zero(dp);
    mma_abt<D, QT>(dp, vs + warp * 16 * LD, dot, LD);  // dP^T = V_w dO^T
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = di_t[j * 8 + (lane & 3) * 2 + e];
        s[j][e] *= dp[j][e] - d;  // dS^T = P^T (dP^T - di)
        s[j][2 + e] *= dp[j][2 + e] - d;
      }
    }
    mma_pb<QT, D>(dka, s, qt, LD);  // dK += dS^T Q (scaled at the end)
  }
  mma::cp_async_wait<0>();  // no copy outlives the block

  bf16* dkh = dk + ((size_t)b * kvh + hk) * skv * D;
  bf16* dvh = dv + ((size_t)b * kvh + hk) * skv * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    if (key0 < skv) {
      *reinterpret_cast<uint32_t*>(dkh + (size_t)key0 * D + c) =
          mma::pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvh + (size_t)key0 * D + c) =
          mma::pack_bf16(dva[n][0], dva[n][1]);
    }
    if (key1 < skv) {
      *reinterpret_cast<uint32_t*>(dkh + (size_t)key1 * D + c) =
          mma::pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvh + (size_t)key1 * D + c) =
          mma::pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// (c) dQ of 64 flattened rows of one (b, kv head), bf16 on tensor cores
template <int D>
__global__ void __launch_bounds__(128, 2) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ dq, int h, int kvh, int sq, int skv, int causal,
    float scale) {
  using Cfg = BwdMma<D>;
  constexpr int LD = Cfg::kLd, CH = Cfg::kChunks, NS = Cfg::kStages;
  constexpr int NT = Cfg::kThreads, SK = kBlockKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dos = qs + kBlockRows * LD;
  bf16* ks = dos + kBlockRows * LD;  // [NS][64][LD]
  bf16* vs = ks + NS * SK * LD;

  const int group = h / kvh;
  const int n_rows = sq * group;
  const int base = (gridDim.x - 1 - blockIdx.x) * kBlockRows;  // heaviest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_offset = skv - sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto lim_of = [&](int r) {
    return r >= n_rows ? -1
           : causal    ? min(skv - 1, q_offset + r / group)
                       : skv - 1;
  };
  auto row_of = [&](int r) {
    return ((size_t)b * h + hk * group + r % group) * sq + r / group;
  };
  const int n_keys = lim_of(min(base + kBlockRows, n_rows) - 1) + 1;
  const int n_stages = (n_keys + SK - 1) / SK;
  const bf16* kh = k + ((size_t)b * kvh + hk) * skv * D;
  const bf16* vh = v + ((size_t)b * kvh + hk) * skv * D;

  // the block's q and dO rows (zeros past the last), with stage 0
  for (int idx = tid; idx < kBlockRows * CH; idx += NT) {
    const int i = idx / CH, c = idx % CH, r = base + i;
    const bool ok = r < n_rows;
    const size_t off = ok ? row_of(r) * D + c * 8 : 0;
    mma::cp_async_16(qs + i * LD + c * 8, q + off, ok);
    mma::cp_async_16(dos + i * LD + c * 8, dout + off, ok);
  }
  auto load_kv = [&](int t) {  // stage t into slot t % NS; zeros past skv
    const int k0 = t * SK;
    bf16* kd = ks + (t % NS) * SK * LD;
    bf16* vd = vs + (t % NS) * SK * LD;
    for (int idx = tid; idx < SK * CH; idx += NT) {
      const int j = idx / CH, c = idx % CH;
      const bool ok = k0 + j < skv;
      const size_t off = ok ? (size_t)(k0 + j) * D + c * 8 : 0;
      mma::cp_async_16(kd + j * LD + c * 8, kh + off, ok);
      mma::cp_async_16(vd + j * LD + c * 8, vh + off, ok);
    }
  };
  if (n_stages > 0) load_kv(0);
  mma::cp_async_commit();

  const int wrow0 = base + warp * 16;
  const mma::RowLimits lim(lim_of(wrow0 + (lane & 15)));
  // lse (log2 domain) and di of the lane's rows g and g + 8
  const int ra = wrow0 + (lane >> 2), rb = ra + 8;
  const float lse_a = ra < n_rows ? lse[row_of(ra)] * mma::kLog2e : 0.f;
  const float lse_b = rb < n_rows ? lse[row_of(rb)] * mma::kLog2e : 0.f;
  const float di_a = ra < n_rows ? di[row_of(ra)] : 0.f;
  const float di_b = rb < n_rows ? di[row_of(rb)] : 0.f;
  const float scale_log2 = scale * mma::kLog2e;
  const bf16* qw = qs + warp * 16 * LD;
  const bf16* dow = dos + warp * 16 * LD;
  float dqa[D / 8][4];
  zero(dqa);
  for (int t = 0; t < n_stages; ++t) {
    mma::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_stages) load_kv(t + 1);
    mma::cp_async_commit();
    const int k0 = t * SK;
    if (!lim.live(k0)) continue;
    const bool masked = lim.masked(k0);
    const bf16* kt = ks + (t % NS) * SK * LD;
    const bf16* vt = vs + (t % NS) * SK * LD;
    float s[SK / 8][4];
    zero(s);
    mma_abt<D, SK>(s, qw, kt, LD);  // S = Q_w K^T
    const int kl = k0 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < SK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = mma::ex2(fmaf(s[j][e], scale_log2, -lse_a));
        float pb = mma::ex2(fmaf(s[j][2 + e], scale_log2, -lse_b));
        if (masked) {
          const int key = kl + j * 8 + e;
          if (key > lim.lim0) pa = 0.f;
          if (key > lim.lim1) pb = 0.f;
        }
        s[j][e] = pa;
        s[j][2 + e] = pb;
      }
    }
    float dp[SK / 8][4];
    zero(dp);
    mma_abt<D, SK>(dp, dow, vt, LD);  // dP = dO_w V^T
#pragma unroll
    for (int j = 0; j < SK / 8; ++j) {
      s[j][0] *= dp[j][0] - di_a;  // dS = P (dP - di)
      s[j][1] *= dp[j][1] - di_a;
      s[j][2] *= dp[j][2] - di_b;
      s[j][3] *= dp[j][3] - di_b;
    }
    mma_pb<SK, D>(dqa, s, kt, LD);  // dQ += dS K (scaled at the end)
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    if (ra < n_rows)
      *reinterpret_cast<uint32_t*>(dq + row_of(ra) * D + c) =
          mma::pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
    if (rb < n_rows)
      *reinterpret_cast<uint32_t*>(dq + row_of(rb) * D + c) =
          mma::pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32PerWarp = 4;  // keys (dK/dV) or rows (dQ) a warp
constexpr int kF32Block = kF32Warps * kF32PerWarp;  // ... a block
constexpr int kF32Tile = 64;  // tile columns: rows (dK/dV), keys (dQ)

template <int D>
struct BwdF32 {
  static constexpr int kDP = (D + 31) / 32 * 32;  // staged columns
  static constexpr int kCols = kDP / 32;          // columns a lane sums
  static constexpr int kS = kDP + 4;  // padded rows read as float4 across
                                      // lanes: distinct banks
  // dK/dV: K, V [block][DP] (the block's keys), q (scaled), dO [64][S] (a
  // row tile), P and dS [block][64], each row's last key [64] (4 bytes
  // each, an even count), then lse and di [64] in f64
  static constexpr size_t kDkdvSmem =
      ((size_t)2 * kF32Block * kDP + 2 * kF32Tile * kS +
       2 * kF32Block * kF32Tile + kF32Tile) * 4 + 2 * kF32Tile * 8;
  // dQ: q (scaled), dO [block][DP] (the block's rows), K, V [64][S] (a key
  // tile), dS [block][64]
  static constexpr size_t kDqSmem =
      ((size_t)2 * kF32Block * kDP + 2 * kF32Tile * kS +
       kF32Block * kF32Tile) * 4;
};

// f64 dot product of four f32 pairs: every f32 kernel below takes its
// scores (q, k) with it, term for term, so that they agree with the row
// statistics
__device__ __forceinline__ double dot4d(float4 a, float4 b) {
  return (double)a.x * b.x + (double)a.y * b.y + (double)a.z * b.z +
         (double)a.w * b.w;
}

// Stages `rows` rows of x (rows of D, src(i) the row's offset or -1 for a
// zero row) as f32 rows of ld columns times mul, zeros past D.
template <int D, typename Src>
__device__ __forceinline__ void stage_rows(float* dst, int rows, int ld,
                                           const float* x, float mul,
                                           Src src) {
  constexpr int DP = BwdF32<D>::kDP;
  for (int idx = threadIdx.x; idx < rows * DP; idx += kF32Threads) {
    const int i = idx / DP, d = idx % DP;
    const long long off = src(i);
    dst[i * ld + d] = off >= 0 && d < D ? x[off * D + d] * mul : 0.f;
  }
}

// (a) for f32: each row's logsumexp and di in f64, one warp a (b, h,
// position) row, into stats [row][2]: (q scale) k with f64 sums, as the
// f32 dK/dV and dQ kernels take the scores (its own logsumexp rather than
// the forward's, which is rounded to f32).
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_stats_f64_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ o, const float* __restrict__ dout,
    double* __restrict__ stats, int h, int kvh, int sq, int skv, int causal,
    float scale, int n_rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int pos = row % sq, bh = row / sq, b = bh / h;
  const int hk = bh % h / (h / kvh);
  const float* qr = q + (size_t)row * D;
  const float* kh = k + ((size_t)b * kvh + hk) * skv * D;
  const int last = causal ? min(skv - 1, skv - sq + pos) : skv - 1;
  auto score = [&](int j) {
    const float* kr = kh + (size_t)j * D;
    double s = 0.0;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = make_float4(qr[d] * scale, qr[d + 1] * scale,
                                    qr[d + 2] * scale, qr[d + 3] * scale);
      s += dot4d(qv, *reinterpret_cast<const float4*>(kr + d));
    }
    return s;
  };
  double m = -1e30, l = 0.0, acc = 0.0;
  for (int j = lane; j <= last; j += 32) m = fmax(m, score(j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  for (int j = lane; j <= last; j += 32) l += exp(score(j) - m);
  for (int c = lane; c < D; c += 32)
    acc += (double)o[(size_t)row * D + c] * dout[(size_t)row * D + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    stats[2 * (size_t)row] = m + log(fmax(l, 1e-30));
    stats[2 * (size_t)row + 1] = acc;
  }
}

// (b) dK and dV of kF32Block keys of one (b, kv head), f32 in and out: the
// scores as the forward rounds them, everything after them in f64
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const double* __restrict__ stats, float* __restrict__ dk,
    float* __restrict__ dv, int h, int kvh, int sq, int skv, int causal,
    float scale) {
  using Cfg = BwdF32<D>;
  constexpr int DP = Cfg::kDP, S = Cfg::kS, COLS = Cfg::kCols;
  constexpr int RPW = kF32PerWarp, T = kF32Tile;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;  // [block][DP]
  float* vs = ks + kF32Block * DP;
  float* qs = vs + kF32Block * DP;  // [T][S], q * scale
  float* dos = qs + T * S;
  float* ps = dos + T * S;  // [block][T]
  float* dss = ps + kF32Block * T;
  int* lim_t = reinterpret_cast<int*>(dss + kF32Block * T);  // [T]
  double* lse_t = reinterpret_cast<double*>(lim_t + T);      // [T]
  double* di_t = lse_t + T;

  const int group = h / kvh, n_rows = sq * group;
  const int k0 = blockIdx.x * kF32Block, hk = blockIdx.y, b = blockIdx.z;
  const int q_offset = skv - sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto lim_of = [&](int r) {
    return r >= n_rows ? -1
           : causal    ? min(skv - 1, q_offset + r / group)
                       : skv - 1;
  };
  auto row_of = [&](int r) -> long long {
    return r >= n_rows
               ? -1
               : ((long long)b * h + hk * group + r % group) * sq + r / group;
  };
  const size_t kv_base = ((size_t)b * kvh + hk) * skv;
  auto key_of = [&](int i) -> long long {
    return k0 + i < skv ? (long long)(kv_base + k0 + i) : -1;
  };
  stage_rows<D>(ks, kF32Block, DP, k, 1.f, key_of);
  stage_rows<D>(vs, kF32Block, DP, v, 1.f, key_of);
  const int t_first = (causal ? max(0, k0 - q_offset) * group : 0) / T;
  const int n_tiles = (n_rows + T - 1) / T;
  const int kw = k0 + warp * RPW;  // the warp's first key
  float* pw = ps + warp * RPW * T;
  float* dsw = dss + warp * RPW * T;
  double dka[RPW][COLS], dva[RPW][COLS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) dka[i][c] = dva[i][c] = 0.0;

  for (int t = t_first; t < n_tiles; ++t) {
    const int r0 = t * T;
    __syncthreads();  // the last tile is consumed
    auto tile_row = [&](int i) { return row_of(r0 + i); };
    stage_rows<D>(qs, T, S, q, scale, tile_row);
    stage_rows<D>(dos, T, S, dout, 1.f, tile_row);
    if (tid < T) {
      const long long off = row_of(r0 + tid);
      lse_t[tid] = off >= 0 ? stats[2 * off] : 0.0;
      di_t[tid] = off >= 0 ? stats[2 * off + 1] : 0.0;
      lim_t[tid] = lim_of(r0 + tid);
    }
    __syncthreads();
    if (kw > lim_of(min(r0 + T, n_rows) - 1)) continue;
    // the lane's columns: tile rows lane and lane + 32
    double s[RPW][2], dp[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.0;
    const float* qa = qs + lane * S;
    const float* qb = qs + (lane + 32) * S;
    const float* da = dos + lane * S;
    const float* db = dos + (lane + 32) * S;
    const float* kw_s = ks + warp * RPW * DP;
    const float* vw_s = vs + warp * RPW * DP;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      const float4 q4a = *reinterpret_cast<const float4*>(qa + d);
      const float4 q4b = *reinterpret_cast<const float4*>(qb + d);
      const float4 d4a = *reinterpret_cast<const float4*>(da + d);
      const float4 d4b = *reinterpret_cast<const float4*>(db + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 k4 = *reinterpret_cast<const float4*>(kw_s + i * DP + d);
        const float4 v4 = *reinterpret_cast<const float4*>(vw_s + i * DP + d);
        s[i][0] += dot4d(q4a, k4);
        s[i][1] += dot4d(q4b, k4);
        dp[i][0] += dot4d(v4, d4a);
        dp[i][1] += dot4d(v4, d4b);
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = lane + 32 * e;
        const double p = kw + i <= lim_t[col]
                             ? exp(s[i][e] - lse_t[col])
                             : 0.0;
        pw[i * T + col] = (float)p;
        dsw[i * T + col] = (float)(p * (dp[i][e] - di_t[col]));
      }
    }
    __syncwarp();
    // dV += P^T dO, dK += dS^T (q * scale): lanes over columns
#pragma unroll 2
    for (int j = 0; j < T; j += 4) {
      float dov[4][COLS], qv[4][COLS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          dov[u][c] = dos[(j + u) * S + lane + 32 * c];
          qv[u][c] = qs[(j + u) * S + lane + 32 * c];
        }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + i * T + j);
        const float4 s4 = *reinterpret_cast<const float4*>(dsw + i * T + j);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          dva[i][c] += (double)p4.x * dov[0][c] + (double)p4.y * dov[1][c] +
                       (double)p4.z * dov[2][c] + (double)p4.w * dov[3][c];
          dka[i][c] += (double)s4.x * qv[0][c] + (double)s4.y * qv[1][c] +
                       (double)s4.z * qv[2][c] + (double)s4.w * qv[3][c];
        }
      }
    }
    __syncwarp();  // P and dS are read before the next tile's
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (kw + i < skv) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          dk[(kv_base + kw + i) * D + d] = (float)dka[i][c];
          dv[(kv_base + kw + i) * D + d] = (float)dva[i][c];
        }
      }
    }
  }
}

// (c) dQ of kF32Block flattened rows of one (b, kv head), f32 in and out,
// as the dK/dV kernel computes
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const double* __restrict__ stats, float* __restrict__ dq, int h, int kvh,
    int sq, int skv, int causal, float scale) {
  using Cfg = BwdF32<D>;
  constexpr int DP = Cfg::kDP, S = Cfg::kS, COLS = Cfg::kCols;
  constexpr int RPW = kF32PerWarp, T = kF32Tile;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // [block][DP], q * scale
  float* dos = qs + kF32Block * DP;
  float* ks = dos + kF32Block * DP;  // [T][S]
  float* vs = ks + T * S;
  float* dss = vs + T * S;  // [block][T]

  const int group = h / kvh, n_rows = sq * group;
  const int base = (gridDim.x - 1 - blockIdx.x) * kF32Block;  // heaviest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_offset = skv - sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto lim_of = [&](int r) {
    return r >= n_rows ? -1
           : causal    ? min(skv - 1, q_offset + r / group)
                       : skv - 1;
  };
  auto row_of = [&](int r) -> long long {
    return r >= n_rows
               ? -1
               : ((long long)b * h + hk * group + r % group) * sq + r / group;
  };
  auto block_row = [&](int i) { return row_of(base + i); };
  stage_rows<D>(qs, kF32Block, DP, q, scale, block_row);
  stage_rows<D>(dos, kF32Block, DP, dout, 1.f, block_row);
  const int wrow0 = base + warp * RPW;
  double lse_r[RPW], di_r[RPW], dqa[RPW][COLS];
  int lim_r[RPW];
  int lim_hi = -1;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long off = row_of(wrow0 + i);
    lse_r[i] = off >= 0 ? stats[2 * off] : 0.0;
    di_r[i] = off >= 0 ? stats[2 * off + 1] : 0.0;
    lim_r[i] = lim_of(wrow0 + i);
    lim_hi = max(lim_hi, lim_r[i]);
#pragma unroll
    for (int c = 0; c < COLS; ++c) dqa[i][c] = 0.0;
  }
  const int n_keys = lim_of(min(base + kF32Block, n_rows) - 1) + 1;
  const int n_tiles = (n_keys + T - 1) / T;
  const size_t kv_base = ((size_t)b * kvh + hk) * skv;
  float* dsw = dss + warp * RPW * T;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * T;
    __syncthreads();
    auto key_of = [&](int i) -> long long {
      return k0 + i < skv ? (long long)(kv_base + k0 + i) : -1;
    };
    stage_rows<D>(ks, T, S, k, 1.f, key_of);
    stage_rows<D>(vs, T, S, v, 1.f, key_of);
    __syncthreads();
    if (k0 > lim_hi) continue;
    // the lane's columns: keys k0 + lane and k0 + lane + 32
    double s[RPW][2], dp[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.0;
    const float* ka = ks + lane * S;
    const float* kb = ks + (lane + 32) * S;
    const float* va = vs + lane * S;
    const float* vb = vs + (lane + 32) * S;
    const float* qw = qs + warp * RPW * DP;
    const float* dw = dos + warp * RPW * DP;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      const float4 k4a = *reinterpret_cast<const float4*>(ka + d);
      const float4 k4b = *reinterpret_cast<const float4*>(kb + d);
      const float4 v4a = *reinterpret_cast<const float4*>(va + d);
      const float4 v4b = *reinterpret_cast<const float4*>(vb + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(qw + i * DP + d);
        const float4 d4 = *reinterpret_cast<const float4*>(dw + i * DP + d);
        s[i][0] += dot4d(q4, k4a);
        s[i][1] += dot4d(q4, k4b);
        dp[i][0] += dot4d(d4, v4a);
        dp[i][1] += dot4d(d4, v4b);
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + lane + 32 * e;
        const double p = key <= lim_r[i]
                             ? exp(s[i][e] - lse_r[i])
                             : 0.0;
        dsw[i * T + lane + 32 * e] = (float)(p * (dp[i][e] - di_r[i]));
      }
    }
    __syncwarp();
    // dQ += dS K: lanes over columns
#pragma unroll 2
    for (int j = 0; j < T; j += 4) {
      float kv[4][COLS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < COLS; ++c) kv[u][c] = ks[(j + u) * S + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 s4 = *reinterpret_cast<const float4*>(dsw + i * T + j);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          dqa[i][c] += (double)s4.x * kv[0][c] + (double)s4.y * kv[1][c] +
                       (double)s4.z * kv[2][c] + (double)s4.w * kv[3][c];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const long long off = row_of(wrow0 + i);
    if (off >= 0) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = lane + 32 * c;
        if (d < D) dq[off * D + d] = (float)(dqa[i][c] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  // the opt-in above 48 KB is per device: made on every launch
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void* di;  // bf16: f32 (B, H, Sq); f32: f64 (B, H, Sq, 2)
  void *dq, *dk, *dv;
  int b, h, kvh, sq, skv, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dot(const Args& a) {
  const int rows = a.b * a.h * a.sq;
  if (rows > 0)
    flash_bwd_dot_kernel<D><<<(rows + 7) / 8, 256, 0, a.stream>>>(
        static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
        static_cast<float*>(a.di), rows);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const Args& a) {
  if (!mma::aligned16(a.q, a.k, a.v, a.dout)) return -2;
  int err = launch_dot<D>(a);
  if (err) return err;
  using Cfg = BwdMma<D>;
  const int n_rows = a.sq * (a.h / a.kvh);
  if (a.b > 0 && a.skv > 0) {
    auto kernel = flash_bwd_dkdv_mma_kernel<D>;
    if ((err = (int)allow_smem(kernel, Cfg::kDkdvSmem))) return err;
    dim3 grid((a.skv + kBlockKeys - 1) / kBlockKeys, a.kvh, a.b);
    kernel<<<grid, Cfg::kThreads, Cfg::kDkdvSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, static_cast<const float*>(a.di), static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.h,
        a.kvh, a.sq, a.skv, a.causal, a.scale);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (a.b > 0 && n_rows > 0) {
    auto kernel = flash_bwd_dq_mma_kernel<D>;
    if ((err = (int)allow_smem(kernel, Cfg::kDqSmem))) return err;
    dim3 grid((n_rows + kBlockRows - 1) / kBlockRows, a.kvh, a.b);
    kernel<<<grid, Cfg::kThreads, Cfg::kDqSmem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, static_cast<const float*>(a.di), static_cast<bf16*>(a.dq), a.h,
        a.kvh, a.sq, a.skv,
        a.causal, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a) {
  const int rows = a.b * a.h * a.sq;
  double* stats = static_cast<double*>(a.di);
  if (rows > 0)
    flash_bwd_stats_f64_kernel<D><<<(rows + 7) / 8, 256, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.o), static_cast<const float*>(a.dout),
        stats, a.h, a.kvh, a.sq, a.skv, a.causal, a.scale, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  using Cfg = BwdF32<D>;
  const int n_rows = a.sq * (a.h / a.kvh);
  if (a.b > 0 && a.skv > 0) {
    auto kernel = flash_bwd_dkdv_kernel<D>;
    if ((err = (int)allow_smem(kernel, Cfg::kDkdvSmem))) return err;
    dim3 grid((a.skv + kF32Block - 1) / kF32Block, a.kvh, a.b);
    kernel<<<grid, kF32Threads, Cfg::kDkdvSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        stats, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.h,
        a.kvh, a.sq, a.skv, a.causal, a.scale);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (a.b > 0 && n_rows > 0) {
    auto kernel = flash_bwd_dq_kernel<D>;
    if ((err = (int)allow_smem(kernel, Cfg::kDqSmem))) return err;
    dim3 grid((n_rows + kF32Block - 1) / kF32Block, a.kvh, a.b);
    kernel<<<grid, kF32Threads, Cfg::kDqSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        stats, static_cast<float*>(a.dq), a.h, a.kvh, a.sq, a.skv, a.causal,
        a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename Kernel>
int kernel_info(Kernel kernel, int threads, size_t smem, int* info) {
  cudaError_t err = allow_smem(kernel, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, (int)smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  return 0;
}

template <int D>
int mma_info(int which, int* info) {
  using Cfg = BwdMma<D>;
  auto dkdv = flash_bwd_dkdv_mma_kernel<D>;
  auto dq = flash_bwd_dq_mma_kernel<D>;
  if (which == 0) return kernel_info(dkdv, Cfg::kThreads, Cfg::kDkdvSmem, info);
  if (which == 1) return kernel_info(dq, Cfg::kThreads, Cfg::kDqSmem, info);
  return -1;
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, KVH, Skv, D); lse
// (B, H, Sq) f32; di: scratch the call overwrites, f32 (B, H, Sq) for
// bf16 and f64 (B, H, Sq, 2) for f32 (each row's own f64 logsumexp and
// di: the f32 kernels do not read lse). dtype: 0 = float32, 1 = bfloat16.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* di, void* dq, void* dk,
                             void* dv, int b, int h, int kvh, int sq,
                             int skv, int head_dim, int causal, float scale,
                             int dtype, void* stream) {
  const Args a{q,  k,  v,  o,  dout, static_cast<const float*>(lse),
               di, dq, dk, dv, b, h, kvh, sq, skv,
               causal, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && head_dim == 64) return launch_f32<64>(a);
  if (dtype == 0 && head_dim == 80) return launch_f32<80>(a);
  if (dtype == 0 && head_dim == 128) return launch_f32<128>(a);
  if (dtype == 1 && head_dim == 64) return launch_mma<64>(a);
  if (dtype == 1 && head_dim == 80) return launch_mma<80>(a);
  if (dtype == 1 && head_dim == 128) return launch_mma<128>(a);
  return -1;
}

// The bf16 dK/dV (which 0) or dQ (which 1) kernel at head_dim as the card
// runs it: info[0] registers a thread, [1] local (spilled) bytes a thread,
// [2] dynamic shared memory bytes a block, [3] blocks resident per SM.
// Returns 0 or a CUDA error.
int flash_attention_backward_info(int head_dim, int which, int* info) {
  if (head_dim == 64) return mma_info<64>(which, info);
  if (head_dim == 80) return mma_info<80>(which, info);
  if (head_dim == 128) return mma_info<128>(which, info);
  return -1;
}

}  // extern "C"
