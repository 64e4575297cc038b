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
// blocks write one element: deterministic, no float atomics (one shared
// integer counter orders the ring's refill at D 128) and no dQ scratch
// summed in launch order (f32 chaos replay must give the same losses run to
// run, and two bf16 calls the same bits):
//   (a) flash_bwd_dot_kernel: di, one warp a row;
//   (b) dK/dV: a block owns (b, kv head, a run of keys) and walks every
//       query tile of each of the G grouped heads, so the GQA sum over the
//       G heads stays in its registers; under causal masking it starts at
//       the first tile whose rows attend its first key, and the blocks of
//       the first keys (the most tiles) start first;
//   (c) dQ: a block owns (b, q head, a run of query rows) and walks the
//       key tiles its rows attend, heaviest first.
// The split costs seven products instead of five (S and dP twice), which
// caps the pair at 5/7 of the five-product operations bound; one dQ pass
// with float atomics, or a per-block dQ scratch, would not give the same
// bits run to run.
//
// What bounds it on the H100: at the trainer's shapes the five products
// (S, dV, dP, dQ, dK) are 0.2-0.5 GFLOP a call at B 16 x S 64 and ~320
// GFLOP at B 4 x S 4096 (the causal half of the pairs), against ~10 MB and
// ~170 MB of q, k, v, o, dO and the gradients: the long sequence is bound
// by operations, the short one by the launch and each block's serial
// chain. P, dP and dS stay in registers (never in device memory) and every
// product runs on tensor cores in bf16 with f32 sums. What is left between the tensor rate and
// these kernels is the chain inside a warpgroup (a tile's products wait on
// its exponentials and on each other: two warpgroups a block hide part of
// it) and the exponentials themselves (one a pair in each kernel, 16 a
// clock an SM).
//
// bf16 (flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel): Hopper's
// wgmma and TMA through hopper.cuh. A block is two consumer warpgroups of
// 64 rows each, the M side of every product: dK/dV 128 keys (64 a
// warpgroup), dQ 128 query rows. Every tile is 64 rows of D columns in
// shared memory, 128-byte swizzled (32-byte at D 80: 16-column chunks),
// brought by TMA boxes of 64 rows from one (b, head) matrix, so rows past
// the matrix read as zeros; the ragged and causal masks are applied to P in
// registers. K and V of the dK/dV block's keys (q and dO of the dQ block's
// rows) arrive once; the streamed tiles (q, dO and the rows' lse and di;
// K and V) go through a ring of three stages, each guarded by an mbarrier
// that counts the TMA bytes. The dK/dV kernel computes the scores
// transposed, S^T = K q^T and dP^T = V dO^T (both operands K-major
// descriptors), so a lane's accumulators hold P^T and dS^T in the layout
// of wgmma's A from registers: dV += P^T dO and dK += dS^T q read them as
// they stand, with dO and q as MN-major descriptors of the same tiles. The
// dQ kernel computes S = q K^T and dP = dO V^T and dQ += dS K (K as an
// MN-major descriptor). Each tile issues S and dP together, takes P while
// dP runs, and issues dV before it waits for dP. P and dS are rounded to
// bf16 only as wgmma operands. At D 64 and 80 a third, producer warpgroup
// (one warp of it) fills the ring and setmaxnreg gives its registers to the
// consumers; ptxas keeps the consumers near the launch's 168 registers all
// the same, which D 64 fits (D 80's dK/dV kernel spills a little and ptxas
// serialises its wgmma, yet it runs faster so than without the producer).
// D 128's dK and dV (128 f32 a thread) do not fit: its blocks are the two
// consumer warpgroups alone (255 registers a thread, without which ptxas
// serialises every wgmma), and the last warp done with a stage refills it.
// Blocks launch heaviest first across the whole grid (every head's first
// keys for dK/dV, last rows for dQ), so no long causal walk starts last.
//
// f32 (flash_bwd_stats_f64_kernel, flash_bwd_dkdv_kernel,
// flash_bwd_dq_kernel): CUDA cores (TF32 off, as the forward's f32 kernel),
// blocks over flattened (query position, grouped head) rows, 8 warps a
// block, 4 keys or rows a warp, lanes over 64 tile columns for
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
// before calling), -2 when a bf16 input pointer is not 16-byte aligned, or
// -3 when the CUDA driver does not encode a tensor map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace {

namespace mma = attn_mma;
using bf16 = __nv_bfloat16;

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
// bf16 on Hopper: wgmma products on TMA tiles
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;   // rows (keys or queries) a warpgroup owns
constexpr int kWgGroups = 2;  // consumer warpgroups a block
constexpr int kWgBlockRows = kWgGroups * kWgRows;  // keys (dK/dV) or
                                                   // rows (dQ) a block
constexpr int kWgStages = 3;  // the ring of streamed tiles

template <int D>
struct BwdWg {
  // D 64 and 80: a third, producer warpgroup fills the ring and gives its
  // registers to the consumers (setmaxnreg 24 / 240); D 128's dK and dV
  // (128 accumulators a thread) need more than the 168 a thread of three
  // warpgroups, so its blocks are the two consumer warpgroups alone (255
  // registers a thread) and the last warp done with a stage refills it
  static constexpr bool kProducer = D <= 80;
  static constexpr int kThreads = 128 * (kWgGroups + kProducer);
  static constexpr int kW = D == 80 ? 16 : 64;  // columns a swizzle chunk
  using T = hopper::Tile<D, kW>;
  static constexpr size_t kTile = T::kBytes;
  // each stage's full and empty barriers and count of warps done with it,
  // and the fixed tiles' barrier
  static constexpr size_t kBars =
      (2 * kWgStages + 1) * sizeof(uint64_t) + kWgStages * sizeof(int);
  // dK/dV: K and V of the block's keys (a 64-row tile each warpgroup), the
  // ring's q and dO tiles, then each ring row's lse (log2 domain) and di
  static constexpr size_t kDkdvSmem =
      1024 + (2 * kWgGroups + 2 * kWgStages) * kTile +
      2 * kWgStages * kWgRows * sizeof(float) + kBars;
  // dQ: q and dO of the block's rows, the ring's K and V tiles
  static constexpr size_t kDqSmem =
      1024 + (2 * kWgGroups + 2 * kWgStages) * kTile + kBars;
};

// Whether the calling warp is the last of the block's consumer warps to be
// done with a ring stage (`done`: the stage's count of warps done, which
// the last one resets). Without a producer that warp refills the stage, so
// no warp waits for another to free one.
__device__ __forceinline__ bool last_done(int* done) {
  int last = 0;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();  // this warp's reads of the stage come first
    last = atomicAdd(done, 1) == 4 * kWgGroups - 1;
    if (last) *done = 0;
  }
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last) __threadfence_block();
  return last != 0;
}

// the first 1024-byte boundary at or after p (the dynamic shared memory is
// asked for 1024 bytes more than it uses)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// One tile of 64 keys (the warpgroup's) against 64 query rows: S^T and
// dP^T on both operands' descriptors, then dV += P^T dO and dK += dS^T q
// with P^T and dS^T from registers. lse2 and di_t: the tile rows' lse (log2
// domain) and di; lim(p): the last key tile row p attends.
template <int D, typename Lim>
__device__ __forceinline__ void dkdv_tile(float (&dka)[D / 2],
                                          float (&dva)[D / 2], uint32_t k_t,
                                          uint32_t v_t, uint32_t q_t,
                                          uint32_t do_t, const float* lse2,
                                          const float* di_t, int key0,
                                          bool masked, float scale_log2,
                                          Lim lim) {
  using T = typename BwdWg<D>::T;
  const int lane = threadIdx.x & 31;
  float sa[32], dpa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = dpa[i] = 0.f;
  hopper::fence_operand(sa);
  hopper::fence_operand(dpa);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
    hopper::wgmma_ss_n64(sa, T::k_major(k_t, kk), T::k_major(q_t, kk), kk);
  hopper::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
    hopper::wgmma_ss_n64(dpa, T::k_major(v_t, kk), T::k_major(do_t, kk), kk);
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();
  hopper::fence_operand(sa);
  // P^T: the lane's keys key0 and key0 + 8, tile rows 8j + 2 (lane % 4) + e
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane & 3) + e;
      const float l2 = lse2[col];
      float p0 = mma::ex2(fmaf(sa[4 * j + e], scale_log2, -l2));
      float p1 = mma::ex2(fmaf(sa[4 * j + 2 + e], scale_log2, -l2));
      if (masked) {
        const int l = lim(col);
        if (key0 > l) p0 = 0.f;
        if (key0 + 8 > l) p1 = 0.f;
      }
      sa[4 * j + e] = p0;
      sa[4 * j + 2 + e] = p1;
    }
  }
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = mma::pack_bf16(sa[8 * kk + 2 * i], sa[8 * kk + 2 * i + 1]);
  hopper::fence_operand(dva);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO
    hopper::wgmma_rs<D>(dva, pa[kk], T::mn_major(do_t, kk));
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();  // dP^T is in; dV may still run
  hopper::fence_operand(dpa);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float d = di_t[8 * j + 2 * (lane & 3) + e];
      sa[4 * j + e] *= dpa[4 * j + e] - d;  // dS^T = P^T (dP^T - di)
      sa[4 * j + 2 + e] *= dpa[4 * j + 2 + e] - d;
    }
  }
  uint32_t da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      da[kk][i] = mma::pack_bf16(sa[8 * kk + 2 * i], sa[8 * kk + 2 * i + 1]);
  hopper::fence_operand(dka);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // dK += dS^T q (scaled at the end)
    hopper::wgmma_rs<D>(dka, da[kk], T::mn_major(q_t, kk));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  // the products read their A registers until the wait: kept live to here
  hopper::fence_operand(pa);
  hopper::fence_operand(da);
  hopper::fence_operand(dka);
  hopper::fence_operand(dva);
}

// (b) dK and dV of 128 keys of one (b, kv head), bf16 on wgmma
template <int D>
__global__ void __launch_bounds__(BwdWg<D>::kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ di,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int h, int kvh, int sq, int skv, int causal,
                                float scale) {
  using Cfg = BwdWg<D>;
  using T = typename Cfg::T;
  constexpr int NS = kWgStages, R = kWgRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);  // [warpgroup] K tiles
  unsigned char* vs = ks + kWgGroups * T::kBytes;  // [warpgroup] V tiles
  unsigned char* qs = vs + kWgGroups * T::kBytes;  // [stage] q tiles
  unsigned char* dos = qs + NS * T::kBytes;        // [stage] dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + NS * T::kBytes);  // [NS][R]
  float* di_s = lse_s + NS * R;
  uint64_t* full = reinterpret_cast<uint64_t*>(di_s + NS * R);  // [NS]
  uint64_t* empty = full + NS;                                   // [NS]
  uint64_t* kv_full = empty + NS;
  int* done = reinterpret_cast<int*>(kv_full + 1);  // [NS]

  // blocks in launch order: every (b, kv head)'s first keys (the most
  // query tiles) first, so the longest walks start first on the card
  const int group = h / kvh;
  const int k0 = blockIdx.y * kWgBlockRows;
  const int hk = blockIdx.x % kvh, b = blockIdx.x / kvh;
  const int q_offset = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the last key query position p attends; -1 past the last position
  auto lim_of = [&](int p) {
    return p >= sq ? -1 : causal ? min(skv - 1, q_offset + p) : skv - 1;
  };
  // the walk: for each of the G heads of the group, the query tiles from
  // the first whose last row attends key k0 (causal) to the last
  const int n_qt = (sq + R - 1) / R;
  const int t_first = causal ? max(0, k0 - q_offset) / R : 0;
  const int per_head = n_qt - t_first;
  const int n_tiles = group * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 32);  // a warp's lanes
      hopper::mbar_init(&empty[s], 4 * kWgGroups);  // consumer warps
      done[s] = 0;
    }
    hopper::mbar_init(kv_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // one thread: the block's K and V tiles
  auto load_kv = [&] {
    hopper::mbar_arrive_expect_tx(kv_full, 2 * kWgGroups * T::kBytes);
    for (int i = 0; i < kWgGroups; ++i)
      for (int c = 0; c < T::kChunks; ++c) {
        const int x = c * Cfg::kW, y = k0 + i * R, z = b * kvh + hk;
        const uint32_t off = i * T::kBytes + c * T::kChunkBytes;
        hopper::tma_load_3d(ks + off, &tm_k, kv_full, x, y, z);
        hopper::tma_load_3d(vs + off, &tm_v, kv_full, x, y, z);
      }
  };
  // a whole warp: tile t into its stage t % NS, which no warp reads
  auto produce = [&](int t) {
    const int s = t % NS;
    const int mat = b * h + hk * group + t / per_head;  // (b, q head)
    const int p0 = (t_first + t % per_head) * R;
    for (int i = lane; i < R; i += 32) {
      const bool ok = p0 + i < sq;
      const size_t off = (size_t)mat * sq + p0 + i;
      lse_s[s * R + i] = ok ? lse[off] * mma::kLog2e : 0.f;
      di_s[s * R + i] = ok ? di[off] : 0.f;
    }
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&full[s], 2 * T::kBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        const uint32_t off = s * T::kBytes + c * T::kChunkBytes;
        hopper::tma_load_3d(qs + off, &tm_q, &full[s], c * Cfg::kW, p0, mat);
        hopper::tma_load_3d(dos + off, &tm_do, &full[s], c * Cfg::kW, p0,
                            mat);
      }
    } else {
      hopper::mbar_arrive(&full[s]);
    }
  };

  if (Cfg::kProducer && warp >= 4 * kWgGroups) {  // the producer warpgroup
    hopper::setmaxnreg_dec<24>();
    if (warp != 4 * kWgGroups) return;  // one warp loads
    if (lane == 0) load_kv();
    for (int t = 0; t < n_tiles; ++t) {
      hopper::mbar_wait(&empty[t % NS], ((t / NS) & 1) ^ 1);
      produce(t);
    }
  } else {  // consumer warpgroup wg: keys kw..kw+63
    if constexpr (Cfg::kProducer) hopper::setmaxnreg_inc<240>();
    if (!Cfg::kProducer && warp == 0) {  // the ring's first fill
      if (lane == 0) load_kv();
      for (int t = 0; t < NS && t < n_tiles; ++t) produce(t);
    }
    const int wg = warp >> 2;
    const int kw = k0 + wg * R;
    const int key0 = kw + (warp & 3) * 16 + (lane >> 2), key1 = key0 + 8;
    const uint32_t k_t = hopper::smem_u32(ks + wg * T::kBytes);
    const uint32_t v_t = hopper::smem_u32(vs + wg * T::kBytes);
    const float scale_log2 = scale * mma::kLog2e;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    hopper::mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NS;
      const int p0 = (t_first + t % per_head) * R;
      hopper::mbar_wait(&full[s], (t / NS) & 1);
      // rows attend a prefix of keys that grows with the row: the tile's
      // last live row attends the most, its first the least
      if (kw <= lim_of(min(p0 + R, sq) - 1)) {
        const bool masked = kw + R - 1 > lim_of(p0) || p0 + R > sq;
        dkdv_tile<D>(dka, dva, k_t, v_t,
                     hopper::smem_u32(qs + s * T::kBytes),
                     hopper::smem_u32(dos + s * T::kBytes), lse_s + s * R,
                     di_s + s * R, key0, masked, scale_log2,
                     [&](int col) { return lim_of(p0 + col); });
      }
      if constexpr (Cfg::kProducer) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      } else if (last_done(&done[s]) && t + NS < n_tiles) {
        produce(t + NS);
      }
    }
    const size_t base = ((size_t)b * kvh + hk) * skv * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + (lane & 3) * 2;
      if (key0 < skv) {
        *reinterpret_cast<uint32_t*>(dk + base + (size_t)key0 * D + c) =
            mma::pack_bf16(dka[4 * n] * scale, dka[4 * n + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + base + (size_t)key0 * D + c) =
            mma::pack_bf16(dva[4 * n], dva[4 * n + 1]);
      }
      if (key1 < skv) {
        *reinterpret_cast<uint32_t*>(dk + base + (size_t)key1 * D + c) =
            mma::pack_bf16(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + base + (size_t)key1 * D + c) =
            mma::pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
      }
    }
  }
}

// (c) dQ of 128 query rows of one (b, q head), bf16 on wgmma
template <int D>
__global__ void __launch_bounds__(BwdWg<D>::kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              bf16* __restrict__ dq, int h, int kvh, int sq,
                              int skv, int causal, float scale) {
  using Cfg = BwdWg<D>;
  using T = typename Cfg::T;
  constexpr int NS = kWgStages, R = kWgRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);  // [warpgroup] q tiles
  unsigned char* dos = qs + kWgGroups * T::kBytes;  // [warpgroup] dO tiles
  unsigned char* ks = dos + kWgGroups * T::kBytes;  // [stage] K tiles
  unsigned char* vs = ks + NS * T::kBytes;          // [stage] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + NS * T::kBytes);
  uint64_t* empty = full + NS;
  uint64_t* q_full = empty + NS;
  int* done = reinterpret_cast<int*>(q_full + 1);  // [NS]

  // blocks in launch order: every (b, head)'s last rows (the most keys)
  // first
  const int group = h / kvh;
  const int p0 = (gridDim.y - 1 - blockIdx.y) * kWgBlockRows;
  const int mat = blockIdx.x, kv_mat = mat / h * kvh + mat % h / group;
  const int q_offset = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto lim_of = [&](int p) {
    return p >= sq ? -1 : causal ? min(skv - 1, q_offset + p) : skv - 1;
  };
  const int n_keys = lim_of(min(p0 + kWgBlockRows, sq) - 1) + 1;
  const int n_tiles = (n_keys + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kWgGroups);
      done[s] = 0;
    }
    hopper::mbar_init(q_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // one thread: the block's q and dO tiles
  auto load_rows = [&] {
    hopper::mbar_arrive_expect_tx(q_full, 2 * kWgGroups * T::kBytes);
    for (int i = 0; i < kWgGroups; ++i)
      for (int c = 0; c < T::kChunks; ++c) {
        const uint32_t off = i * T::kBytes + c * T::kChunkBytes;
        hopper::tma_load_3d(qs + off, &tm_q, q_full, c * Cfg::kW, p0 + i * R,
                            mat);
        hopper::tma_load_3d(dos + off, &tm_do, q_full, c * Cfg::kW,
                            p0 + i * R, mat);
      }
  };
  // one thread: key tile t into its stage t % NS, which no warp reads
  auto produce = [&](int t) {
    const int s = t % NS;
    hopper::mbar_arrive_expect_tx(&full[s], 2 * T::kBytes);
    for (int c = 0; c < T::kChunks; ++c) {
      const uint32_t off = s * T::kBytes + c * T::kChunkBytes;
      hopper::tma_load_3d(ks + off, &tm_k, &full[s], c * Cfg::kW, t * R,
                          kv_mat);
      hopper::tma_load_3d(vs + off, &tm_v, &full[s], c * Cfg::kW, t * R,
                          kv_mat);
    }
  };

  if (Cfg::kProducer && warp >= 4 * kWgGroups) {  // the producer warpgroup
    hopper::setmaxnreg_dec<24>();
    if (warp != 4 * kWgGroups || lane != 0) return;  // one thread loads
    load_rows();
    for (int t = 0; t < n_tiles; ++t) {
      hopper::mbar_wait(&empty[t % NS], ((t / NS) & 1) ^ 1);
      produce(t);
    }
  } else {  // consumer warpgroup wg: query rows wrow..wrow+63
    if constexpr (Cfg::kProducer) hopper::setmaxnreg_inc<240>();
    if (!Cfg::kProducer && threadIdx.x == 0) {  // the ring's first fill
      load_rows();
      for (int t = 0; t < NS && t < n_tiles; ++t) produce(t);
    }
    const int wg = warp >> 2;
    const int wrow = p0 + wg * R;
    const int r0 = wrow + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
    // the warpgroup's least and largest limits (-1: no live row)
    const int wg_lo = lim_of(wrow);
    const int wg_hi = wrow < sq ? lim_of(min(wrow + R, sq) - 1) : -1;
    const int lim0 = lim_of(r0), lim1 = lim_of(r1);
    const size_t row0 = (size_t)mat * sq + r0, row1 = row0 + 8;
    const float lse0 = r0 < sq ? lse[row0] * mma::kLog2e : 0.f;
    const float lse1 = r1 < sq ? lse[row1] * mma::kLog2e : 0.f;
    const float di0 = r0 < sq ? di[row0] : 0.f;
    const float di1 = r1 < sq ? di[row1] : 0.f;
    const uint32_t q_t = hopper::smem_u32(qs + wg * T::kBytes);
    const uint32_t do_t = hopper::smem_u32(dos + wg * T::kBytes);
    const float scale_log2 = scale * mma::kLog2e;
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NS, kt0 = t * R;
      hopper::mbar_wait(&full[s], (t / NS) & 1);
      if (kt0 <= wg_hi) {
        const bool masked = kt0 + R - 1 > wg_lo || wrow + R > sq;
        const uint32_t k_t = hopper::smem_u32(ks + s * T::kBytes);
        const uint32_t v_t = hopper::smem_u32(vs + s * T::kBytes);
        float sa[32], dpa[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sa[i] = dpa[i] = 0.f;
        hopper::fence_operand(sa);
        hopper::fence_operand(dpa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
          hopper::wgmma_ss_n64(sa, T::k_major(q_t, kk), T::k_major(k_t, kk),
                               kk);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
          hopper::wgmma_ss_n64(dpa, T::k_major(do_t, kk),
                               T::k_major(v_t, kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_operand(sa);
        const int kl = kt0 + (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pa = mma::ex2(fmaf(sa[4 * j + e], scale_log2, -lse0));
            float pb = mma::ex2(fmaf(sa[4 * j + 2 + e], scale_log2, -lse1));
            if (masked) {
              const int key = kl + 8 * j + e;
              if (key > lim0) pa = 0.f;
              if (key > lim1) pb = 0.f;
            }
            sa[4 * j + e] = pa;
            sa[4 * j + 2 + e] = pb;
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_operand(dpa);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sa[4 * j] *= dpa[4 * j] - di0;  // dS = P (dP - di)
          sa[4 * j + 1] *= dpa[4 * j + 1] - di0;
          sa[4 * j + 2] *= dpa[4 * j + 2] - di1;
          sa[4 * j + 3] *= dpa[4 * j + 3] - di1;
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            da[kk][i] =
                mma::pack_bf16(sa[8 * kk + 2 * i], sa[8 * kk + 2 * i + 1]);
        hopper::fence_operand(dqa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dQ += dS K (scaled at the end)
          hopper::wgmma_rs<D>(dqa, da[kk], T::mn_major(k_t, kk));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(da);
        hopper::fence_operand(dqa);
      }
      if constexpr (Cfg::kProducer) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      } else if (last_done(&done[s]) && t + NS < n_tiles) {
        if (lane == 0) produce(t + NS);
        __syncwarp();
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + (lane & 3) * 2;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(dq + row0 * D + c) =
            mma::pack_bf16(dqa[4 * n] * scale, dqa[4 * n + 1] * scale);
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(dq + row1 * D + c) =
            mma::pack_bf16(dqa[4 * n + 2] * scale, dqa[4 * n + 3] * scale);
    }
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

// b, sq and skv all > 0
template <int D>
int launch_wgmma(const Args& a) {
  using Cfg = BwdWg<D>;
  constexpr int W = Cfg::kW;
  CUtensorMap tq, tk, tv, tdo;  // 64-row boxes of every (b, head) matrix
  if (hopper::make_tile_map(&tq, a.q, D, a.sq, a.b * a.h, W, kWgRows) ||
      hopper::make_tile_map(&tdo, a.dout, D, a.sq, a.b * a.h, W, kWgRows) ||
      hopper::make_tile_map(&tk, a.k, D, a.skv, a.b * a.kvh, W, kWgRows) ||
      hopper::make_tile_map(&tv, a.v, D, a.skv, a.b * a.kvh, W, kWgRows))
    return -3;
  const float* di = static_cast<const float*>(a.di);
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<D>;
  int err = (int)allow_smem(dkdv, Cfg::kDkdvSmem);
  if (err) return err;
  dkdv<<<dim3(a.b * a.kvh, (a.skv + kWgBlockRows - 1) / kWgBlockRows),
         Cfg::kThreads, Cfg::kDkdvSmem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, di, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.h, a.kvh, a.sq, a.skv, a.causal, a.scale);
  if ((err = (int)cudaGetLastError())) return err;
  auto dq = flash_bwd_dq_wgmma_kernel<D>;
  if ((err = (int)allow_smem(dq, Cfg::kDqSmem))) return err;
  dq<<<dim3(a.b * a.h, (a.sq + kWgBlockRows - 1) / kWgBlockRows), Cfg::kThreads,
       Cfg::kDqSmem, a.stream>>>(tq, tk, tv, tdo, a.lse, di,
                                 static_cast<bf16*>(a.dq), a.h, a.kvh, a.sq,
                                 a.skv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a) {
  if (!mma::aligned16(a.q, a.k, a.v, a.dout)) return -2;
  if (a.b == 0) return 0;
  if (a.sq == 0 || a.skv == 0) {  // no attended pair: zero gradients
    cudaMemsetAsync(a.dq, 0, (size_t)a.b * a.h * a.sq * D * 2, a.stream);
    cudaMemsetAsync(a.dk, 0, (size_t)a.b * a.kvh * a.skv * D * 2, a.stream);
    cudaMemsetAsync(a.dv, 0, (size_t)a.b * a.kvh * a.skv * D * 2, a.stream);
    return (int)cudaGetLastError();
  }
  const int err = launch_dot<D>(a);
  return err ? err : launch_wgmma<D>(a);
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

// which: 0 dK/dV, 1 dQ
template <int D>
int bf16_info(int which, int* info) {
  using Cfg = BwdWg<D>;
  if (which == 0)
    return kernel_info(flash_bwd_dkdv_wgmma_kernel<D>, Cfg::kThreads,
                       Cfg::kDkdvSmem, info);
  if (which == 1)
    return kernel_info(flash_bwd_dq_wgmma_kernel<D>, Cfg::kThreads,
                       Cfg::kDqSmem, info);
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
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(a);
  if (dtype == 1 && head_dim == 80) return launch_bf16<80>(a);
  if (dtype == 1 && head_dim == 128) return launch_bf16<128>(a);
  return -1;
}

// The bf16 dK/dV (which 0) or dQ (which 1) kernel at head_dim as the card
// runs it: info[0] registers a thread at launch (setmaxnreg then moves
// them from the producer warpgroup to the consumers at D 64 and 80), [1]
// local (spilled) bytes a thread, [2] dynamic shared memory bytes a block,
// [3] blocks resident per SM. Returns 0 or a CUDA error.
int flash_attention_backward_info(int head_dim, int which, int* info) {
  if (head_dim == 64) return bf16_info<64>(which, info);
  if (head_dim == 80) return bf16_info<80>(which, info);
  if (head_dim == 128) return bf16_info<128>(which, info);
  return -1;
}

}  // extern "C"
