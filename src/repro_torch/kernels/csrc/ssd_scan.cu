// Mamba2 SSD (state-space duality): the chunked prefill scan and the
// one-token decode step, as CUDA kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   scan    -> src/repro/kernels/ssd_scan.py:ssd_scan_bhsp (_ssd_kernel)
//   decode  -> src/repro/kernels/ssd_scan.py:ssd_decode_step_bh
//              (_ssd_decode_kernel)
//
// What they compute (the plain versions are src/repro_torch/kernels/ref.py
// ssd_chunked and ssd_decode_step): per (batch b, head h) an f32 state
// h (P, N) evolves as h_t = e^{dt_t a} h_{t-1} + (dt_t x_t) B_t^T and emits
// y_t = h_t C_t. B and C are shared by all heads (one group).
//
// Layouts (all contiguous): the scan reads the ops layout directly, x and y
// (B, S, H, P), dt (B, S, H) f32, A (H,) f32, Bm/Cm (B, S, N), init and
// final state (B, H, P, N) f32, so no transpose runs around it. The decode
// step takes state (B, H, P, N) f32, x (B, H, P), dt (B, H) f32, B/C
// (B, N). x, B, C and y are f32 or bf16 (one type per call); arithmetic and
// state are f32; y is written in x's type.
//
// ---------------------------------------------------------------------------
// ssd_decode (replaces ssd_decode_step_bh)
//
// Bound on the H100: bytes. Every state element is read once and takes 5
// flops; an active slot's element is also written once. At the engine's
// shape (8 slots x 64 heads x 64 x 128 f32) one launch reads 16.8 MB of
// state and writes 2.1 MB per active slot: 33.6 MB and ~10 us at 3.35 TB/s
// with all 8 slots active, against ~0.3 us of f32 arithmetic.
//
// Design: one block per (b, h), 8 warps; B and C of the row are staged in
// shared memory as f32, and each warp walks rows p of the state four at a
// time, every lane reading and writing 16-byte vectors (a warp covers 128
// contiguous floats of a row per instruction), so each lane keeps four
// independent 16-byte loads in flight before it computes; y is a warp
// shuffle reduction over N. The state is updated in place (the JAX step
// donates its bank instead), so an idle slot costs no write: an optional
// active vector (B,) int32 gates the writeback per slot, as the JAX
// engine's _mask_state does. An idle slot's state is left untouched, while
// its y is still computed from the advanced state, exactly as the JAX step
// computes it.
//
// ---------------------------------------------------------------------------
// ssd_scan (replaces ssd_scan_bhsp)
//
// The Pallas kernel carries the state across a sequential grid axis in
// VMEM. Blocks on Hopper run in no order, so one block loops over the
// sequence's 64-token sub-chunks itself. The rows of the (P, N) state
// evolve independently given B, C and dt, so a block owns a slice of P rows
// of one (b, h). The chunk length inside the kernel is fixed at Q = 64
// whatever the caller's chunk (the result does not depend on it up to
// rounding: tests/test_kernels.py::test_ssd_chunk_invariance). A ragged
// last sub-chunk is zero-filled inside the kernel: dt = 0 and x = B = C =
// 0, exact identities on the recurrence, never written out. Per sub-chunk,
// with cs the inclusive cumulative sum of dt*a over its rows,
//   y     = ((C B^T) o L o dt_j) x + e^{cs} (C state^T),
//           L[i][j] = e^{cs_i - cs_j} for j <= i, else 0
//   state = e^{cs_last} state + (x dt e^{cs_last - cs})^T B
//
// What bounds it on the H100: bytes and fixed cost. The engine calls it
// once per layer per 64-token prefill chunk of one sequence (B 1, S 64,
// H 64, P 64, N 128, bf16): the 2.1 MB f32 entering state, the 2.1 MB
// final state, x, y, B, C and dt are 5.3 MB, 1.58 us at 3.35 TB/s; its
// 0.15 GFLOP take ~0.15 us on the tensor cores. A launch, each block's
// first loads and the serial chain of its phases cost more than either.
//
// bf16, P and N multiples of 16, N <= 256 (ssd_scan_mma_kernel): one
// block of 4 warps per (b, h, slice of R P-rows), R = 16, 32 or 64 as the
// caller asks (kernels/ssd_scan.py::scan_rows: 32 where P allows it, the
// fastest of the three at the engine's shape in tools/ssd_ablation.py;
// R x N <= 8192, so a warp holds at most 8 16x16 state tiles). The engine's
// shape is 2 x 64 x 1 = 128 blocks, about one per SM. At entry the block
// issues 16-byte cp.async copies of all it needs in three groups: the
// sub-chunk's B and C (64 x N bf16), its x columns (64 x R) and dt; its R
// state rows (f32, the one input that comes from device memory rather than
// L2); and, for S > 64, the next sub-chunk's B, C, x and dt into a second
// buffer, which is refilled while each sub-chunk computes. C B^T and the
// decay scan wait for the first group only (warp 0 takes the cumulative
// sum of dt*a by shuffles while every warp runs C B^T); the state's bf16
// copy is made after them. All four products run on mma.sync m16n8k16
// (bf16 operands, f32 sums; attention_mma.cuh's helpers), warp w owning
// rows 16w..16w+15 of the sub-chunk:
//   G = C B^T        bf16 x bf16, exact products; only the key tiles j <= i
//                    of the warp's rows (causal).
//   M = G o e^{cs_i - cs_j} dt_j for j <= i, else 0, on G's accumulator
//                    fragments (the exponent taken only where j <= i: for
//                    j > i it is positive and may overflow, and inf * 0 is
//                    NaN). Rounded to bf16 once, M is the A operand of M x
//                    straight from registers, as attention_mma.cuh reuses
//                    P; folding dt into M keeps x an exact bf16 operand.
//   y_off = C state^T, from a bf16 copy of the entering state in shared
//                    memory (rounded once per sub-chunk), scaled by e^{cs_i}
//                    and added to M x in f32. y is stored in bf16, rows < q.
//   state' = e^{cs_last} state + xw^T B, xw = x dt e^{cs_last - cs} rounded
//                    to bf16 once, B exact. The block's state lives in f32
//                    accumulator fragments for the whole scan: loaded from
//                    init (or zero) times e^{cs_last} at the first update,
//                    accumulated in place, stored once, in f32, straight
//                    from the fragments at the end. The carried state is
//                    never rounded; only its bf16 copy for y_off is.
// Each block computes C B^T itself (64 mma a warp at N 128, well under a
// microsecond); sharing it across the H x P/R blocks of a (b, sub-chunk)
// would cost a second launch or a global round trip (ROADMAP B.5's first
// plan, superseded). Shared memory at the engine's shape (R 32, N 128, one
// buffer): 71,680 B. What is left at that shape is fixed cost
// (tools/ssd_ablation.py): the launch, one round of loads (B and C, the
// same 32 KB for every block, are its largest part) and the stores take
// most of the time; the products about a fifth.
//
// Other shapes, and f32 (ssd_scan_kernel, the first version): a block owns
// 16 state rows of one (b, h), 256 threads; per sub-chunk it stages B, C,
// dt and x*dt in f32 in shared memory (rows padded to N + 1 against bank
// conflicts), takes the cumulative sum with a warp scan, and runs the same
// four products on CUDA cores in f32 with register tiles. It is exact for
// the f32 parity runs (TF32 off).
//
// Dynamic shared memory above 48 KB must be opted into per kernel and
// device; each launcher sets the cap once per device to the device's
// opt-in maximum, so no launch (on any thread) is refused because another
// set a smaller cap (the fault of ROADMAP C.3). Every launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError() (or a
// negative code for an unsupported dtype or shape, which the Python
// wrapper rules out before calling).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attention_mma.cuh"

namespace {

namespace mma = attn_mma;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------- decode ------------------------------------

constexpr int kDecodeThreads = 256;
constexpr int kDecodeRows = 4;  // state rows a warp keeps in flight

// At least 4 blocks per SM: at 64 registers per thread the engine's 512
// (slot, head) blocks are all resident on 132 SMs in one wave; at 69, which
// ptxas chooses unbounded, only 3 fit per SM and a second wave costs ~7%.
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads, 4)
ssd_decode_kernel(float* __restrict__ state,
                  const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const int* __restrict__ active,
                  T* __restrict__ y, int H, int P, int N) {
  extern __shared__ float smem[];
  float* sb = smem;      // (N,) B row, f32
  float* sc = smem + N;  // (N,) C row, f32
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    sb[n] = to_f32(Bm[(size_t)b * N + n]);
    sc[n] = to_f32(Cm[(size_t)b * N + n]);
  }
  __syncthreads();

  const float dtv = dt[bh];
  const float decay = expf(dtv * A[h]);
  const bool write = active == nullptr || active[b] != 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int n4 = N >> 2;
  const size_t base = (size_t)bh * P * N;
  float4* st4 = reinterpret_cast<float4*>(state + base);

  for (int p0 = warp * kDecodeRows; p0 < P; p0 += nwarps * kDecodeRows) {
    float dx[kDecodeRows], acc[kDecodeRows];
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) {
      const int p = p0 + r;
      dx[r] = p < P ? dtv * to_f32(x[(size_t)bh * P + p]) : 0.f;
      acc[r] = 0.f;
    }
    for (int c = lane; c < n4; c += 32) {
      float4 old[kDecodeRows];
#pragma unroll
      for (int r = 0; r < kDecodeRows; ++r)
        if (p0 + r < P) old[r] = st4[(size_t)(p0 + r) * n4 + c];
      const float4 bv = reinterpret_cast<const float4*>(sb)[c];
      const float4 cv = reinterpret_cast<const float4*>(sc)[c];
#pragma unroll
      for (int r = 0; r < kDecodeRows; ++r) {
        if (p0 + r >= P) continue;
        float4 nw;
        nw.x = old[r].x * decay + dx[r] * bv.x;
        nw.y = old[r].y * decay + dx[r] * bv.y;
        nw.z = old[r].z * decay + dx[r] * bv.z;
        nw.w = old[r].w * decay + dx[r] * bv.w;
        acc[r] += nw.x * cv.x + nw.y * cv.y + nw.z * cv.z + nw.w * cv.w;
        if (write) st4[(size_t)(p0 + r) * n4 + c] = nw;
      }
    }
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) {
      float v = acc[r];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && p0 + r < P) y[(size_t)bh * P + p0 + r] = from_f32<T>(v);
    }
  }
}

// -------------------------------- scan -------------------------------------

constexpr int kScanThreads = 256;
constexpr int kQ = 64;   // sub-chunk length inside the kernel
constexpr int kPB = 16;  // state rows (of P) per block

__host__ __device__ constexpr size_t scan_smem_floats(int n) {
  return 2 * (size_t)kQ * (n + 1)      // sB, sC
         + (size_t)kQ * (kQ + 1)       // scores
         + 2 * (size_t)kQ * kPB        // x*dt, x*dt*e^{cs_last - cs}
         + (size_t)kPB * (n + 1)       // state
         + 3 * (size_t)kQ;             // cs, e^{cs}, e^{cs_last - cs}
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ fs, int S, int H,
                int P, int N) {
  extern __shared__ float smem[];
  const int ns = N + 1;  // padded row stride of B, C and the state
  float* sB = smem;                       // (Q, N+1)
  float* sC = sB + kQ * ns;               // (Q, N+1)
  float* sS = sC + kQ * ns;               // (Q, Q+1) masked decayed scores
  float* sX = sS + kQ * (kQ + 1);         // (Q, PB) x*dt
  float* sXw = sX + kQ * kPB;             // (Q, PB) x*dt*e^{cs_last - cs_j}
  float* sSt = sXw + kQ * kPB;            // (PB, N+1) carried state
  float* cs = sSt + kPB * ns;             // (Q,) inclusive cumsum of dt*a
  float* ecs = cs + kQ;                   // (Q,) e^{cs_i}
  float* wend = ecs + kQ;                 // (Q,) e^{cs_last - cs_j}

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];

  for (int idx = tid; idx < kPB * N; idx += kScanThreads) {
    const int pp = idx / N, n = idx % N, p = p0 + pp;
    sSt[pp * ns + n] = (init != nullptr && p < P)
        ? init[(((size_t)b * H + h) * P + p) * N + n] : 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kQ) {
    const int q = min(kQ, S - s0);
    // ---- stage B, C, dt*a and x*dt (rows past q are zero: dt = 0) ----
    for (int idx = tid; idx < kQ * N; idx += kScanThreads) {
      const int i = idx / N, n = idx % N;
      const size_t g = ((size_t)b * S + s0 + i) * N + n;
      sB[i * ns + n] = i < q ? to_f32(Bm[g]) : 0.f;
      sC[i * ns + n] = i < q ? to_f32(Cm[g]) : 0.f;
    }
    for (int idx = tid; idx < kQ * kPB; idx += kScanThreads) {
      const int i = idx / kPB, pp = idx % kPB, p = p0 + pp;
      float v = 0.f;
      if (i < q && p < P) {
        const size_t row = ((size_t)b * S + s0 + i) * H + h;
        v = to_f32(x[row * P + p]) * dt[row];
      }
      sX[i * kPB + pp] = v;
    }
    if (tid < 32) {
      // inclusive warp scan of dt*a over the Q = 64 rows, two per lane
      const int i0 = 2 * tid, i1 = i0 + 1;
      const size_t r0 = ((size_t)b * S + s0 + i0) * H + h;
      const float v0 = i0 < q ? dt[r0] * a : 0.f;
      const float v1 = i1 < q ? dt[r0 + H] * a : 0.f;
      float run = v0 + v1;
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += up;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (tid == 0) before = 0.f;
      cs[i0] = before + v0;
      cs[i1] = run;
      const float last = __shfl_sync(0xffffffffu, run, 31);
      ecs[i0] = expf(cs[i0]);
      ecs[i1] = expf(run);
      wend[i0] = expf(last - cs[i0]);
      wend[i1] = expf(last - run);
    }
    __syncthreads();

    for (int idx = tid; idx < kQ * kPB; idx += kScanThreads)
      sXw[idx] = sX[idx] * wend[idx / kPB];
    {
      // ---- scores: a 4 x 4 tile of (C B^T) o L per thread ----
      const int ti = tid >> 4, tj = tid & 15;
      float acc[4][4] = {};
      if (tj <= ti) {
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cv[r] = sC[(4 * ti + r) * ns + n];
            bv[r] = sB[(4 * tj + r) * ns + n];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += cv[r] * bv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * ti + r, j = 4 * tj + c;
          sS[i * (kQ + 1) + j] =
              j <= i ? acc[r][c] * expf(cs[i] - cs[j]) : 0.f;
        }
    }
    __syncthreads();

    {
      // ---- y for 4 rows x 1 state row per thread, from the OLD state ----
      const int pp = tid & 15, ib = tid >> 4;
      float yd[4] = {}, yo[4] = {};
      for (int j = 0; j < 4 * ib + 4; ++j) {
        const float xv = sX[j * kPB + pp];
#pragma unroll
        for (int r = 0; r < 4; ++r) yd[r] += sS[(4 * ib + r) * (kQ + 1) + j] * xv;
      }
      for (int n = 0; n < N; ++n) {
        const float sv = sSt[pp * ns + n];
#pragma unroll
        for (int r = 0; r < 4; ++r) yo[r] += sC[(4 * ib + r) * ns + n] * sv;
      }
      const int p = p0 + pp;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ib + r;
        if (i < q && p < P)
          y[(((size_t)b * S + s0 + i) * H + h) * P + p] =
              from_f32<T>(yd[r] + yo[r] * ecs[i]);
      }
    }
    __syncthreads();

    // ---- state update: 4 state rows x 1 column of B per work item ----
    const float dtot = ecs[kQ - 1];
    for (int idx = tid; idx < (kPB / 4) * N; idx += kScanThreads) {
      const int n = idx % N, pg = idx / N;
      float upd[4] = {};
      for (int j = 0; j < kQ; ++j) {
        const float bv = sB[j * ns + n];
        const float4 w = reinterpret_cast<const float4*>(sXw + j * kPB)[pg];
        upd[0] += w.x * bv;
        upd[1] += w.y * bv;
        upd[2] += w.z * bv;
        upd[3] += w.w * bv;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* st = sSt + (4 * pg + r) * ns + n;
        *st = *st * dtot + upd[r];
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < kPB * N; idx += kScanThreads) {
    const int pp = idx / N, n = idx % N, p = p0 + pp;
    if (p < P) fs[(((size_t)b * H + h) * P + p) * N + n] = sSt[pp * ns + n];
  }
}

// ------------------------------ scan, bf16 ---------------------------------

constexpr int kMmaThreads = 128;         // 4 warps: warp w owns rows 16w..
constexpr int kMmaStateElems = 64 * 128;  // R x N a block's fragments hold

// 16x16 state tiles a warp holds at most: R x N / (256 x 4 warps), with N
// up to 256 (R 16) or 8192 / R
template <int R>
__host__ __device__ constexpr int mma_units() {
  return R * (kMmaStateElems / R < 256 ? kMmaStateElems / R : 256) / 1024;
}

// whether ssd_scan_mma_kernel<rows> takes P and N
__host__ inline bool mma_shape_ok(int rows, int p, int n) {
  return (rows == 16 || rows == 32 || rows == 64) && p % rows == 0 &&
         n % 16 == 0 && n >= 16 && n <= 256 && rows * n <= kMmaStateElems;
}

// The tensor-core scan's shared memory, byte offsets. Row strides in
// elements: bf16 rows of N are padded to N + 8 and of R to R + 8 (the 8
// rows an ldmatrix phase reads fall on distinct banks; 16-byte cp.async
// destinations stay aligned), f32 rows of N to N + 4.
struct ScanLayout {
  int ldn, ldr, ldf;
  size_t st32, st16, xw, cs2, ecs, dtw, buf0, buf_bytes, total;
  // inside a buffer: B, C (64 x ldn bf16), x (64 x ldr bf16), dt (64 f32)
  size_t off_c, off_x, off_dt;

  __host__ __device__ ScanLayout(int r, int n, int nbuf) {
    ldn = n + 8;
    ldr = r + 8;
    ldf = n + 4;
    st32 = 0;
    st16 = st32 + (size_t)r * ldf * 4;
    xw = st16 + (size_t)r * ldn * 2;
    cs2 = xw + (size_t)kQ * ldr * 2;
    ecs = cs2 + kQ * 4;
    dtw = ecs + kQ * 4;
    buf0 = dtw + kQ * 4;
    off_c = (size_t)kQ * ldn * 2;
    off_x = 2 * off_c;
    off_dt = off_x + (size_t)kQ * ldr * 2;
    buf_bytes = off_dt + kQ * 4;
    total = buf0 + nbuf * buf_bytes;
  }
};

template <int R>
__global__ void __launch_bounds__(kMmaThreads)
ssd_scan_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const float* __restrict__ init,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ fs,
                    int S, int H, int P, int N) {
  static_assert(R == 16 || R == 32 || R == 64, "16, 32 or 64 rows");
  constexpr int kUnits = mma_units<R>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nsub = (S + kQ - 1) / kQ;
  const ScanLayout L(R, N, nsub > 1 ? 2 : 1);
  const int ldn = L.ldn, ldr = L.ldr, ldf = L.ldf;
  float* st32 =  // (R, ldf) f32: the entering state
      reinterpret_cast<float*>(smem_raw + L.st32);
  __nv_bfloat16* st16 =                                   // (R, ldn) bf16
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L.st16);
  __nv_bfloat16* sxw =                                    // (64, ldr) bf16
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L.xw);
  float* cs2 = reinterpret_cast<float*>(smem_raw + L.cs2);  // cs * log2 e
  float* ecs = reinterpret_cast<float*>(smem_raw + L.ecs);  // e^{cs}
  float* dtw = reinterpret_cast<float*>(smem_raw + L.dtw);  // dt e^{cs_last-cs}

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
  const int p0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];
  const bool has_init = init != nullptr;
  const int n16 = N / 16, units = (R / 16) * n16;

  // ---- stage sub-chunk k into buffer bf: rows past its end zero-filled ----
  auto load_sub = [&](int k, int bf) {
    unsigned char* buf = smem_raw + L.buf0 + bf * L.buf_bytes;
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(buf);
    __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(buf + L.off_c);
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(buf + L.off_x);
    float* sd = reinterpret_cast<float*>(buf + L.off_dt);
    const int s0 = k * kQ, q = min(kQ, S - s0);
    const int nch = N / 8;
    for (int idx = tid; idx < kQ * nch; idx += kMmaThreads) {
      const int i = idx / nch, ch = idx - i * nch;
      const bool ok = i < q;
      const size_t src = ok ? ((size_t)b * S + s0 + i) * N + ch * 8 : 0;
      mma::cp_async_16(sb + i * ldn + ch * 8, Bm + src, ok);
      mma::cp_async_16(sc + i * ldn + ch * 8, Cm + src, ok);
    }
    constexpr int xch = R / 8;
    for (int idx = tid; idx < kQ * xch; idx += kMmaThreads) {
      const int i = idx / xch, ch = idx % xch;
      const bool ok = i < q;
      const size_t src =
          ok ? (((size_t)b * S + s0 + i) * H + h) * P + p0 + ch * 8 : 0;
      mma::cp_async_16(sx + i * ldr + ch * 8, x + src, ok);
    }
    if (tid < kQ) {
      const bool ok = tid < q;
      mma::cp_async_4(sd + tid, dt + (ok ? ((size_t)b * S + s0 + tid) * H + h
                                         : 0),
                      ok);
    }
  };

  // copy groups: sub-chunk 0, the entering state, sub-chunk 1. C B^T and
  // the decay scan need only the first, so they run while the state (the
  // one read from device memory rather than L2) is still arriving.
  const int fch = N / 4;  // 16-byte chunks of an f32 state row
  const float* init_rows =
      has_init ? init + (((size_t)b * H + h) * P + p0) * N : nullptr;
  load_sub(0, 0);
  mma::cp_async_commit();
  if (has_init) {
    for (int idx = tid; idx < R * fch; idx += kMmaThreads) {
      const int r = idx / fch, ch = idx - r * fch;
      mma::cp_async_16(st32 + r * ldf + ch * 4, init_rows + (size_t)r * N +
                                                    ch * 4, true);
    }
  }
  mma::cp_async_commit();
  if (nsub > 1) load_sub(1, 1);
  mma::cp_async_commit();
  mma::cp_async_wait<2>();
  __syncthreads();  // sub-chunk 0 has landed

  // the block's state: unit warp + 4u is the 16x16 tile (mt, nt) of the
  // R x N state, n-tiles 2nt and 2nt + 1 in the mma accumulator layout
  float st[kUnits][2][4];
  const int i0 = 16 * warp + g, i1 = i0 + 8;  // this lane's rows

  for (int k = 0; k < nsub; ++k) {
    unsigned char* buf = smem_raw + L.buf0 + (k & 1) * L.buf_bytes;
    const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(buf);
    const __nv_bfloat16* sc =
        reinterpret_cast<const __nv_bfloat16*>(buf + L.off_c);
    const __nv_bfloat16* sx =
        reinterpret_cast<const __nv_bfloat16*>(buf + L.off_x);
    const float* sd = reinterpret_cast<const float*>(buf + L.off_dt);
    const int s0 = k * kQ, q = min(kQ, S - s0);
    const bool with_state = has_init || k > 0;

    // ---- warp 0: inclusive scan of dt*a over the 64 rows, two per lane ----
    if (warp == 0) {
      const int j0 = 2 * lane, j1 = j0 + 1;
      const float v0 = sd[j0] * a, v1 = sd[j1] * a;
      float run = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += up;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) before = 0.f;
      const float cs0 = before + v0;
      const float last = __shfl_sync(0xffffffffu, run, 31);
      cs2[j0] = cs0 * mma::kLog2e;
      cs2[j1] = run * mma::kLog2e;
      ecs[j0] = expf(cs0);
      ecs[j1] = expf(run);
      dtw[j0] = sd[j0] * expf(last - cs0);
      dtw[j1] = sd[j1] * expf(last - run);
    }

    // ---- G = C B^T over the key tiles the warp's rows reach, while warp
    //      0 scans; then y_off = C state^T ----
    float gacc[8][4], yacc[R / 8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) gacc[t][0] = gacc[t][1] = gacc[t][2] = gacc[t][3] = 0.f;
#pragma unroll
    for (int t = 0; t < R / 8; ++t) yacc[t][0] = yacc[t][1] = yacc[t][2] = yacc[t][3] = 0.f;
    for (int kk = 0; kk < n16; ++kk) {
      uint32_t af[4];
      mma::ldsm_x4(af, sc + (16 * warp + (lane & 15)) * ldn + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        if (nn <= warp) {
          uint32_t bf[4];
          mma::ldsm_x4(bf, sb + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    ldn +
                                kk * 16 + ((lane >> 3) & 1) * 8);
          mma::mma_bf16(gacc[2 * nn], af, bf[0], bf[1]);
          mma::mma_bf16(gacc[2 * nn + 1], af, bf[2], bf[3]);
        }
      }
    }
    if (k == 0 && has_init) {
      // the bf16 copy of the entering state, from this thread's own copies
      mma::cp_async_wait<1>();
      for (int idx = tid; idx < R * fch; idx += kMmaThreads) {
        const int r = idx / fch, ch = idx - r * fch;
        const float4 v = *reinterpret_cast<const float4*>(st32 + r * ldf +
                                                          ch * 4);
        uint2 packed;
        packed.x = mma::pack_bf16(v.x, v.y);
        packed.y = mma::pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(st16 + r * ldn + ch * 4) = packed;
      }
    }
    __syncthreads();  // cs2, ecs, dtw; the entering state's bf16 copy
    if (with_state) {
      for (int kk = 0; kk < n16; ++kk) {
        uint32_t af[4];
        mma::ldsm_x4(af, sc + (16 * warp + (lane & 15)) * ldn + kk * 16 +
                             (lane >> 4) * 8);
#pragma unroll
        for (int pn = 0; pn < R / 16; ++pn) {
          uint32_t bf[4];
          mma::ldsm_x4(bf, st16 + (pn * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      ldn +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
          mma::mma_bf16(yacc[2 * pn], af, bf[0], bf[1]);
          mma::mma_bf16(yacc[2 * pn + 1], af, bf[2], bf[3]);
        }
      }
    }

    // ---- xw = x dt e^{cs_last - cs}, rounded to bf16 once ----
    for (int idx = tid; idx < kQ * (R / 2); idx += kMmaThreads) {
      const int i = idx / (R / 2), pp = (idx % (R / 2)) * 2;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sx + i * ldr + pp));
      const float w = dtw[i];
      *reinterpret_cast<uint32_t*>(sxw + i * ldr + pp) =
          mma::pack_bf16(xv.x * w, xv.y * w);
    }

    // ---- M = G o e^{cs_i - cs_j} dt_j (j <= i) in registers; y = M x +
    //      e^{cs_i} y_off ----
    {
      const float e0 = ecs[i0], e1 = ecs[i1];
      const float l0 = cs2[i0], l1 = cs2[i1];
#pragma unroll
      for (int t = 0; t < R / 8; ++t) {
        yacc[t][0] *= e0;
        yacc[t][1] *= e0;
        yacc[t][2] *= e1;
        yacc[t][3] *= e1;
      }
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        if (jt < 2 * warp + 2) {
          const int j = 8 * jt + c;
          const float2 lj = *reinterpret_cast<const float2*>(cs2 + j);
          const float2 dj = *reinterpret_cast<const float2*>(sd + j);
          gacc[jt][0] = j <= i0 ? gacc[jt][0] * mma::ex2(l0 - lj.x) * dj.x : 0.f;
          gacc[jt][1] = j + 1 <= i0 ? gacc[jt][1] * mma::ex2(l0 - lj.y) * dj.y
                                    : 0.f;
          gacc[jt][2] = j <= i1 ? gacc[jt][2] * mma::ex2(l1 - lj.x) * dj.x : 0.f;
          gacc[jt][3] = j + 1 <= i1 ? gacc[jt][3] * mma::ex2(l1 - lj.y) * dj.y
                                    : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk <= warp) {
          const uint32_t am[4] = {
              mma::pack_bf16(gacc[2 * kk][0], gacc[2 * kk][1]),
              mma::pack_bf16(gacc[2 * kk][2], gacc[2 * kk][3]),
              mma::pack_bf16(gacc[2 * kk + 1][0], gacc[2 * kk + 1][1]),
              mma::pack_bf16(gacc[2 * kk + 1][2], gacc[2 * kk + 1][3])};
#pragma unroll
          for (int dn = 0; dn < R / 16; ++dn) {
            uint32_t bx[4];
            mma::ldsm_x4_t(bx, sx + (kk * 16 + (lane & 15)) * ldr + dn * 16 +
                                   (lane >> 4) * 8);
            mma::mma_bf16(yacc[2 * dn], am, bx[0], bx[1]);
            mma::mma_bf16(yacc[2 * dn + 1], am, bx[2], bx[3]);
          }
        }
      }
      const size_t row0 = (((size_t)b * S + s0 + i0) * H + h) * P + p0 + c;
      const size_t row1 = row0 + (size_t)8 * H * P;
#pragma unroll
      for (int t = 0; t < R / 8; ++t) {
        if (i0 < q)
          *reinterpret_cast<uint32_t*>(y + row0 + 8 * t) =
              mma::pack_bf16(yacc[t][0], yacc[t][1]);
        if (i1 < q)
          *reinterpret_cast<uint32_t*>(y + row1 + 8 * t) =
              mma::pack_bf16(yacc[t][2], yacc[t][3]);
      }
    }
    __syncthreads();  // xw

    // ---- state' = e^{cs_last} state + xw^T B, in the f32 fragments ----
    const float dec = ecs[kQ - 1];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int unit = warp + 4 * u;
      if (unit < units) {
        const int mt = unit / n16, nt = unit - mt * n16;
        if (k == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int pr = mt * 16 + g + (r >> 1) * 8;
              const int nc = nt * 16 + e * 8 + c + (r & 1);
              st[u][e][r] = has_init ? st32[pr * ldf + nc] * dec : 0.f;
            }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int r = 0; r < 4; ++r) st[u][e][r] *= dec;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4], bf[4];
          mma::ldsm_x4_t(af, sxw + (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                                       ldr +
                                   mt * 16 + ((lane >> 3) & 1) * 8);
          mma::ldsm_x4_t(bf, sb + (kk * 16 + (lane & 15)) * ldn + nt * 16 +
                                  (lane >> 4) * 8);
          mma::mma_bf16(st[u][0], af, bf[0], bf[1]);
          mma::mma_bf16(st[u][1], af, bf[2], bf[3]);
        }
      }
    }

    if (k + 1 < nsub) {
      // the bf16 copy of the new state, for the next sub-chunk's y_off
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int unit = warp + 4 * u;
        if (unit < units) {
          const int mt = unit / n16, nt = unit - mt * n16;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            __nv_bfloat16* d =
                st16 + (mt * 16 + g) * ldn + nt * 16 + e * 8 + c;
            *reinterpret_cast<uint32_t*>(d) =
                mma::pack_bf16(st[u][e][0], st[u][e][1]);
            *reinterpret_cast<uint32_t*>(d + 8 * ldn) =
                mma::pack_bf16(st[u][e][2], st[u][e][3]);
          }
        }
      }
      __syncthreads();  // this buffer is free, the bf16 state is written
      if (k + 2 < nsub) load_sub(k + 2, k & 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
      __syncthreads();  // sub-chunk k + 1 has landed
    }
  }

  // ---- the final state, f32, from the fragments: a lane quad writes 32
  //      contiguous bytes of a row ----
  float* out_rows = fs + (((size_t)b * H + h) * P + p0) * N;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int unit = warp + 4 * u;
    if (unit < units) {
      const int mt = unit / n16, nt = unit - mt * n16;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* d = out_rows + (size_t)(mt * 16 + g) * N + nt * 16 + e * 8 + c;
        *reinterpret_cast<float2*>(d) = make_float2(st[u][e][0], st[u][e][1]);
        *reinterpret_cast<float2*>(d + 8 * (size_t)N) =
            make_float2(st[u][e][2], st[u][e][3]);
      }
    }
  }
}

// Lets `kernel` take up to the device's opt-in dynamic shared memory. Set
// once per device (`done`: one bit per device, static in each launcher
// instance), to one fixed cap, so no launch on any thread is refused
// because another set the cap to its own, smaller need.
template <typename K>
cudaError_t allow_dynamic_smem(K kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

// info[0] registers a thread, [1] local (spilled) bytes a thread, [2]
// dynamic shared memory bytes a block, [3] blocks resident per SM
template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  return 0;
}

template <typename T>
int launch_decode(float* state, const void* x, const float* dt,
                  const float* A, const void* Bm, const void* Cm,
                  const int* active, void* y, int b, int h, int p, int n,
                  cudaStream_t s) {
  const size_t smem = 2 * (size_t)n * sizeof(float);
  ssd_decode_kernel<T><<<b * h, kDecodeThreads, smem, s>>>(
      state, static_cast<const T*>(x), dt, A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), active,
      static_cast<T*>(y), h, p, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scan(const void* x, const float* dt, const float* A,
                const void* Bm, const void* Cm, const float* init, void* y,
                float* fs, int b, int s, int h, int p, int n,
                cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const size_t smem = scan_smem_floats(n) * sizeof(float);
  const cudaError_t err = allow_dynamic_smem(ssd_scan_kernel<T>, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p + kPB - 1) / kPB, h, b);
  ssd_scan_kernel<T><<<grid, kScanThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, static_cast<T*>(y), fs, s, h, p, n);
  return (int)cudaGetLastError();
}

template <int R>
int launch_scan_mma(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, const float* init,
                    void* y, float* fs, int b, int s, int h, int p, int n,
                    cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const size_t smem = ScanLayout(R, n, s > kQ ? 2 : 1).total;
  const cudaError_t err = allow_dynamic_smem(ssd_scan_mma_kernel<R>, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p / R, h, b);
  ssd_scan_mma_kernel<R><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), init,
      static_cast<__nv_bfloat16*>(y), fs, s, h, p, n);
  return (int)cudaGetLastError();
}

template <typename T>
int scan_info(int n, int* info) {
  static std::atomic<unsigned> done{0};
  const cudaError_t err = allow_dynamic_smem(ssd_scan_kernel<T>, done);
  if (err != cudaSuccess) return (int)err;
  return kernel_info(ssd_scan_kernel<T>, kScanThreads,
                     scan_smem_floats(n) * sizeof(float), info);
}

template <int R>
int scan_mma_info(int s, int n, int* info) {
  static std::atomic<unsigned> done{0};
  const cudaError_t err = allow_dynamic_smem(ssd_scan_mma_kernel<R>, done);
  if (err != cudaSuccess) return (int)err;
  return kernel_info(ssd_scan_mma_kernel<R>, kMmaThreads,
                     ScanLayout(R, n, s > kQ ? 2 : 1).total, info);
}

}  // namespace

extern "C" {

// state (B, H, P, N) f32, advanced in place where active (B,) int32 is
// non-zero (all rows when active is null); x (B, H, P); dt (B, H) f32;
// A (H,) f32; Bm/Cm (B, N) -> y (B, H, P).
// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm, y). N % 4 == 0.
int ssd_decode(float* state, const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, const int* active, void* y,
               int b, int h, int p, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 4 != 0) return -2;
  if (dtype == 0)
    return launch_decode<float>(state, x, dt, A, Bm, Cm, active, y, b, h, p,
                                n, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(state, x, dt, A, Bm, Cm, active, y, b,
                                        h, p, n, s);
  return -1;
}

// x (B, S, H, P); dt (B, S, H) f32; A (H,) f32; Bm/Cm (B, S, N); init
// (B, H, P, N) f32 or null -> y (B, S, H, P), final_state (B, H, P, N) f32.
// dtype as above. rows: 0 runs the CUDA-core template (N <= 256); 16, 32
// or 64 the tensor-core kernel with that many P rows a block (bf16 only,
// P a multiple of rows, N a multiple of 16 in [16, 256], rows x N <= 8192,
// every pointer 16-byte aligned). The caller chooses by shape
// (kernels/ssd_scan.py::scan_rows); a shape the choice does not take
// returns -2, a misaligned pointer -3.
int ssd_scan_chunked(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* init,
                     void* y, float* final_state, int b, int s, int h, int p,
                     int n, int dtype, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    if (n > 256) return -2;
    if (dtype == 0)
      return launch_scan<float>(x, dt, A, Bm, Cm, init, y, final_state, b, s,
                                h, p, n, st);
    if (dtype == 1)
      return launch_scan<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y,
                                        final_state, b, s, h, p, n, st);
    return -1;
  }
  if (dtype != 1 || !mma_shape_ok(rows, p, n)) return -2;
  if (!mma::aligned16(x, Bm, Cm, y) ||
      !mma::aligned16(final_state, init != nullptr ? init : final_state,
                      final_state, final_state))
    return -3;
#define MMA_ROWS(R)                                                          \
  if (rows == R)                                                             \
  return launch_scan_mma<R>(x, dt, A, Bm, Cm, init, y, final_state, b, s, h, \
                            p, n, st)
  MMA_ROWS(16);
  MMA_ROWS(32);
  MMA_ROWS(64);
#undef MMA_ROWS
  return -2;
}

// The scan kernel a call with dtype, rows (as ssd_scan_chunked's), S and N
// runs, as the card runs it: info[0] registers a thread, [1] local
// (spilled) bytes a thread, [2] dynamic shared memory bytes a block, [3]
// blocks resident per SM. Returns 0, a CUDA error, or -2 for a shape the
// kernel does not take.
int ssd_scan_info(int dtype, int rows, int s, int n, int* info) {
  if (rows == 0) {
    if (n > 256) return -2;
    if (dtype == 0) return scan_info<float>(n, info);
    if (dtype == 1) return scan_info<__nv_bfloat16>(n, info);
    return -1;
  }
  if (dtype != 1 || !mma_shape_ok(rows, rows, n)) return -2;
  if (rows == 16) return scan_mma_info<16>(s, n, info);
  if (rows == 32) return scan_mma_info<32>(s, n, info);
  if (rows == 64) return scan_mma_info<64>(s, n, info);
  return -2;
}

}  // extern "C"
