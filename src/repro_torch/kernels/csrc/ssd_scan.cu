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
// sequence's chunks itself. The rows of the (P, N) state evolve
// independently given B, C and dt, so a block owns 16 rows of one (b, h):
// grid (ceil(P/16), H, B), 256 blocks for one 64-token chunk of
// mamba2-1.3b (H 64, P 64) on 132 SMs.
//
// The chunk length inside the kernel is fixed at Q = 64 whatever the
// caller's chunk: a 256 x 256 f32 decay tile would not fit in 227 KB of
// shared memory, and the result does not depend on the chunk length up to
// f32 rounding (tests/test_kernels.py::test_ssd_chunk_invariance). A
// ragged last sub-chunk is padded inside the kernel with dt = 0, x = B =
// C = 0 rows: exact identities on the recurrence, never written out. Per
// sub-chunk the block stages B and C (Q x N), dt and x*dt, takes the
// cumulative sum of dt*a with a warp scan, then computes
//   scores = (C B^T) o L,  L[i][j] = e^{cs_i - cs_j} for j <= i, else 0
//   y      = scores (x dt) + e^{cs} (C state^T)
//   state  = e^{cs_last} state + sum_j e^{cs_last - cs_j} (x dt)_j B_j^T
// on CUDA cores in f32 with register tiles (4 x 4 for the scores, 4 rows
// for y, 4 state rows per B column for the update) over shared-memory
// operands whose rows are padded to N + 1 to avoid bank conflicts. The
// state starts from init (or zero) and is written once at the end.
//
// Bound on the H100: bytes at the engine's shape. One 64-token chunk of one
// sequence reads x (0.5 MB bf16), B/C/dt and the 2.1 MB f32 entering state
// and writes y and the 2.1 MB final state: ~5.3 MB, ~1.6 us at 3.35 TB/s;
// its ~0.3 GFLOP are ~0.3 us at the tensor-core rate. This first version
// runs its products on CUDA cores and recomputes C B^T in each of the
// 4 P-slices x 64 heads; tensor cores (wgmma over the Q x N tiles) and a
// shared C B^T are the next steps.
//
// Every launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or a negative code for an unsupported dtype or
// width, which the Python wrapper rules out before calling).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  const size_t smem = scan_smem_floats(n) * sizeof(float);
  // above 48 KB dynamic shared memory must be opted into; the opt-in is
  // per device, so it is made on every launch (it is a cheap host call)
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p + kPB - 1) / kPB, h, b);
  ssd_scan_kernel<T><<<grid, kScanThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, static_cast<T*>(y), fs, s, h, p, n);
  return (int)cudaGetLastError();
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
// dtype as above. N <= 256 (shared memory).
int ssd_scan_chunked(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* init,
                     void* y, float* final_state, int b, int s, int h, int p,
                     int n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 256) return -2;
  if (dtype == 0)
    return launch_scan<float>(x, dt, A, Bm, Cm, init, y, final_state, b, s, h,
                              p, n, st);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, final_state,
                                      b, s, h, p, n, st);
  return -1;
}

}  // extern "C"
