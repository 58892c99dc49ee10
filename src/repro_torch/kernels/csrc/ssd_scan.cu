// Hopper (sm_90a) Mamba-2 SSD chunk scan, bound from Python with ctypes
// (repro_torch/kernels/ssd_scan.py).  Plain C launcher: returns the
// cudaError_t of its launch.
//
// ssd_scan -- replaces the Pallas kernel `ssd_scan`
//   (src/repro/kernels/ssd_scan.py: `_kernel`, pl.pallas_call at :104).
//   x [B, S, H, P] (f32 or bf16), dt [B, S, H], a [H], B/C [B, S, N]
//   (f32) -> y like x.  Per chunk of Q steps and head h, in f32:
//     cum   = running sum of dt * a over the chunk
//     y     = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//             + exp(cum_q) C_q . state
//     state = state exp(cum_end) + sum_k exp(cum_end - cum_k) dt_k x_k B_k^T
//   What bounds it here: the chunked form does ~2 (Q N / H + Q P / 2 +
//   2 P N) flops per step and head (C.B, shared by the heads; the causal
//   half of the intra-chunk product; C.state; the state update): ~1.0e10
//   flops at mamba2-130m's widths (B 2, S 4096, H 24, P 64, N 128,
//   Q 256) against ~60 MB of inputs and outputs in bf16, so the card's
//   bound is bytes in bf16 (~0.018 ms) and f32 operations in f32
//   (~0.15 ms at 67 TFLOP/s).  This first kernel runs scalar f32 FMAs
//   (no wgmma) from one block per (head, batch) -- 48 blocks at
//   mamba2-130m's widths, on 132 SMs -- so it sits far above either.
//   Design: the TPU carries the [P, N] state in VMEM across a sequential
//   grid axis; here one block per (head, batch) loops over the chunks in
//   order and keeps the state in shared memory in f32 (33 KB at P 64,
//   N 128, rows padded by one word).  The TPU's VMEM-resident chunk does
//   not fit (B and C chunks alone are 128 KB each at Q 256, N 128), so
//   the block holds the chunk's x [Q, P] in f32 and stages C in tiles of
//   16 query rows and B in tiles of 32 key rows: each query tile builds
//   its weights W [16, Q] = (C.B) exp(cum_q - cum_k) dt_k for k <= q, then
//   y; the state update streams B again, accumulating in a second [P, N]
//   buffer.  ~176 KB of shared memory at mamba2-130m's widths.  The
//   chunk's running sum is sequential (the reference takes it as a
//   lower-triangular matmul: the two differ in rounding only).  Precise
//   expf; products accumulate with explicit fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 16;   // query rows per C tile
constexpr int kKT = 32;   // key rows per B tile

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
  return __float2bfloat16_rn(x);
}

size_t smem_floats(int P, int N, int Q) {
  const size_t np = N + 1;
  return 2 * P * np + static_cast<size_t>(Q) * P +
         static_cast<size_t>(kTQ) * Q + (kTQ + kKT) * np + 3 * Q;
}

// rows [r0, r0 + n_rows) of a [*, N] f32 matrix into a padded tile,
// zeros past `limit`
__device__ void stage_rows(float* tile, const float* __restrict__ src,
                           int r0, int n_rows, int limit, int N) {
  for (int e = threadIdx.x; e < n_rows * N; e += blockDim.x) {
    const int i = e / N, n = e % N;
    tile[i * (N + 1) + n] =
        r0 + i < limit ? src[static_cast<size_t>(r0 + i) * N + n] : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, T* __restrict__ y, int S, int H,
           int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* state = smem;                   // [P][N + 1]
  float* sc = state + P * NP;            // [P][N + 1] state increment
  float* xs = sc + P * NP;               // [Q][P] the chunk's x in f32
  float* w = xs + Q * P;                 // [kTQ][Q]
  float* ct = w + kTQ * Q;               // [kTQ][N + 1]
  float* bt = ct + kTQ * NP;             // [kKT][N + 1]
  float* cum = bt + kKT * NP;            // [Q]
  float* dts = cum + Q;                  // [Q]
  float* wk = dts + Q;                   // [Q]

  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = a[h];
  const int PN = P * N;
  const float* b_seq = bm + static_cast<size_t>(b) * S * N;
  const float* c_seq = cm + static_cast<size_t>(b) * S * N;
  for (int e = threadIdx.x; e < PN; e += blockDim.x)
    state[(e / N) * NP + e % N] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();   // the previous chunk is done with every buffer
    for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
      const int k = e / P, p = e % P;
      xs[e] = to_f32(x[(static_cast<size_t>(b * S + c0 + k) * H + h) * P + p]);
    }
    for (int k = threadIdx.x; k < Q; k += blockDim.x)
      dts[k] = dt[static_cast<size_t>(b * S + c0 + k) * H + h];
    __syncthreads();
    if (threadIdx.x == 0) {
      float run = 0.0f;
      for (int k = 0; k < Q; ++k) {
        run = __fadd_rn(run, __fmul_rn(dts[k], a_h));
        cum[k] = run;
      }
    }
    __syncthreads();
    const float seg_end = cum[Q - 1];

    // y, one tile of kTQ query rows at a time
    for (int q0 = 0; q0 < Q; q0 += kTQ) {
      stage_rows(ct, c_seq, c0 + q0, kTQ, c0 + Q, N);
      const int k_end = min(q0 + kTQ, Q);
      for (int k0 = 0; k0 < k_end; k0 += kKT) {
        __syncthreads();   // bt is free; ct is staged
        stage_rows(bt, b_seq, c0 + k0, kKT, c0 + Q, N);
        __syncthreads();
        for (int e = threadIdx.x; e < kTQ * kKT; e += blockDim.x) {
          const int i = e / kKT, kk = e % kKT;
          const int q = q0 + i, k = k0 + kk;
          if (q >= Q || k >= Q) continue;
          float val = 0.0f;
          if (k <= q) {
            float cb = 0.0f;
            for (int n = 0; n < N; ++n)
              cb = fmaf(ct[i * NP + n], bt[kk * NP + n], cb);
            const float dec = expf(__fsub_rn(cum[q], cum[k]));
            val = __fmul_rn(__fmul_rn(cb, dec), dts[k]);
          }
          w[i * Q + k] = val;
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kTQ * P; e += blockDim.x) {
        const int i = e / P, p = e % P;
        const int q = q0 + i;
        if (q >= Q) continue;
        float y_in = 0.0f;
        for (int k = 0; k <= q; ++k) y_in = fmaf(w[i * Q + k], xs[k * P + p], y_in);
        float cs = 0.0f;
        for (int n = 0; n < N; ++n) cs = fmaf(ct[i * NP + n], state[p * NP + n], cs);
        const float yv = __fadd_rn(y_in, __fmul_rn(cs, expf(cum[q])));
        y[(static_cast<size_t>(b * S + c0 + q) * H + h) * P + p] = from_f32<T>(yv);
      }
      __syncthreads();   // ct and w are reused by the next tile
    }

    // state <- state * exp(seg_end) + sum_k (x_k * wk_k) B_k^T
    for (int k = threadIdx.x; k < Q; k += blockDim.x)
      wk[k] = __fmul_rn(expf(__fsub_rn(seg_end, cum[k])), dts[k]);
    for (int e = threadIdx.x; e < PN; e += blockDim.x)
      sc[(e / N) * NP + e % N] = 0.0f;
    for (int k0 = 0; k0 < Q; k0 += kKT) {
      __syncthreads();   // wk written; bt is free
      stage_rows(bt, b_seq, c0 + k0, kKT, c0 + Q, N);
      __syncthreads();
      const int kn = min(kKT, Q - k0);
      for (int e = threadIdx.x; e < PN; e += blockDim.x) {
        const int p = e / N, n = e % N;
        float acc = sc[p * NP + n];
        for (int kk = 0; kk < kn; ++kk) {
          const int k = k0 + kk;
          const float xw = __fmul_rn(xs[k * P + p], wk[k]);
          acc = fmaf(xw, bt[kk * NP + n], acc);
        }
        sc[p * NP + n] = acc;
      }
    }
    // each thread owns the same (p, n) entries of sc and state
    const float gain = expf(seg_end);
    for (int e = threadIdx.x; e < PN; e += blockDim.x) {
      const int at = (e / N) * NP + e % N;
      state[at] = fmaf(state[at], gain, sc[at]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const float* b,
           const float* c, void* y, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  static size_t allowed = repro_torch::kDefaultSmem;
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  const cudaError_t err =
      repro_torch::allow_smem(ssd_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, b, c, static_cast<T*>(y), S, H, P, N,
      Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Q is the chunk (S % Q == 0); bf16 != 0 selects bfloat16 x and y, else
// float32.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* a, const float* b,
                               const float* c, void* y, int B, int S, int H,
                               int P, int N, int Q, int bf16, void* stream) {
  if (Q < 1 || S % Q != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, dt, a, b, c, y, B, S, H, P, N, Q, s);
  return launch<float>(x, dt, a, b, c, y, B, S, H, P, N, Q, s);
}
