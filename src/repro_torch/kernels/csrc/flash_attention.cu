// Hopper (sm_90a) forward attention with GQA, causal and sliding-window
// masks and tanh soft-capping, bound from Python with ctypes
// (repro_torch/kernels/flash_attention.py).  Plain C launcher: returns
// the cudaError_t of its launch.
//
// flash_attention -- replaces the Pallas kernel `flash_attention`
//   (src/repro/kernels/flash_attention.py: `_kernel`, pl.pallas_call at
//   :116).  q [B*Hq, Sq, d], k/v [B*Hkv, Skv, d] (f32 or bf16) -> o like
//   q; flattened q row bh reads kv row bh / (Hq / Hkv), as the
//   reference's BlockSpecs do.
//   What bounds it here: operations.  The function does 4 d flops per
//   unmasked (query, key) pair (QK^T and PV); at qwen2-7b's widths
//   (S = 4096, d = 128, causal) that is ~1.2e11 flops against ~0.1 GB of
//   q, k, v and o, so even the tensor cores' bf16 rate bounds it far
//   above HBM.  This first kernel runs scalar f32 FMAs out of shared
//   memory (no wgmma, no TMA), so it sits well above that bound: the
//   later redesign moves both products onto wgmma.
//   Design: one block of 8 warps per (bh, 64-row query tile); the q tile
//   is held in shared memory as f32; k/v tiles of 32 rows are staged as
//   f32 (k rows padded by one word against bank conflicts).  Each warp
//   owns 8 query rows and each lane one key of the tile, so a row's max
//   and sum are warp shuffles; the online softmax follows the reference
//   step for step in f32: scores times scale, tanh(s / cap) * cap,
//   masked scores set to NEG_INF = -2^30 (keys past Skv to -inf, so they
//   weigh 0), m_new = max(m, rowmax), p = exp(s - m_new), alpha =
//   exp(m - m_new), l = l * alpha + sum p, p rounded to v's type before
//   PV, acc = acc * alpha + PV, and o = acc / max(l, 1e-30) in q's type.
//   Tiles that are fully masked (above the diagonal, or before the
//   window) are skipped, as `pl.when(needed)` skips them.  Precise expf /
//   tanhf and IEEE division; products accumulate with explicit fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;               // query rows per block
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr int kBK = 32;               // keys per tile: one per lane
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * D + kBK * (D + 1) + kBK * D + kBQ * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int g, int sq,
             int skv, int causal, int window, float scale, float cap) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][D]
  float* ks = qs + kBQ * D;              // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);        // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kBK]
  constexpr int kCols = (D + 31) / 32;   // output columns per lane

  const int bh = blockIdx.y;
  const int q_lo = blockIdx.x * kBQ;
  const int q_hi = min(q_lo + kBQ, sq) - 1;
  const T* q_rows = q + (static_cast<size_t>(bh) * sq + q_lo) * D;
  const size_t kv_off = static_cast<size_t>(bh / g) * skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRows;

  for (int e = threadIdx.x; e < kBQ * D; e += kThreads)
    qs[e] = q_lo + e / D < sq ? to_f32(q_rows[e]) : 0.0f;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[r][t] = 0.0f;
  }

  for (int k_lo = 0; k_lo < skv; k_lo += kBK) {
    if (causal && k_lo > q_hi) break;
    if (window && k_lo + kBK - 1 <= q_lo - window) continue;
    __syncthreads();   // the previous tile's k/v are consumed
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int j = e / D, c = e % D;
      const bool in = k_lo + j < skv;
      const size_t at = kv_off + static_cast<size_t>(k_lo) * D + e;
      ks[j * (D + 1) + c] = in ? to_f32(k[at]) : 0.0f;
      vs[e] = in ? to_f32(v[at]) : 0.0f;
    }
    __syncthreads();

    // s = q . k for this warp's rows, lane = key
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* krow = ks + lane * (D + 1);
    for (int c = 0; c < D; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[r] = fmaf(qs[(row0 + r) * D + c], kc, s[r]);
    }

    const int kpos = k_lo + lane;
    float alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_lo + row0 + r;
      float x = __fmul_rn(s[r], scale);
      if (cap > 0.0f) x = __fmul_rn(tanhf(__fdiv_rn(x, cap)), cap);
      bool unmasked = true;
      if (causal) unmasked = unmasked && kpos <= qpos;
      if (window) unmasked = unmasked && kpos > qpos - window;
      x = kpos >= skv ? -INFINITY : (unmasked ? x : kNegInf);
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(__fsub_rn(x, m_new));
      alpha[r] = expf(__fsub_rn(m[r], m_new));
      l[r] = fmaf(l[r], alpha[r], warp_sum(p));
      m[r] = m_new;
      ps[(row0 + r) * kBK + lane] = to_f32(from_f32<T>(p));   // p in v's type
    }
    __syncwarp();

    // acc = acc * alpha + p @ v, lane = output column
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      if (c >= D) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* prow = ps + (row0 + r) * kBK;
        float pv = 0.0f;
        for (int j = 0; j < kBK; ++j) pv = fmaf(prow[j], vs[j * D + c], pv);
        acc[r][t] = fmaf(acc[r][t], alpha[r], pv);
      }
    }
  }

  T* o_rows = out + (static_cast<size_t>(bh) * sq + q_lo) * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q_lo + row0 + r >= sq) continue;
    const float inv = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      if (c < D)
        o_rows[(row0 + r) * D + c] = from_f32<T>(__fdiv_rn(acc[r][t], inv));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int g, int sq, int skv, int causal, int window, float scale,
           float cap, cudaStream_t stream) {
  static size_t allowed = repro_torch::kDefaultSmem;
  const size_t smem = smem_floats<D>() * sizeof(float);
  const cudaError_t err =
      repro_torch::allow_smem(flash_kernel<T, D>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), g, sq, skv, causal,
      window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int g, int sq, int skv, int d, int causal, int window,
             float scale, float cap, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, bh, g, sq, skv, causal, window,
                           scale, cap, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, bh, g, sq, skv, causal, window,
                           scale, cap, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, bh, g, sq, skv, causal, window,
                           scale, cap, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, bh, g, sq, skv, causal, window,
                            scale, cap, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, bh, g, sq, skv, causal, window,
                            scale, cap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bh = B * Hq flattened query rows, g = Hq / Hkv; bf16 != 0 selects
// bfloat16 tensors, else float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int g, int sq, int skv, int d,
                                      int causal, int window, int bf16,
                                      float scale, float cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, bh, g, sq, skv, d, causal,
                                   window, scale, cap, s);
  return launch_d<float>(q, k, v, out, bh, g, sq, skv, d, causal, window,
                         scale, cap, s);
}
