// Hopper (sm_90a) kernels for the GridSim superstep engine, bound from
// Python with ctypes (repro_torch/kernels/event_scan.py).  Plain C
// launchers: each returns the cudaError_t of its launch.
//
// event_scan -- replaces the Pallas kernel `event_scan`
//   (src/repro/kernels/event_scan.py: `_kernel`, pl.pallas_call at :353)
//   and the injected-rank form the reference routes to `event_scan_xla`
//   (event_scan.py:384).  Per row of the [R, J] job-slot table: masks,
//   the (remaining, tie) rank, the Fig 8 MaxShare/MinShare rate split,
//   t = rem / rate, the row minimum, the FIFO-tie argmin, the occupancy.
//   What bounds it here: launch latency.  At the engine's shapes
//   ([16, 32] .. [16, 2000]) it moves 4-16 bytes per slot (82 KB read and
//   82 KB written at [16, 640]), microseconds of HBM time, far below the
//   cost of one launch; the fresh rank adds O(J^2) compares per row out
//   of shared memory.  Design: one block per row, so no cross-block
//   reduction is needed; the row's keys, tie keys and forecasts live in
//   shared memory (12 bytes per slot, 24 KB at J = 2000); the rank is the
//   pairwise count of lexicographically smaller (key, tie, column)
//   triples, each thread holding 8 of its slots in registers while the
//   block streams the row once per 8 slots.  That is the exact inverse of
//   the stable lexsort permutation, so the rank output matches the plain
//   version bitwise on every slot.  None of the TPU layout survives: no
//   128-lane padding, no pairwise/bitonic switch, no [8, J, J] cube.
//
// event_frontier -- replaces the Pallas kernel `event_frontier`
//   (event_scan.py: `_frontier_kernel`, pl.pallas_call at :1009).  One
//   block: pass 1 takes each source segment's minimum candidate and
//   minimum horizon-cutting candidate, the running minimum of those is
//   t*, pass 2 counts each segment's candidates due at t*.  Bound: launch
//   latency (a few KB of candidates).  Design: segments are walked in
//   order with block-wide reductions, segment offsets come in as an
//   int32 array instead of the TPU's [S, C] membership matrix.
//
// Every quotient and product uses the _rn intrinsics: IEEE f32, never
// contracted, matching the reference's `mips / max(divisor, 1)` and
// `rem / max(rate, 1e-30)`.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kScanThreads = 256;
constexpr int kPerThread = 8;       // rank slots held in registers
constexpr int kFrontierThreads = 256;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; every thread gets the result.  `red` is a
// 32-entry shared scratch; the trailing barrier lets the caller reuse it.
__device__ float block_min(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : INFINITY;
    w = warp_min(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? red[lane] : 0x7fffffff;
    w = warp_min(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const int out = red[0];
  __syncthreads();
  return out;
}

__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? red[lane] : 0;
    w = warp_sum(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const int out = red[0];
  __syncthreads();
  return out;
}

// One block per resource row.  rank_in == nullptr: fresh rank (written
// to rank_out when that is non-null); otherwise the injected rank.
__global__ void __launch_bounds__(kScanThreads)
event_scan_kernel(const float* __restrict__ rem, const float* __restrict__ tie,
                  const float* __restrict__ mips, const float* __restrict__ npe,
                  const float* __restrict__ pol, const float* __restrict__ blk,
                  const float* __restrict__ ok,
                  const float* __restrict__ rank_in,
                  float* __restrict__ rate_out, float* __restrict__ tmin_out,
                  int* __restrict__ amin_out, int* __restrict__ occ_out,
                  float* __restrict__ rank_out, int J) {
  extern __shared__ float smem[];
  float* key = smem;            // remaining, BIG where the slot is invalid
  float* tkey = smem + J;       // tie key, BIG where invalid
  float* tt = smem + 2 * J;     // completion forecast t
  __shared__ float redf[32];
  __shared__ int redi[32];

  const int r = blockIdx.x;
  const size_t row = static_cast<size_t>(r) * J;

  // _row_masks
  const float npe_e = fmaxf(__fsub_rn(npe[r], blk[r]), 0.0f);
  const float pol_r = pol[r];
  const bool dead = (ok[r] < 0.5f) || ((pol_r < 0.5f) && (npe_e < 0.5f));
  int n_valid = 0;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const float x = rem[row + j];
    const bool valid = (x > 0.0f) && (x < kBig) && !dead;
    key[j] = valid ? x : kBig;
    tkey[j] = valid ? tie[row + j] : kBig;
    n_valid += valid ? 1 : 0;
  }
  const int occ = block_sum(n_valid, redi);   // barrier: key/tkey visible
  const float g = static_cast<float>(occ);

  // _fig8_rates, row constants
  const float m = fmaxf(npe_e, 1.0f);
  const float k = floorf(__fdiv_rn(g, m));
  const float extra = __fsub_rn(g, __fmul_rn(k, m));
  const float msc = __fmul_rn(__fsub_rn(npe_e, extra), k);
  const bool whole_pe = (g <= npe_e) || (pol_r > 0.5f);
  const float mips_r = mips[r];

  float tmin_local = kBig;
  for (int base = 0; base < J; base += kPerThread * blockDim.x) {
    float rk[kPerThread];
    if (rank_in == nullptr) {
      float mk[kPerThread], mt[kPerThread];
      int cnt[kPerThread];
#pragma unroll
      for (int s = 0; s < kPerThread; ++s) {
        const int j = base + s * blockDim.x + threadIdx.x;
        mk[s] = j < J ? key[j] : kBig;
        mt[s] = j < J ? tkey[j] : kBig;
        cnt[s] = 0;
      }
      // #{q : (key_q, tie_q, q) < (key_j, tie_j, j)}: the lexsort rank
      for (int q = 0; q < J; ++q) {
        const float kq = key[q], tq = tkey[q];
#pragma unroll
        for (int s = 0; s < kPerThread; ++s) {
          const int j = base + s * blockDim.x + threadIdx.x;
          const bool before =
              (kq < mk[s]) ||
              (kq == mk[s] && (tq < mt[s] || (tq == mt[s] && q < j)));
          cnt[s] += before ? 1 : 0;
        }
      }
#pragma unroll
      for (int s = 0; s < kPerThread; ++s) rk[s] = static_cast<float>(cnt[s]);
    } else {
#pragma unroll
      for (int s = 0; s < kPerThread; ++s) {
        const int j = base + s * blockDim.x + threadIdx.x;
        rk[s] = j < J ? rank_in[row + j] : 0.0f;
      }
    }
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const int j = base + s * blockDim.x + threadIdx.x;
      if (j >= J) continue;
      const float kj = key[j];
      const bool valid = kj < kBig;
      const float divisor =
          whole_pe ? 1.0f : __fadd_rn(k, rk[s] >= msc ? 1.0f : 0.0f);
      const float rate = valid ? __fdiv_rn(mips_r, fmaxf(divisor, 1.0f)) : 0.0f;
      const float t = valid ? __fdiv_rn(kj, fmaxf(rate, 1e-30f)) : kBig;
      rate_out[row + j] = rate;
      tt[j] = t;
      tmin_local = fminf(tmin_local, t);
      if (rank_out != nullptr) rank_out[row + j] = rk[s];
    }
  }
  const float tmin = block_min(tmin_local, redf);   // barrier: tt visible

  // argmin: earliest forecast, FIFO ties by the tie key, then the column
  float cand_local = kBig;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const bool at_min = (tt[j] <= tmin) && (key[j] < kBig);
    cand_local = fminf(cand_local, at_min ? tkey[j] : kBig);
  }
  const float tie_min = block_min(cand_local, redf);
  int col_local = J;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const bool at_min = (tt[j] <= tmin) && (key[j] < kBig);
    const float cand = at_min ? tkey[j] : kBig;
    if (at_min && cand <= tie_min) col_local = min(col_local, j);
  }
  const int amin = block_min(col_local, redi);
  if (threadIdx.x == 0) {
    tmin_out[r] = tmin;
    amin_out[r] = amin;
    occ_out[r] = occ;
  }
}

__global__ void __launch_bounds__(kFrontierThreads)
event_frontier_kernel(const float* __restrict__ cand,
                      const float* __restrict__ cuts,
                      const int* __restrict__ off, int S,
                      float* __restrict__ mins, int* __restrict__ counts,
                      float* __restrict__ safe) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  float t_star = INFINITY;
  for (int s = 0; s < S; ++s) {
    float mn = INFINITY, sf = INFINITY;
    for (int i = off[s] + threadIdx.x; i < off[s + 1]; i += blockDim.x) {
      const float c = cand[i];
      mn = fminf(mn, c);
      if (cuts == nullptr || cuts[i] > 0.5f) sf = fminf(sf, c);
    }
    mn = block_min(mn, redf);
    sf = block_min(sf, redf);
    if (threadIdx.x == 0) {
      mins[s] = mn;
      safe[s] = sf;
    }
    t_star = fminf(t_star, mn);
  }
  for (int s = 0; s < S; ++s) {
    int due = 0;
    for (int i = off[s] + threadIdx.x; i < off[s + 1]; i += blockDim.x) {
      const float c = cand[i];
      due += (c <= t_star && c < INFINITY) ? 1 : 0;
    }
    due = block_sum(due, redi);
    if (threadIdx.x == 0) counts[s] = due;
  }
}

}  // namespace

extern "C" int event_scan_launch(const float* rem, const float* tie,
                                 const float* mips, const float* npe,
                                 const float* pol, const float* blk,
                                 const float* ok, const float* rank_in,
                                 float* rate, float* tmin, int* amin,
                                 int* occ, float* rank_out, int R, int J,
                                 void* stream) {
  // The dynamic shared-memory limit is raised once, to the largest row
  // seen so far (one card per process).
  static int max_smem = -1;
  static size_t allowed = 48 * 1024 - 2 * 32 * sizeof(float);
  const size_t smem = static_cast<size_t>(3) * J * sizeof(float);
  if (smem > allowed) {
    cudaError_t err;
    if (max_smem < 0) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (smem + 2 * 32 * sizeof(float) > static_cast<size_t>(max_smem))
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(event_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  event_scan_kernel<<<R, kScanThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      rem, tie, mips, npe, pol, blk, ok, rank_in, rate, tmin, amin, occ,
      rank_out, J);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int event_frontier_launch(const float* cand, const float* cuts,
                                     const int* off, int S, float* mins,
                                     int* counts, float* safe,
                                     void* stream) {
  event_frontier_kernel<<<1, kFrontierThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cand, cuts, off, S, mins, counts, safe);
  return static_cast<int>(cudaGetLastError());
}
