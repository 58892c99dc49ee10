// Hopper (sm_90a) Mamba-2 SSD chunk scan, bound from Python with ctypes
// (repro_torch/kernels/ssd_scan.py).  Plain C launcher: returns the
// cudaError_t of its launches.
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
//   2 P N) flops per step and head (C B^T, shared by the heads; the
//   causal half of the intra-chunk product; C . state; the state update):
//   ~1.0e10 flops at mamba2-130m's widths (B 2, S 4096, H 24, P 64,
//   N 128, Q 256) against ~60 MB of inputs and outputs in bf16.  In bf16
//   the bound is the bytes (~0.018 ms); in f32 it is the products at
//   f32 accuracy, which the tensor cores give as three TF32 products
//   each: 3 x 1.0e10 at 495 TFLOP/s, ~0.06 ms.
//
// Design: the passes of Mamba-2's own GPU implementation (arXiv:2405.21060
// sections 6-7), so that the chunks run in parallel and only a cheap
// elementwise pass is sequential over them.
//   1. ssd_states_kernel, one block per (chunk, group of heads, batch
//      row): the chunk's running sum of dt * a per head, sequential on one
//      thread per head while the first tile's copies land (Q dependent
//      adds; a warp scan would be quicker but rounds cum_q -
//      cum_k of nearby keys, the terms that dominate y, independently,
//      and reads further from the plain version), written to `cum`
//      [B, nc, Q, H]; then each head's
//      state increment s_c = sum_k (exp(cum_end - cum_k) dt_k x_k) B_k^T
//      [P, N] to `states` [B, nc, H, P, N] (f32 scratch).  B is staged
//      once for the group; a warp owns 64 x 32 of one head's [P, N] and
//      multiplies every tile of it, those past P or N too, so that no
//      branch sits among the products (two blocks an SM: <= 128
//      registers).
//   2. ssd_pass_kernel, one thread per (batch, head, p, n): walks the
//      chunks in order, state_in[c] = state_in[c-1] exp(cum_end[c-1]) +
//      s_c[c-1] (one fmaf), overwriting `states` in place.
//   3. ssd_output_kernel, one block per (64-row query tile, group of
//      kG3 = 8 heads, chunk, batch row): C B^T for the tile's rows and
//      keys once, kept in shared memory and reused by every head of the
//      group (n_groups = 1: C and B are the same for all heads, so a
//      head group shares it where splitting P would recompute it); then
//      per head y = W x + exp(cum_q) C . state_in, W = (C B^T) exp(cum_q -
//      cum_k) dt_k for k <= q.  Below the diagonal the 64-key tile's decay
//      factors as exp(cum_q - cum_m) exp(cum_m - cum_k) with m the tile's
//      last key (both <= 1, so neither overflows): two expf a row and one a
//      key instead of one an element; the diagonal tile takes expf per
//      element.  The head group: C B^T adds N / (G P) to the group's
//      intra-chunk products (25% at G = 8, mamba2-130m's widths, 50% at
//      G = 4), while a block holds an SM alone either way (~196 KB of
//      shared memory), so halving the blocks to 384 costs no latency
//      hiding; G = 8 also took less time than G = 4 on the card.
//   The blocks: at mamba2-130m's widths 384 (pass 1) and 384 (pass 3)
//   instead of the one block per (head, batch) = 48 of a kernel that walks
//   the chunks in order.  Longest query tiles start first.
//   Products: every matrix product on the tensor cores with
//   mma.sync.m16n8k8 TF32 (register fragments, so any staging layout:
//   rows padded so that the fragment loads hit 32 banks).  Each f32
//   operand v is split as big = cvt.rna.tf32(v), small = cvt.rna.tf32(v -
//   big) and a product is big.big + big.small + small.big, accumulated in
//   f32 (3xTF32: within ~1e-6 of f32; one TF32 pass fails the f32
//   tolerance).  bf16 x is exact in TF32, so W x needs two products.
//   Staging: 16-byte cp.async copies (zero fill past the chunk and in the
//   contraction's padding) in two-slot rings: pass 1's 32-key tiles of B
//   and x, pass 3's 64-key tiles of B (for C B^T) and of x (per head),
//   the next tile in flight while one multiplies.  Rows or bases that are
//   not 16-byte aligned are staged with plain loads instead.
//   Precise expf, explicit fmaf; nvcc runs with -fmad=false.
// Limits: Q <= 256 (the chunk; S % Q == 0), P <= 64, N <= 128 (the warp
//   tiles: pass 1 covers 64 of P, pass 3 two 32-column halves; pass 3's
//   ~196 KB of shared memory at the limits).  Anything beyond is refused
//   at launch with cudaErrorInvalidValue, and the wrapper raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"
#include "tf32.cuh"

namespace {

using repro_torch::mma;
using repro_torch::split;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 256, kMaxP = 64, kMaxN = 128;
constexpr int kKT1 = 32;   // keys a pass-1 tile
constexpr int kTQ = 64;    // query rows a pass-3 block, keys a pass-3 tile
constexpr int kG3 = 8;     // heads a pass-3 block
constexpr int kPass = 8;   // chunks a pass-2 thread loads at once

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

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

// Row length (elements) of an x tile in shared memory: the largest P
// (the warp tiles read all of it whatever P is: rows and columns past P
// only feed outputs that are never stored) plus a pad that puts the rows
// of a fragment load on distinct banks (8 words mod 32), in whole 16-byte
// chunks.
template <typename T>
__host__ __device__ constexpr int x_ld() {
  return kMaxP + 32 / static_cast<int>(sizeof(T));
}

// A warp's 16 rows times its four 8-column tiles at f32 accuracy:
// d[nt] += big.big, dx[nt] += small.big + big.small (the caller adds the
// two at the end).  Each round runs over the four tiles, so that no
// product waits on the one issued just before it.
__device__ __forceinline__ void mma3x4(float (&d)[4][4], float (&dx)[4][4],
                                       const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4],
                                       const uint32_t (&bb)[4][2],
                                       const uint32_t (&bs)[4][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) mma(dx[nt], as, bb[nt][0], bb[nt][1]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) mma(dx[nt], ab, bs[nt][0], bs[nt][1]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) mma(d[nt], ab, bb[nt][0], bb[nt][1]);
}

__device__ __forceinline__ void zero(float (&d)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[nt][i] = 0.0f;
}

// d += dx, elementwise
__device__ __forceinline__ void fold(float (&d)[4][4],
                                     const float (&dx)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[nt][i] = __fadd_rn(d[nt][i], dx[nt][i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, n_rows) of a row-major matrix whose row r is at src + r *
// stride and of which `valid` (>= 1) rows exist, into dst with `ld`
// elements a row: columns [0, cols) copied, [cols, width) and the missing
// rows zeroed.  16-byte cp.async copies when `vec` (src and stride on 16
// bytes, cols and width whole chunks), else plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      size_t stride, int n_rows, int valid,
                                      int cols, int width, bool vec) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    const int chunks = width / kE, full = cols / kE;
    for (int e = threadIdx.x; e < n_rows * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks;
      const bool in = r < valid && c < full;
      cp_async16(dst + r * ld + c * kE, in ? src + r * stride + c * kE : src,
                 in);
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * width; e += kThreads) {
      const int r = e / width, c = e % width;
      dst[r * ld + c] =
          r < valid && c < cols ? src[r * stride + c] : from_f32<T>(0.0f);
    }
  }
}

// ---- pass 1: running sums and chunk state increments ----------------------

template <typename T>
size_t states_smem_bytes(int P, int N, int Q, int g1) {
  const size_t ldb = round_up(N, 32) + 8;
  return (2 * kKT1 * ldb + 2 * static_cast<size_t>(round_up(Q, kKT1)) * g1) *
             sizeof(float) +
         2 * static_cast<size_t>(g1) * kKT1 * x_ld<T>() * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ bm,
                  float* __restrict__ states, float* __restrict__ cum_out,
                  int S, int H, int P, int N, int Q, int g1, bool x_vec,
                  bool b_vec) {
  extern __shared__ __align__(16) float smem[];
  const int nc = S / Q, n_groups = (H + g1 - 1) / g1;
  const int c = blockIdx.x % nc, hg = blockIdx.x / nc % n_groups,
            b = blockIdx.x / nc / n_groups;
  const int h0 = hg * g1, gn = min(g1, H - h0);
  const int ldb = round_up(N, 32) + 8, ldx = x_ld<T>();
  const int Qp = round_up(Q, kKT1), n_tiles = Qp / kKT1;
  float* bring = smem;                                   // [2][kKT1][ldb]
  float* cum = bring + 2 * kKT1 * ldb;                   // [g1][Qp]
  float* wk = cum + g1 * Qp;                             // [g1][Qp]
  T* xring = reinterpret_cast<T*>(wk + g1 * Qp);         // [2][g1][kKT1][ldx]
  const size_t seq0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  auto issue = [&](int i) {
    const int k0 = i * kKT1, valid = min(kKT1, Q - k0), slot = i & 1;
    stage(bring + slot * kKT1 * ldb, ldb, bm + (seq0 + k0) * N,
          static_cast<size_t>(N), kKT1, valid, N, N, b_vec);
    for (int g = 0; g < gn; ++g)
      stage(xring + (slot * g1 + g) * kKT1 * ldx, ldx,
            x + ((seq0 + k0) * H + h0 + g) * P, static_cast<size_t>(H) * P,
            kKT1, valid, P, P, x_vec);
    cp_async_commit();
  };
  issue(0);

  // the running sums: dt staged, then one thread per head, k in order
  for (int e = threadIdx.x; e < gn * Qp; e += kThreads) {
    const int g = e / Qp, k = e % Qp;
    wk[e] = k < Q ? dt[(seq0 + k) * H + h0 + g] : 0.0f;
  }
  __syncthreads();
  if (lane == 0 && warp < gn) {
    const int h = h0 + warp;
    const float a_h = a[h];
    float run = 0.0f;
    for (int k = 0; k < Qp; ++k) {
      if (k < Q) {
        run = __fadd_rn(run, __fmul_rn(wk[warp * Qp + k], a_h));
        cum_out[(seq0 + k) * H + h] = run;
      }
      cum[warp * Qp + k] = k < Q ? run : 0.0f;
    }
  }
  __syncthreads();
  // wk = exp(cum_end - cum_k) dt_k (0 past the chunk)
  for (int e = threadIdx.x; e < gn * Qp; e += kThreads) {
    const int g = e / Qp;
    if (e % Qp < Q)
      wk[e] = __fmul_rn(expf(__fsub_rn(cum[g * Qp + Q - 1], cum[e])), wk[e]);
  }

  // s_c[p][n] = sum_k (x_k[p] wk_k) B_k[n]: warp = (head g, 32 of N)
  const int wph = (N + 31) / 32, g = warp / wph, n0 = warp % wph * 32;
  const bool busy = g < gn;
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    if (i + 1 < n_tiles) issue(i + 1);
    if (!busy) continue;
    const float* bs = bring + (i & 1) * kKT1 * ldb;
    const T* xs = xring + ((i & 1) * g1 + g) * kKT1 * ldx;
    const float* w = wk + g * Qp + i * kKT1;
#pragma unroll
    for (int ks = 0; ks < kKT1 / 8; ++ks) {
      const int k_lo = ks * 8 + tig, k_hi = k_lo + 4;
      const float w_lo = w[k_lo], w_hi = w[k_hi];
      uint32_t bb[4][2], bsm[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + nt * 8 + gid;
        split(bs[k_lo * ldb + n], bb[nt][0], bsm[nt][0]);
        split(bs[k_hi * ldb + n], bb[nt][1], bsm[nt][1]);
      }
      // each 16 rows of P against the warp's 32 columns of N, all tiles
      // (those past P or N too: no branch among the products)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int p = mt * 16 + gid;
        uint32_t ab[4], as[4];
        split(__fmul_rn(to_f32(xs[k_lo * ldx + p]), w_lo), ab[0], as[0]);
        split(__fmul_rn(to_f32(xs[k_lo * ldx + p + 8]), w_lo), ab[1], as[1]);
        split(__fmul_rn(to_f32(xs[k_hi * ldx + p]), w_hi), ab[2], as[2]);
        split(__fmul_rn(to_f32(xs[k_hi * ldx + p + 8]), w_hi), ab[3], as[3]);
        // small.big, big.small, big.big, each round over the 4 tiles
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[mt][nt], as, bb[nt][0], bb[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[mt][nt], ab, bsm[nt][0], bsm[nt][1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[mt][nt], ab, bb[nt][0], bb[nt][1]);
      }
    }
  }

  if (!busy) return;
  float* out = states + ((static_cast<size_t>(b) * nc + c) * H + h0 + g) *
                            static_cast<size_t>(P) * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = mt * 16 + gid + (i >> 1) * 8, nn = n + (i & 1);
        if (p < P && nn < N) out[p * N + nn] = acc[mt][nt][i];
      }
    }
  }
}

// ---- pass 2: the states passed from chunk to chunk ------------------------

__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                int H, int PN, int Q, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t step = static_cast<size_t>(H) * PN;   // one chunk
  float* at = states + (static_cast<size_t>(b) * nc * H + h) * PN + e;
  const float* end = cum + (static_cast<size_t>(b) * nc * Q + Q - 1) * H + h;
  float run = 0.0f;
  // kPass chunks' loads in flight at once; the sum stays in chunk order
  for (int c0 = 0; c0 < nc; c0 += kPass) {
    float inc[kPass], gain[kPass];
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      if (c0 + i < nc) {
        inc[i] = at[(c0 + i) * step];
        gain[i] = expf(end[static_cast<size_t>(c0 + i) * Q * H]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      if (c0 + i < nc) {
        at[(c0 + i) * step] = run;
        run = fmaf(run, gain[i], inc[i]);
      }
    }
  }
}

// ---- pass 3: the output ---------------------------------------------------

template <typename T>
size_t output_smem_bytes(int P, int N, int Q) {
  const size_t ldc = round_up(N, 32) + 4, ldcb = round_up(Q, kTQ) + 4;
  const size_t ring_x = 2 * kTQ * x_ld<T>() * sizeof(T) / sizeof(float);
  const size_t region = kTQ * ldc + (kTQ * ldc > ring_x ? kTQ * ldc : ring_x);
  return (kTQ * ldc + kTQ * ldcb + region +
          3 * static_cast<size_t>(kG3) * round_up(Q, kTQ)) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ states,
                  const float* __restrict__ cum_in, T* __restrict__ y,
                  int S, int H, int P, int N, int Q, bool x_vec, bool bc_vec,
                  bool st_vec) {
  extern __shared__ __align__(16) float smem[];
  const int nc = S / Q, n_qt = (Q + kTQ - 1) / kTQ;
  const int n_groups = (H + kG3 - 1) / kG3;
  const int per_tile = gridDim.x / n_qt;
  // the longest query tiles (most keys) first
  const int t = n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = blockIdx.x % per_tile;
  const int hg = rest % n_groups, c = rest / n_groups % nc,
            b = rest / n_groups / nc;
  const int h0 = hg * kG3, gn = min(kG3, H - h0);
  const int q0 = t * kTQ, nq = min(kTQ, Q - q0), kt_end = q0 + nq;
  const int n_kt = t + 1;   // key tiles: t below the diagonal, then it
  const int Np = round_up(N, 8);
  const int ldc = round_up(N, 32) + 4, ldcb = round_up(Q, kTQ) + 4;
  const int ldx = x_ld<T>(), Qp = round_up(Q, kTQ);
  const int ring_x = 2 * kTQ * ldx * static_cast<int>(sizeof(T)) / 4;
  float* cs = smem;                        // [kTQ][ldc] the tile's C rows
  float* cb = cs + kTQ * ldc;              // [kTQ][ldcb] C B^T
  float* reg = cb + kTQ * ldcb;            // B ring, or state + x ring
  float* ss = reg;                         // [kTQ][ldc] state_in (p, n)
  T* xring = reinterpret_cast<T*>(reg + kTQ * ldc);   // [2][kTQ][ldx]
  float* cum = reg + kTQ * ldc + max(kTQ * ldc, ring_x);   // [kG3][Qp]
  float* dts = cum + kG3 * Qp;             // [kG3][Qp]
  float* colf = dts + kG3 * Qp;            // [kG3][Qp]
  const size_t seq0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wq = (warp & 3) * 16;    // the warp's 16 query rows of the tile
  const int wc = (warp >> 2) * 32;   // its 32 columns: keys of C B^T, p of y

  stage(cs, ldc, cm + (seq0 + q0) * N, static_cast<size_t>(N), kTQ, nq, N,
        Np, bc_vec);
  stage(reg, ldc, bm + seq0 * N, static_cast<size_t>(N), kTQ,
        min(kTQ, kt_end), N, Np, bc_vec);
  cp_async_commit();
  for (int e = threadIdx.x; e < gn * kt_end; e += kThreads) {
    const int g = e / kt_end, k = e % kt_end;
    const size_t at = (seq0 + k) * H + h0 + g;
    cum[g * Qp + k] = cum_in[at];
    dts[g * Qp + k] = dt[at];
  }
  __syncthreads();
  // exp(cum_m - cum_k) dt_k for the keys below the diagonal tile, m the
  // last key of k's tile
  for (int e = threadIdx.x; e < gn * q0; e += kThreads) {
    const int g = e / q0, k = e % q0, m = k / kTQ * kTQ + kTQ - 1;
    colf[g * Qp + k] = __fmul_rn(
        expf(__fsub_rn(cum[g * Qp + m], cum[g * Qp + k])), dts[g * Qp + k]);
  }

  // A fragment of the C rows (16 rows at wq, 8 n at n_lo - tig), split
  auto c_frag = [&](int n_lo, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    const float* r = cs + (wq + gid) * ldc + n_lo;
    split(r[0], ab[0], as[0]);
    split(r[8 * ldc], ab[1], as[1]);
    split(r[4], ab[2], as[2]);
    split(r[8 * ldc + 4], ab[3], as[3]);
  };

  // C B^T, one 64-key tile of B at a time through the ring
  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_kt) {
      const int k0 = (j + 1) * kTQ;
      stage(reg + ((j + 1) & 1) * kTQ * ldc, ldc, bm + (seq0 + k0) * N,
            static_cast<size_t>(N), kTQ, min(kTQ, kt_end - k0), N, Np,
            bc_vec);
      cp_async_commit();
    }
    const float* bs = reg + (j & 1) * kTQ * ldc;
    float d[4][4], dx[4][4];
    zero(d);
    zero(dx);
#pragma unroll 4
    for (int ks = 0; ks < Np / 8; ++ks) {
      const int n_lo = ks * 8 + tig;
      uint32_t ab[4], as[4], bb[4][2], bsm[4][2];
      c_frag(n_lo, ab, as);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* r = bs + (wc + nt * 8 + gid) * ldc + n_lo;
        split(r[0], bb[nt][0], bsm[nt][0]);
        split(r[4], bb[nt][1], bsm[nt][1]);
      }
      mma3x4(d, dx, ab, as, bb, bsm);
    }
    fold(d, dx);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* r = cb + (wq + gid) * ldcb + j * kTQ + wc + nt * 8 + 2 * tig;
      r[0] = d[nt][0];
      r[1] = d[nt][1];
      r[8 * ldcb] = d[nt][2];
      r[8 * ldcb + 1] = d[nt][3];
    }
  }
  __syncthreads();   // C B^T is complete and the B ring is free

  // per head: y = W x + exp(cum_q) C . state_in, one unit per (head, key
  // tile), x tiles (and each head's state) through the ring
  const int c_state = c;   // the chunk whose incoming state this block reads
  const int n_units = gn * n_kt;
  auto issue = [&](int u) {
    const int g = u / n_kt, j = u % n_kt, h = h0 + g;
    if (j == 0)
      stage(ss, ldc,
            states + ((static_cast<size_t>(b) * nc + c_state) * H + h) *
                         static_cast<size_t>(P) * N,
            static_cast<size_t>(N), P, P, N, Np, st_vec);
    stage(xring + (u & 1) * kTQ * ldx, ldx,
          x + ((seq0 + j * kTQ) * H + h) * P, static_cast<size_t>(H) * P,
          kTQ, min(kTQ, Q - j * kTQ), P, P, x_vec);
    cp_async_commit();
  };
  issue(0);
  const bool busy = wc < P;
  const int r0 = q0 + wq + gid, r1 = r0 + 8;   // the thread's query rows
  float acc_y[4][4], acc_yx[4][4], acc_i[4][4];
  for (int u = 0; u < n_units; ++u) {
    const int g = u / n_kt, j = u % n_kt;
    const float* cg = cum + g * Qp;
    cp_async_wait_all();
    __syncthreads();   // unit u landed; every warp is done with unit u - 1
    if (j == 0) {
      zero(acc_y);
      zero(acc_yx);
      zero(acc_i);
      if (busy) {
        float acc_ix[4][4];
        zero(acc_ix);
#pragma unroll 4
        for (int ks = 0; ks < Np / 8; ++ks) {
          const int n_lo = ks * 8 + tig;
          uint32_t ab[4], as[4], bb[4][2], bsm[4][2];
          c_frag(n_lo, ab, as);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float* r = ss + (wc + nt * 8 + gid) * ldc + n_lo;
            split(r[0], bb[nt][0], bsm[nt][0]);
            split(r[4], bb[nt][1], bsm[nt][1]);
          }
          mma3x4(acc_i, acc_ix, ab, as, bb, bsm);
        }
        fold(acc_i, acc_ix);
      }
      __syncthreads();   // the state buffer is free for the next head
    }
    if (u + 1 < n_units) issue(u + 1);
    if (busy) {
      const T* xs = xring + (u & 1) * kTQ * ldx;
      const bool diag = j == t;
      const float cq0 = cg[min(r0, Q - 1)], cq1 = cg[min(r1, Q - 1)];
      float f0 = 0.0f, f1 = 0.0f;
      if (!diag) {
        const float cm_ = cg[j * kTQ + kTQ - 1];
        f0 = expf(__fsub_rn(cq0, cm_));
        f1 = expf(__fsub_rn(cq1, cm_));
      }
      const float* cb0 = cb + (wq + gid) * ldcb;
      const float* cb1 = cb0 + 8 * ldcb;
#pragma unroll 4
      for (int ks = 0; ks < kTQ / 8; ++ks) {
        const int k_lo = j * kTQ + ks * 8 + tig, k_hi = k_lo + 4;
        float w[4];
        if (!diag) {
          const float fl = colf[g * Qp + k_lo], fh = colf[g * Qp + k_hi];
          w[0] = __fmul_rn(__fmul_rn(cb0[k_lo], f0), fl);
          w[1] = __fmul_rn(__fmul_rn(cb1[k_lo], f1), fl);
          w[2] = __fmul_rn(__fmul_rn(cb0[k_hi], f0), fh);
          w[3] = __fmul_rn(__fmul_rn(cb1[k_hi], f1), fh);
        } else {
          const int rr[4] = {r0, r1, r0, r1}, kk[4] = {k_lo, k_lo, k_hi, k_hi};
          const float cq[4] = {cq0, cq1, cq0, cq1};
          const float* cbr[4] = {cb0, cb1, cb0, cb1};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = kk[i] <= rr[i] && rr[i] < Q
                       ? __fmul_rn(__fmul_rn(cbr[i][kk[i]],
                                             expf(__fsub_rn(cq[i],
                                                            cg[kk[i]]))),
                                   dts[g * Qp + kk[i]])
                       : 0.0f;
        }
        uint32_t ab[4], as[4], bb[4][2], bsm[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(w[i], ab[i], as[i]);
        const int kx = ks * 8 + tig;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int p = wc + nt * 8 + gid;
          const float v0 = to_f32(xs[kx * ldx + p]);
          const float v1 = to_f32(xs[(kx + 4) * ldx + p]);
          if (sizeof(T) == 2) {
            bb[nt][0] = __float_as_uint(v0);
            bb[nt][1] = __float_as_uint(v1);
          } else {
            split(v0, bb[nt][0], bsm[nt][0]);
            split(v1, bb[nt][1], bsm[nt][1]);
          }
        }
        if (sizeof(T) == 2) {
          // bf16 x is exact in TF32: W_small x + W_big x
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma(acc_yx[nt], as, bb[nt][0], bb[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma(acc_y[nt], ab, bb[nt][0], bb[nt][1]);
        } else {
          mma3x4(acc_y, acc_yx, ab, as, bb, bsm);
        }
      }
    }
    if (j == n_kt - 1 && busy) {
      const int h = h0 + g;
      fold(acc_y, acc_yx);
      const float e0 = expf(cg[min(r0, Q - 1)]), e1 = expf(cg[min(r1, Q - 1)]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i < 2 ? r0 : r1;
          const int p = wc + nt * 8 + 2 * tig + (i & 1);
          if (r < kt_end && p < P)
            y[((seq0 + r) * H + h) * P + p] = from_f32<T>(__fadd_rn(
                acc_y[nt][i], __fmul_rn(acc_i[nt][i], i < 2 ? e0 : e1)));
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Blocks of the three passes (states, pass, output).
void grids(int B, int S, int H, int P, int N, int Q, int* out) {
  const int nc = S / Q, g1 = kWarps / ((N + 31) / 32);
  out[0] = nc * ((H + g1 - 1) / g1) * B;
  out[1] = (P * N + kThreads - 1) / kThreads * H * B;
  out[2] = (Q + kTQ - 1) / kTQ * ((H + kG3 - 1) / kG3) * nc * B;
}

bool within_limits(int S, int P, int N, int Q) {
  return Q >= 1 && Q <= kMaxQ && S % Q == 0 && P >= 1 && P <= kMaxP &&
         N >= 1 && N <= kMaxN;
}

template <typename T>
int launch(const void* x_, const float* dt, const float* a, const float* b,
           const float* c, void* y_, float* states, float* cum, int B, int S,
           int H, int P, int N, int Q, cudaStream_t stream) {
  static size_t allowed1 = repro_torch::kDefaultSmem;
  static size_t allowed3 = repro_torch::kDefaultSmem;
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  const int nc = S / Q, g1 = kWarps / ((N + 31) / 32);
  int blocks[3];
  grids(B, S, H, P, N, Q, blocks);
  const size_t smem1 = states_smem_bytes<T>(P, N, Q, g1);
  const size_t smem3 = output_smem_bytes<T>(P, N, Q);
  cudaError_t err =
      repro_torch::allow_smem(ssd_states_kernel<T>, smem1, &allowed1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro_torch::allow_smem(ssd_output_kernel<T>, smem3, &allowed3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool x_vec = aligned16(x) && P * sizeof(T) % 16 == 0;
  const bool bc_vec = aligned16(b) && aligned16(c) && N % 4 == 0;
  const bool st_vec = aligned16(states) && N % 4 == 0;
  ssd_states_kernel<T><<<blocks[0], kThreads, smem1, stream>>>(
      x, dt, a, b, states, cum, S, H, P, N, Q, g1, x_vec, bc_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<<<dim3((P * N + kThreads - 1) / kThreads, H, B), kThreads,
                    0, stream>>>(states, cum, H, P * N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<T><<<blocks[2], kThreads, smem3, stream>>>(
      x, dt, b, c, states, cum, y, S, H, P, N, Q, x_vec, bc_vec, st_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Q is the chunk (S % Q == 0); bf16 != 0 selects bfloat16 x and y, else
// float32.  `states` [B, S / Q, H, P, N] and `cum` [B, S, H] are f32
// scratch the caller allocates.  Three launches on `stream`.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* a, const float* b,
                               const float* c, void* y, float* states,
                               float* cum, int B, int S, int H, int P, int N,
                               int Q, int bf16, void* stream) {
  if (!within_limits(S, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, states, cum, B, S, H, P,
                                 N, Q, s);
  return launch<float>(x, dt, a, b, c, y, states, cum, B, S, H, P, N, Q, s);
}

// The blocks each pass launches at these widths, into out[3] (states,
// pass, output); cudaErrorInvalidValue beyond the limits.
extern "C" int ssd_scan_blocks(int B, int S, int H, int P, int N, int Q,
                               int* out) {
  if (!within_limits(S, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  grids(B, S, H, P, N, Q, out);
  return 0;
}
