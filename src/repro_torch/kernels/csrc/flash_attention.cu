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
//   Semantics, both kernels: scores times d^-1/2, tanh(s / cap) * cap
//   when there is a cap, masked scores set to NEG_INF = -2^30 (keys past
//   Skv to -inf, so they weigh 0), m_new = max(m, rowmax), p = exp(s -
//   m_new), alpha = exp(m - m_new), l = l * alpha + sum p, p rounded to
//   v's type before PV, acc = acc * alpha + PV, and o = acc / max(l,
//   1e-30) in q's type.  Tiles that are fully masked (above the diagonal,
//   or before the window) are skipped, as `pl.when(needed)` skips them.
//   What bounds it here: operations.  The function does 4 d flops per
//   unmasked (query, key) pair (QK^T and PV); at qwen2-7b's widths
//   (S = 4096, d = 128, causal) that is ~1.2e11 flops against ~0.1 GB of
//   q, k, v and o, so the tensor cores' 989 TFLOP/s (bf16) bound it far
//   above HBM.  The second limit is the softmax's transcendentals on the
//   special-function units: one exp2 per score, and with a cap one
//   precise tanhf (a dozen FP32 instructions) as well.
//
// bf16: flash_kernel_wgmma, both products on the tensor cores.
//   A block of two warpgroups (256 threads) owns 128 query rows, 64 per
//   warpgroup, and walks the key tiles: 128 keys a tile for d <= 128, 64
//   at d = 256 (so the [64, 256] f32 output accumulator, 128 registers a
//   thread, fits beside the scores without spilling).  Every warpgroup
//   is a consumer; all 256 threads stage tiles.
//   - S = Q K^T: wgmma m64n64k16, bf16 x bf16 -> f32, both operands from
//     shared memory, K-major (d contiguous), one instruction per 16 of d
//     and 64 keys.
//   - O += P V: wgmma m64n64k16 with A = P from registers (the f32
//     score fragment maps onto the bf16 A fragment, rounded to bf16 as
//     the reference rounds p to v's type) and B = V read MN-major from
//     shared memory through wgmma's transpose bit: no explicit transpose.
//   - Tiles stay bf16 in shared memory, in 64-column blocks of 128-byte
//     rows with the 128-byte swizzle wgmma reads (d < 64 pads the row to
//     64 columns; the padding is never read by QK^T, and the output
//     columns it feeds are not written).
//   - K/V go through a two-stage ring fed by 16-byte cp.async (zero fill
//     past Skv): tile j + 1 is in flight while tile j multiplies; one
//     __syncthreads a tile hands a stage back.
//   - The online softmax stays in registers: a thread holds two query
//     rows, a row's max and sum are two shuffles across its 4 lanes.
//     exp2f with log2 e folded into the scale (2 ulp, far inside bf16's
//     2^-8); tanhf stays precise.
//   - Blocks take query tiles in descending order across all heads, so
//     the longest causal tiles start first and the last wave is short.
//   Shared memory: 160 KB at d = 128 (q 32 KB, 2 stages x (k + v) of
//   32 KB), 192 KB at d = 256, 80 KB at d <= 64.
//
// f32: flash_kernel, scalar FMAs.  TF32 would break the reference's 2e-5
//   tolerance, and in full f32 this kernel already beats PyTorch's
//   scaled_dot_product_attention (6.46 against 12.07 ms at qwen2-7b).
//   One block of 8 warps per (bh, 64-row query tile); the q tile is held
//   in shared memory as f32; k/v tiles of 32 rows are staged as f32 (k
//   rows padded by one word against bank conflicts).  Each warp owns 8
//   query rows and each lane one key of the tile, so a row's max and sum
//   are warp shuffles; the online softmax follows the reference step for
//   step in f32.  Precise expf / tanhf and IEEE division; products
//   accumulate with explicit fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;               // query rows per block
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr int kBK = 32;               // keys per tile: one per lane
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int g,
             int sq, int skv, int causal, int window, float scale,
             float cap) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][D]
  float* ks = qs + kBQ * D;              // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);        // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kBK]
  constexpr int kCols = (D + 31) / 32;   // output columns per lane

  const int bh = blockIdx.y;
  const int q_lo = blockIdx.x * kBQ;
  const int q_hi = min(q_lo + kBQ, sq) - 1;
  const float* q_rows = q + (static_cast<size_t>(bh) * sq + q_lo) * D;
  const size_t kv_off = static_cast<size_t>(bh / g) * skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRows;

  for (int e = threadIdx.x; e < kBQ * D; e += kThreads)
    qs[e] = q_lo + e / D < sq ? q_rows[e] : 0.0f;

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
      ks[j * (D + 1) + c] = in ? k[at] : 0.0f;
      vs[e] = in ? v[at] : 0.0f;
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
      ps[(row0 + r) * kBK + lane] = p;
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

  float* o_rows = out + (static_cast<size_t>(bh) * sq + q_lo) * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q_lo + row0 + r >= sq) continue;
    const float inv = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      if (c < D)
        o_rows[(row0 + r) * D + c] = __fdiv_rn(acc[r][t], inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int g, int sq, int skv, int causal, int window, float scale,
           float cap, cudaStream_t stream) {
  static size_t allowed = repro_torch::kDefaultSmem;
  const size_t smem = smem_floats<D>() * sizeof(float);
  const cudaError_t err =
      repro_torch::allow_smem(flash_kernel<D>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), g, sq, skv,
      causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int g, int sq, int skv, int d, int causal, int window,
             float scale, float cap, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16>(q, k, v, out, bh, g, sq, skv, causal, window,
                        scale, cap, stream);
    case 32:
      return launch<32>(q, k, v, out, bh, g, sq, skv, causal, window,
                        scale, cap, stream);
    case 64:
      return launch<64>(q, k, v, out, bh, g, sq, skv, causal, window,
                        scale, cap, stream);
    case 128:
      return launch<128>(q, k, v, out, bh, g, sq, skv, causal, window,
                         scale, cap, stream);
    case 256:
      return launch<256>(q, k, v, out, bh, g, sq, skv, causal, window,
                         scale, cap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 tensor-core kernel.
namespace tc {

// kThreads (256) is two consumer warpgroups here; kNegInf is shared.
constexpr int kBQ = 128;             // query rows per block, 64 a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kBK = D > 128 ? 64 : 128;   // keys per k/v tile
  static constexpr int kW = D < 64 ? 64 : D;       // row width in shared memory
  static constexpr int kQ = kBQ * kW * 2;          // bytes of the q tile
  static constexpr int kKV = kBK * kW * 2;         // bytes of one k or v tile
  // q, then two stages of (k, v); 1 KB of slack to align the base
  static constexpr size_t kSmem = 1024 + kQ + 4 * kKV;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of `rows` rows, laid
// out as wgmma's 128-byte swizzle reads it: 64-column blocks of
// [rows][128 B], chunk c of row r at slot (c mod 8) xor (r mod 8).  Tile
// bases are 1024-byte aligned, so the slot is the one the hardware's
// address swizzle expects.
__device__ __forceinline__ uint32_t swizzled(int r, int c, int rows) {
  return static_cast<uint32_t>((c >> 3) * rows * 128 + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups 1024
// bytes apart (the stride byte offset); the leading byte offset is not
// read for these tiles (K-major, or MN-major 64 wide).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies have landed; then make them visible to wgmma's
// (async proxy) reads.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stages rows [0, ROWS) of a [*, D] bf16 matrix whose row 0 is at src
// and of which `valid` rows exist; missing rows are zero-filled (reading
// nothing, from `any`, a valid address).
template <int D, int ROWS>
__device__ __forceinline__ void stage(uint32_t dst, const __nv_bfloat16* src,
                                      int valid, const __nv_bfloat16* any) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "uneven staging");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r < valid;
    cp_async16(dst + swizzled(r, c, ROWS),
               in ? src + static_cast<size_t>(r) * D + c * 8 : any, in);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define REPRO_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared
// memory; acc = 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_ACC32
#undef REPRO_REGS32

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Fragment layout (wgmma m64nNk16, f32 accumulator): thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+8) and, in each
// 8-column group n, columns 8 n + 2 (t % 4) (+1): d[4 n + 2 i + e] is
// row +8i, column +e.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int bh_n, int g, int sq,
                   int skv, int causal, int window, float scale, float cap) {
  using T = Tile<D>;
  constexpr int BK = T::kBK;
  constexpr int NS = BK / 64;      // 64-key column groups of S
  constexpr int NO = T::kW / 64;   // 64-column groups of O
  constexpr int KD = D / 16;       // k-steps of QK^T
  constexpr int KB = BK / 16;      // k-steps of PV
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kvs = qs + T::kQ;   // stage s: k at + 2 s kKV, v after it

  const int nq = (sq + kBQ - 1) / kBQ;
  const int bh = static_cast<int>(blockIdx.x) % bh_n;
  const int q_lo = (nq - 1 - static_cast<int>(blockIdx.x) / bh_n) * kBQ;
  const int q_hi = min(q_lo + kBQ, sq) - 1;
  const __nv_bfloat16* qh = q + static_cast<size_t>(bh) * sq * D;
  const __nv_bfloat16* kh = k + static_cast<size_t>(bh / g) * skv * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(bh / g) * skv * D;

  const int wg = static_cast<int>(threadIdx.x) >> 7;
  const int warp = (static_cast<int>(threadIdx.x) >> 5) & 3;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int wq_lo = q_lo + 64 * wg, wq_hi = min(wq_lo + 63, sq - 1);
  const int row0 = wq_lo + 16 * warp + (lane >> 2);   // and row0 + 8
  const int col = 2 * (lane & 3);

  const int nk = (skv + BK - 1) / BK;
  const int kt_end = causal ? min(nk, q_hi / BK + 1) : nk;
  int kt_begin = 0;
  if (window && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / BK;

  stage<D, kBQ>(qs, qh + static_cast<size_t>(q_lo) * D, sq - q_lo, qh);
  if (kt_begin < kt_end) {
    const int lo = kt_begin * BK;
    stage<D, BK>(kvs, kh + static_cast<size_t>(lo) * D, skv - lo, kh);
    stage<D, BK>(kvs + T::kKV, vh + static_cast<size_t>(lo) * D, skv - lo,
                 vh);
  }
  cp_async_commit();

  float s[NS][32], o[NO][32];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) s[j][x] = 0.0f;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[j][x] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float scale2 = __fmul_rn(scale, kLog2e);
  const float inv_cap = cap > 0.0f ? __fdiv_rn(1.0f, cap) : 0.0f;
  const float cap2 = __fmul_rn(cap, kLog2e);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const uint32_t ks = kvs + ((kt - kt_begin) & 1) * 2 * T::kKV;
    const uint32_t vs = ks + T::kKV;
    cp_async_wait_all();
    __syncthreads();   // tile kt has landed; every thread is past tile kt-1
    if (kt + 1 < kt_end) {
      const uint32_t nxt = kvs + ((kt + 1 - kt_begin) & 1) * 2 * T::kKV;
      const int lo = (kt + 1) * BK;
      stage<D, BK>(nxt, kh + static_cast<size_t>(lo) * D, skv - lo, kh);
      stage<D, BK>(nxt + T::kKV, vh + static_cast<size_t>(lo) * D, skv - lo,
                   vh);
      cp_async_commit();
    }
    const int k_lo = kt * BK;
    // tiles this warpgroup's 64 rows do not need (uniform per warpgroup)
    if (wq_lo >= sq || (causal && k_lo > wq_hi) ||
        (window && k_lo + BK - 1 <= wq_lo - window))
      continue;

    // S = Q K^T
#pragma unroll
    for (int j = 0; j < NS; ++j) fence_regs(s[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t qa = qs + (kk >> 2) * kBQ * 128 + wg * 64 * 128 +
                          (kk & 3) * 32;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mma_ss(s[j], desc(qa),
               desc(ks + (kk >> 2) * BK * 128 + j * 64 * 128 + (kk & 3) * 32),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < NS; ++j) fence_regs(s[j]);

    // scores in log2 units: s d^-1/2 log2 e, or tanh(s d^-1/2 / cap) cap
    // log2 e
    if (cap > 0.0f) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int x = 0; x < 32; ++x)
          s[j][x] = __fmul_rn(
              tanhf(__fmul_rn(__fmul_rn(s[j][x], scale), inv_cap)), cap2);
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int x = 0; x < 32; ++x) s[j][x] = __fmul_rn(s[j][x], scale2);
    }
    if (k_lo + BK > skv || (causal && k_lo + BK - 1 > wq_lo) ||
        (window && k_lo <= wq_hi - window)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int kp = k_lo + 64 * j + 8 * (x >> 2) + col + (x & 1);
          const int qp = row0 + 8 * ((x >> 1) & 1);
          bool keep = true;
          if (causal) keep = keep && kp <= qp;
          if (window) keep = keep && kp > qp - window;
          s[j][x] = kp >= skv ? -INFINITY : (keep ? s[j][x] : kNegInf);
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x)
        mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[j][x]);
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f(__fsub_rn(m[i], mx[i]));
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        s[j][x] = exp2f(__fsub_rn(s[j][x], m[(x >> 1) & 1]));
        sum[(x >> 1) & 1] = __fadd_rn(sum[(x >> 1) & 1], s[j][x]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], quad_sum(sum[i]));

    // P (bf16, v's type) as the A fragment of PV: k-step kk covers keys
    // 16 kk .. 16 kk + 15, the 8-column groups 2 kk and 2 kk + 1 of S
    uint32_t p[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int c0 = 8 * (kk & 3);
      p[kk][0] = bf16_pair(s[kk >> 2][c0], s[kk >> 2][c0 + 1]);
      p[kk][1] = bf16_pair(s[kk >> 2][c0 + 2], s[kk >> 2][c0 + 3]);
      p[kk][2] = bf16_pair(s[kk >> 2][c0 + 4], s[kk >> 2][c0 + 5]);
      p[kk][3] = bf16_pair(s[kk >> 2][c0 + 6], s[kk >> 2][c0 + 7]);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int x = 0; x < 32; ++x)
        o[j][x] = __fmul_rn(o[j][x], alpha[(x >> 1) & 1]);

    // O += P V
#pragma unroll
    for (int j = 0; j < NO; ++j) fence_regs(o[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int j = 0; j < NO; ++j)
        mma_rs(o[j], p[kk], desc(vs + j * BK * 128 + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < NO; ++j) fence_regs(o[j]);
  }

  __nv_bfloat16* oh = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (64 * j + 8 * n >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(
            oh + static_cast<size_t>(qp) * D + 64 * j + 8 * n + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[j][4 * n + 2 * i], den),
                                  __fdiv_rn(o[j][4 * n + 2 * i + 1], den));
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int g, int sq, int skv, int causal, int window, float scale,
           float cap, cudaStream_t stream) {
  static size_t allowed = repro_torch::kDefaultSmem;
  const size_t smem = Tile<D>::kSmem;
  const cudaError_t err =
      repro_torch::allow_smem(flash_kernel_wgmma<D>, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((sq + kBQ - 1) / kBQ) * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel_wgmma<D><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      bh, g, sq, skv, causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int g, int sq, int skv, int d, int causal, int window,
             float scale, float cap, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16>(q, k, v, out, bh, g, sq, skv, causal, window, scale,
                        cap, stream);
    case 32:
      return launch<32>(q, k, v, out, bh, g, sq, skv, causal, window, scale,
                        cap, stream);
    case 64:
      return launch<64>(q, k, v, out, bh, g, sq, skv, causal, window, scale,
                        cap, stream);
    case 128:
      return launch<128>(q, k, v, out, bh, g, sq, skv, causal, window, scale,
                         cap, stream);
    case 256:
      return launch<256>(q, k, v, out, bh, g, sq, skv, causal, window, scale,
                         cap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// bh = B * Hq flattened query rows, g = Hq / Hkv; bf16 != 0 selects
// bfloat16 tensors (the tensor-core kernel), else float32 (the scalar
// kernel).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int g, int sq, int skv, int d,
                                      int causal, int window, int bf16,
                                      float scale, float cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::launch_d(q, k, v, out, bh, g, sq, skv, d, causal, window,
                        scale, cap, s);
  return launch_d(q, k, v, out, bh, g, sq, skv, d, causal, window, scale,
                  cap, s);
}
