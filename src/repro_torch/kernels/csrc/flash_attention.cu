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
//   q, k, v and o (0.2 GB in f32), so the tensor cores bound it far above
//   HBM: 989 TFLOP/s in bf16 (~0.12 ms); in f32, the products at f32
//   accuracy as three TF32 products each, 3 x 1.2e11 at 495 TFLOP/s
//   (~0.73 ms, against ~1.8 ms for the same flops at 67 TFLOP/s on the
//   FP32 pipes).  The second limit is the softmax's transcendentals on
//   the special-function units: one exp per score, and with a cap one
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
// f32: flash_kernel_tf32, both products on the tensor cores as 3xTF32
//   (tf32.cuh): each f32 operand is split as big = cvt.rna.tf32(x), small
//   = cvt.rna.tf32(x - big), and a product is small.big + big.small +
//   big.big on mma.sync.m16n8k8 (f32 accumulate).  One product errs by
//   ~2^-21 relative, so scores and outputs stay ~1e-6 from f32, an order
//   of magnitude inside the reference's 2e-5 (one TF32 product, ~2^-11,
//   would not be).
//   - A block of 8 warps owns 128 query rows (4 warps and 64 rows at
//     d = 256), a warp 16; key tiles of 64 keys (32 at d >= 128), so the
//     [16, d] output accumulator, d / 2 registers a thread, fits beside
//     the scores without spilling.
//   - S = Q K^T: A = q and B = k fragments read from shared memory.  The
//     order of the contraction index inside each 16 columns is permuted
//     (k-step 2 kp + h, slot t and t + 4 <-> column 16 kp + 4 t + 2 h and
//     + 1), so a lane reads the four floats of two k-steps with one
//     16-byte load.  The small terms accumulate apart from big.big and
//     are added once a tile.
//   - P V: the key order inside each 8-key k-step is permuted the same
//     way (slot t <-> key 2 t, slot t + 4 <-> key 2 t + 1), so the S
//     accumulator (d0..d3: row g keys 2t, 2t+1, row g+8 the same) is the
//     A fragment as (d0, d2, d1, d3), no value moving between lanes.  The
//     B fragment reads v by rows 2t and 2t + 1; the output columns of a
//     block of four 8-column tiles interleave (tile u, fragment column n
//     <-> column 4 n + u), so one 16-byte load per row feeds four tiles.
//     Each tile's P V is accumulated apart (pv) and folded as acc = acc
//     alpha + pv with one fmaf, as the reference steps.
//   - Shared memory: rows of max(d, 32) floats, 16-byte chunks swizzled so
//     that each fragment load reads 32 distinct banks (q and k: odd rows
//     swap 4-chunk halves; v: chunk c of row r at c ^ (r & 6)).  k/v go
//     through a two-stage ring fed by 16-byte cp.async (zero fill past
//     Skv): tile j + 1 is in flight while tile j multiplies; 192 KB at
//     d = 256, 128 KB at d = 128, 96 KB at d = 64, 48 KB below.  A
//     thread copies one 16-byte column chunk of every few rows, so its
//     addresses step by constants and hold no registers.
//   - The online softmax in registers (a thread holds two query rows; a
//     row's max and sum are two shuffles across its 4 lanes), in f32 with
//     precise expf and tanhf and IEEE division.  Blocks take query tiles
//     longest first across all heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"
#include "tf32.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The bf16 tensor-core kernel.
namespace tc {

constexpr int kThreads = 256;        // two consumer warpgroups
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

}  // namespace tc

// The f32 tensor-core kernel (3xTF32 on mma.sync).
namespace f32 {

using repro_torch::mma;
using repro_torch::split;

template <int D>
struct Tile {
  static constexpr int kWarps = D > 128 ? 4 : 8;   // 16 query rows a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;          // query rows per block
  // keys per k/v tile: 32 from d = 128 up, where the output accumulator
  // (d / 2 registers a thread) leaves no room for a 64-key tile's scores
  static constexpr int kBK = D > 64 ? 32 : 64;
  static constexpr int kW = D < 32 ? 32 : D;       // floats a shared row
  static constexpr int kVW = D < 32 ? 2 : 4;       // tiles a v load feeds
  static constexpr int kCB = D / (8 * kVW);        // blocks of kVW tiles in o
  static constexpr int kQ = kBQ * kW * 4;          // bytes of the q tile
  static constexpr int kKV = kBK * kW * 4;         // bytes of one k or v tile
  static constexpr size_t kSmem = kQ + 4 * kKV;    // q, two stages of (k, v)
};

// Byte offset of 16-byte chunk c of row r in a tile of W-float rows.  q
// and k fragments are read four floats a lane from rows r and r + 1 at
// once: odd rows swap 4-chunk halves.  v fragments are read from rows r,
// r + 2, r + 4, r + 6 at once: chunk c of row r sits at c ^ (r & 6).
template <int W>
__device__ __forceinline__ int qk_at(int r, int c) {
  return r * W * 4 + ((c ^ ((r & 1) << 2)) << 4);
}
template <int W>
__device__ __forceinline__ int v_at(int r, int c) {
  return r * W * 4 + ((c ^ (r & 6)) << 4);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stages rows [0, ROWS) of a [*, D] f32 matrix whose row 0 is at src and
// of which `valid` rows exist, at byte offset dst of shared memory, laid
// out for q/k (V false) or v (V true); missing rows are zero-filled
// (reading nothing, from `any`, a valid address).  A thread copies one
// 16-byte column chunk c of every kStep-th row, so its addresses step
// by constants (kept out of registers).
template <int D, int ROWS, bool V>
__device__ __forceinline__ void stage(uint32_t dst, const float* src,
                                      int valid, const float* any) {
  using T = Tile<D>;
  constexpr int kChunks = D / 4;
  constexpr int kStep = T::kThreads / kChunks;
  static_assert(T::kThreads % kChunks == 0 && ROWS % kStep == 0,
                "uneven staging");
  const int c = static_cast<int>(threadIdx.x) % kChunks;
  const int r0 = static_cast<int>(threadIdx.x) / kChunks;
#pragma unroll
  for (int i = 0; i < ROWS / kStep; ++i) {
    const int r = r0 + i * kStep;
    const bool in = r < valid;
    cp_async16(dst + (V ? v_at<T::kW>(r, c) : qk_at<T::kW>(r, c)),
               in ? src + static_cast<size_t>(r) * D + c * 4 : any, in);
  }
}

// The kVW floats of row r of a v tile from column col (a multiple of
// kVW).
template <int D>
__device__ __forceinline__ void load_v(const unsigned char* vs, int r,
                                       int col, float (&x)[Tile<D>::kVW]) {
  const unsigned char* at =
      vs + v_at<Tile<D>::kW>(r, col >> 2) + (col & 3) * 4;
  if constexpr (Tile<D>::kVW == 4) {
    const float4 f = *reinterpret_cast<const float4*>(at);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(at);
    x[0] = f.x;
    x[1] = f.y;
  }
}

// Fragment layout (mma m16n8k8, lane = 4 g + t): a warp's accumulator
// d[4] holds rows g and g + 8 of its 16 rows, columns 2t and 2t + 1 of
// an 8-column tile: d[2i + e] is row g + 8i, column 2t + e.
template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
flash_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int bh_n, int g, int sq, int skv, int causal, int window,
                  float scale, float cap) {
  using T = Tile<D>;
  constexpr int BK = T::kBK;
  constexpr int NS = BK / 8;   // 8-key tiles of S, k-steps of PV
  constexpr int KP = D / 16;   // pairs of k-steps of QK^T
  constexpr int VW = T::kVW, CB = T::kCB, W = T::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  // q at byte 0; stage s: k at kQ + 2 s kKV, v after it
  const uint32_t base = smem_u32(smem);

  const int nq = (sq + T::kBQ - 1) / T::kBQ;
  const int bh = static_cast<int>(blockIdx.x) % bh_n;
  const int q_lo = (nq - 1 - static_cast<int>(blockIdx.x) / bh_n) * T::kBQ;
  const int q_hi = min(q_lo + T::kBQ, sq) - 1;
  const float* qh = q + static_cast<size_t>(bh) * sq * D;
  const float* kh = k + static_cast<size_t>(bh / g) * skv * D;
  const float* vh = v + static_cast<size_t>(bh / g) * skv * D;

  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wq_lo = q_lo + 16 * warp, wq_hi = min(wq_lo + 15, sq - 1);
  const int row0 = wq_lo + gr;   // and row0 + 8

  const int nk = (skv + BK - 1) / BK;
  const int kt_end = causal ? min(nk, q_hi / BK + 1) : nk;
  int kt_begin = 0;
  if (window && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / BK;

  stage<D, T::kBQ, false>(base, qh + static_cast<size_t>(q_lo) * D,
                          sq - q_lo, qh);
  if (kt_begin < kt_end) {
    const int lo = kt_begin * BK;
    stage<D, BK, false>(base + T::kQ, kh + static_cast<size_t>(lo) * D,
                        skv - lo, kh);
    stage<D, BK, true>(base + T::kQ + T::kKV,
                       vh + static_cast<size_t>(lo) * D, skv - lo, vh);
  }
  cp_async_commit();

  float o[CB][VW][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int u = 0; u < VW; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[cb][u][x] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int ko = T::kQ + ((kt - kt_begin) & 1) * 2 * T::kKV;
    cp_async_wait_all();
    __syncthreads();   // tile kt has landed; every thread is past tile kt-1
    if (kt + 1 < kt_end) {
      const int nxt = T::kQ + ((kt + 1 - kt_begin) & 1) * 2 * T::kKV;
      const int lo = (kt + 1) * BK;
      stage<D, BK, false>(base + nxt, kh + static_cast<size_t>(lo) * D,
                          skv - lo, kh);
      stage<D, BK, true>(base + nxt + T::kKV,
                         vh + static_cast<size_t>(lo) * D, skv - lo, vh);
      cp_async_commit();
    }
    const int k_lo = kt * BK;
    // tiles this warp's 16 rows do not need (uniform per warp)
    if (wq_lo >= sq || (causal && k_lo > wq_hi) ||
        (window && k_lo + BK - 1 <= wq_lo - window))
      continue;

    // S = Q K^T.  k-step 2 kp + h reads, for slot t (t + 4), column
    // 16 kp + 4 t + 2 h (+ 1): one 16-byte load a row feeds two k-steps.
    float s[NS][4], sx[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = sx[j][x] = 0.0f;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      const float4 qa = *reinterpret_cast<const float4*>(
          smem + qk_at<W>(16 * warp + gr, 4 * kp + tq));
      const float4 qb = *reinterpret_cast<const float4*>(
          smem + qk_at<W>(16 * warp + gr + 8, 4 * kp + tq));
      uint32_t ab[2][4], as[2][4];
      split(qa.x, ab[0][0], as[0][0]);
      split(qb.x, ab[0][1], as[0][1]);
      split(qa.y, ab[0][2], as[0][2]);
      split(qb.y, ab[0][3], as[0][3]);
      split(qa.z, ab[1][0], as[1][0]);
      split(qb.z, ab[1][1], as[1][1]);
      split(qa.w, ab[1][2], as[1][2]);
      split(qb.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(
            smem + ko + qk_at<W>(8 * j + gr, 4 * kp + tq));
        uint32_t bb[4], bs[4];
        split(kb.x, bb[0], bs[0]);
        split(kb.y, bb[1], bs[1]);
        split(kb.z, bb[2], bs[2]);
        split(kb.w, bb[3], bs[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(sx[j], as[h], bb[2 * h], bb[2 * h + 1]);
          mma(sx[j], ab[h], bs[2 * h], bs[2 * h + 1]);
          mma(s[j], ab[h], bb[2 * h], bb[2 * h + 1]);
        }
      }
    }

    // scores: (big.big + the small terms) d^-1/2, capped, masked
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float y = __fmul_rn(__fadd_rn(s[j][x], sx[j][x]), scale);
        if (cap > 0.0f) y = __fmul_rn(tanhf(__fdiv_rn(y, cap)), cap);
        s[j][x] = y;
      }
    if (k_lo + BK > skv || (causal && k_lo + BK - 1 > wq_lo) ||
        (window && k_lo <= wq_hi - window)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int kpos = k_lo + 8 * j + 2 * tq + (x & 1);
          const int qpos = row0 + 8 * (x >> 1);
          bool keep = true;
          if (causal) keep = keep && kpos <= qpos;
          if (window) keep = keep && kpos > qpos - window;
          s[j][x] = kpos >= skv ? -INFINITY : (keep ? s[j][x] : kNegInf);
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) mx[x >> 1] = fmaxf(mx[x >> 1], s[j][x]);
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(__fsub_rn(m[i], mx[i]));
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        s[j][x] = expf(__fsub_rn(s[j][x], m[x >> 1]));
        sum[x >> 1] = __fadd_rn(sum[x >> 1], s[j][x]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], quad_sum(sum[i]));

    // P as the A fragment of PV: k-step j holds keys 8 j + 2 t at slot t
    // and 8 j + 2 t + 1 at slot t + 4, so the fragment is (s0, s2, s1, s3)
    uint32_t pb[NS][4], ps[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      split(s[j][0], pb[j][0], ps[j][0]);
      split(s[j][2], pb[j][1], ps[j][1]);
      split(s[j][1], pb[j][2], ps[j][2]);
      split(s[j][3], pb[j][3], ps[j][3]);
    }

    // o = o alpha + P V, one block of VW 8-column tiles at a time: tile u,
    // fragment column n is column cb 8 VW + VW n + u, so the B fragments
    // of the block's tiles are one load of VW floats from each of rows
    // 8 j + 2 t and 8 j + 2 t + 1
    const unsigned char* vs = smem + ko + T::kKV;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      float pv[VW][4];
#pragma unroll
      for (int u = 0; u < VW; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) pv[u][x] = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float v0[VW], v1[VW];
        load_v<D>(vs, 8 * j + 2 * tq, cb * 8 * VW + VW * gr, v0);
        load_v<D>(vs, 8 * j + 2 * tq + 1, cb * 8 * VW + VW * gr, v1);
#pragma unroll
        for (int u = 0; u < VW; ++u) {
          uint32_t bb0, bs0, bb1, bs1;
          split(v0[u], bb0, bs0);
          split(v1[u], bb1, bs1);
          mma(pv[u], ps[j], bb0, bb1);
          mma(pv[u], pb[j], bs0, bs1);
          mma(pv[u], pb[j], bb0, bb1);
        }
      }
#pragma unroll
      for (int u = 0; u < VW; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          o[cb][u][x] = fmaf(o[cb][u][x], alpha[x >> 1], pv[u][x]);
    }
  }

  // row g (+8), block cb: columns cb 8 VW + 2 VW t + [0, 2 VW), tile u's
  // d[2i] at + u and d[2i + 1] at + VW + u
  float* oh = out + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      float r[2 * VW];
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        r[u] = __fdiv_rn(o[cb][u][2 * i], den);
        r[VW + u] = __fdiv_rn(o[cb][u][2 * i + 1], den);
      }
      float4* at = reinterpret_cast<float4*>(
          oh + static_cast<size_t>(qp) * D + cb * 8 * VW + 2 * VW * tq);
#pragma unroll
      for (int c = 0; c < 2 * VW / 4; ++c)
        at[c] = make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2],
                            r[4 * c + 3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int g, int sq, int skv, int causal, int window, float scale,
           float cap, cudaStream_t stream) {
  using T = Tile<D>;
  static size_t allowed = repro_torch::kDefaultSmem;
  const cudaError_t err =
      repro_torch::allow_smem(flash_kernel_tf32<D>, T::kSmem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((sq + T::kBQ - 1) / T::kBQ) * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel_tf32<D><<<static_cast<unsigned>(blocks), T::kThreads,
                         T::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), bh, g, sq, skv,
      causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int g, int sq, int skv, int causal, int window, int bf16,
           float scale, float cap, cudaStream_t stream) {
  return bf16 ? tc::launch<D>(q, k, v, out, bh, g, sq, skv, causal, window,
                              scale, cap, stream)
              : f32::launch<D>(q, k, v, out, bh, g, sq, skv, causal, window,
                               scale, cap, stream);
}

}  // namespace

// bh = B * Hq flattened query rows, g = Hq / Hkv; bf16 != 0 selects
// bfloat16 tensors (the wgmma kernel), else float32 (the 3xTF32 kernel).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int g, int sq, int skv, int d,
                                      int causal, int window, int bf16,
                                      float scale, float cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, out, bh, g, sq, skv, causal, window, bf16,
                        scale, cap, s);
    case 32:
      return launch<32>(q, k, v, out, bh, g, sq, skv, causal, window, bf16,
                        scale, cap, s);
    case 64:
      return launch<64>(q, k, v, out, bh, g, sq, skv, causal, window, bf16,
                        scale, cap, s);
    case 128:
      return launch<128>(q, k, v, out, bh, g, sq, skv, causal, window, bf16,
                         scale, cap, s);
    case 256:
      return launch<256>(q, k, v, out, bh, g, sq, skv, causal, window, bf16,
                         scale, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
