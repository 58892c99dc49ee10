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
//   cost of one launch; the fresh rank adds a sort of each row out of
//   shared memory.  Design: one block per row, so no cross-block
//   reduction is needed; the row's keys and tie keys live in shared
//   memory.  The fresh rank is a bitonic sort of the row's column
//   indices (16-bit, padded to the next power of two n) under the
//   lexicographic order of (key, tie, column) -- log2(n) (log2(n) + 1) / 2
//   compare-exchange stages, one barrier each -- and the sorted position
//   of a column is its rank: the exact inverse of the stable lexsort
//   permutation, so the rank output matches the plain version bitwise on
//   every slot, invalid ones included (they key as (BIG, BIG, column) and
//   sort after every valid slot, by column).  The comparator reads the
//   f32 keys themselves, so no packing argument is needed, and -0 == +0
//   as in torch.sort; the sort moves only the 2-byte indices, so shared
//   memory is 8 J + 2 n <= 12 J bytes, what the old pairwise form used,
//   and every J that form took still fits (J <= 19,349).  The rates are
//   then written in sorted order (position p is the rank of column
//   idx[p]); the argmin passes re-derive t = rem / rate from the rates
//   just written, with the same instructions, so they see the same bits.
//   None of the TPU layout survives: no 128-lane padding, no
//   pairwise/bitonic switch, no [8, J, J] cube.
//
// event_scan, checked form -- replaces, as one launcher call, what the
//   reference's engine wraps around the kernel in `_checked_scan(
//   select_free=True)` (src/repro/core/engine.py: the `_table_inputs`
//   gather, `_partition_ok`, `where(use, carry, fresh lexsort)` into the
//   injected-rank scan, `n_reseeds += ~use`).  Two kernels on the stream:
//   event_scan_check_kernel gathers each row of the table from the slot
//   map (row_gridlet) and the gridlets' remaining, and writes whether the
//   carried rank still splits that row's MaxShare / MinShare sets as the
//   value order does (one flag per row); event_scan_kernel gathers the
//   row again, reads every row's flag and the carry's own flag, and
//   scans with the carried rank if all hold, else with a fresh sort of
//   every row -- the choice is uniform over the grid, as in the
//   reference -- and its block 0 adds the reseed to a device counter.
//   Two launches rather than one cooperative launch with a grid barrier:
//   the flags must cover every row before any row scans, the second
//   launch is made inside the same ctypes call (no Python between them),
//   and a grid barrier would need a co-residency contract the plain
//   launch does not.  No host read: the engine's scan makes no sync.
//
// event_scan, checked form over scenario lanes -- replaces what the
//   reference's sweep engine runs over its lane batch (`_commit_lanes`'
//   prologue, the any-lane reseed and the injected scan; `_sweep_micro`'s
//   injected scan and `use`): the same two kernels on a (R, L) grid, the
//   lane in blockIdx.y, over [L, R, J] slot maps, [L, N] gridlet
//   remaining, [L, R] row inputs, [L, R, J] carries and a flag per lane.
//   The decision "every row's flag and the carry's own flag hold" is made
//   over the lane's own rows (flags[lane * R ..]), and block 0 of each
//   lane writes it to use[lane]; with `reseed` a lane that fails it sorts
//   every row afresh, without it every lane scans with its carry (the
//   micro-steps, which decline on a stale carry).  One block a row, as
//   above: at the sweep's J = 32 most of a block's 256 threads idle.
//
// link_scan -- replaces the Pallas kernel `link_scan`
//   (event_scan.py: `_link_kernel` and `_link_kernel_cap` over
//   `_link_math`, pl.pallas_call at :872), and, in its engine form, what
//   the reference's engine wraps around it in `_link_scan`
//   (src/repro/core/engine.py): the tie key from the slot map and, with
//   shared trunks, each row's occupancy and `network.trunk_rate_cap`.
//   Per row of the [L, T] transfer-slot table: the live-transfer count m,
//   the fair-share rate baud / max(m + bg, 1) (capped at the row's trunk
//   share), t = rem / rate, the row minimum, the FIFO-tie argmin.
//   Bound: bytes (rem and tie read, rate written: 12 bytes per slot,
//   ~123 KB at [16, 640], ~37 ns of HBM time), so in practice launch
//   latency.  Design: one block per row, the row read once into
//   registers (kLinkHeld slots a thread; a wider row in strips), two
//   barriers.  The first pass counts the row (ballots) and takes its
//   least remaining; t_min is that over the rate -- a correctly rounded
//   quotient by one positive divisor is monotone in the dividend, so it
//   is the least forecast -- and the second pass writes the rates and
//   divides each slot once, to find the slots at t_min.  The argmin's
//   two stages (the least tie key among the slots at t_min,
//   then the least column among those) are one 64-bit minimum over the
//   slots at t_min: an order-preserving unsigned image of the tie key
//   (-0 made +0 first, so equal keys have equal images) above the
//   column.  That minimum is the least tie key tie* among the slots at
//   t_min and, among the slots holding it, the least column j*.
//   `_link_math` takes tie_min as the least key over every slot, a slot
//   off t_min keyed BIG, then the least column at t_min with a key <=
//   tie_min.  So it answers T where no slot is at t_min (empty and dead
//   rows); T where some slot is off t_min and tie* > BIG (then tie_min =
//   BIG and no slot at t_min qualifies); and j* otherwise (tie_min =
//   tie*, and the keys <= tie* at t_min are those equal to it, -0 and +0
//   alike).  The kernel answers the same, knowing whether a slot is off
//   t_min from the count of slots at t_min (ballots).  The cap: given
//   per row (the public trunk form, a null-or-not pointer), or, in the
//   engine form, computed here from the trunk ids: the block's warps
//   recount the rows of its trunk mates in parallel (one mate row a
//   warp, read from L2) in the first pass, and the row takes
//   trunk_baud / max(M + trunk_bg, 1), M an integer count, exact in any
//   order.  (A first design, one warp a row with no barrier, measured
//   twice the old kernel's time on the card: a lone warp's ~40 serial
//   divisions and three passes, with no other warp to hide them.)  No rank: fair shares are uniform on a row.  Inputs are
//   finite or infinite, never NaN (the engine makes none); subnormal
//   remaining or baud values count as zero, as the reference's compiled
//   comparisons read them.
//
// event_frontier -- replaces the Pallas kernel `event_frontier`
//   (event_scan.py: `_frontier_kernel`, pl.pallas_call at :1009).  One
//   block writes all five outputs: each source segment's minimum
//   candidate and minimum horizon-cutting candidate, t* (the least
//   minimum), which sources fire at t*, each segment's count of
//   candidates due at t*, and t_safe.  Bound: launch latency (a few KB of
//   candidates).  Design: every thread strides over all C candidates,
//   eight loads in flight at a time, keeping a running min, safe min and
//   due count for the segment its current candidate lies in (segment
//   offsets in shared memory, not the TPU's [S, C] membership matrix),
//   and folds them into shared memory when it moves to a later segment:
//   mins through atomicMin on an order-preserving integer image of the
//   f32 value, counts through atomicAdd.  So every segment reduces at
//   once, not one source after another.  Pass 1 (mins), barrier, every
//   thread takes t* from the S minima, pass 2 (counts), barrier, one
//   thread a segment writes out.  Min and count are exact in any order,
//   so the outputs match the plain version bitwise.  (Grouping a warp's
//   lanes by segment with __match_any_sync and reducing them with
//   __reduce_*_sync before the atomics measured slower on the card than
//   that.)  The lane form runs one such block per scenario lane (the lane
//   in blockIdx.x), each over its own row of an [L, C] candidate table
//   with the same segment layout.
//
// event_scan_slab -- replaces the Pallas kernel `event_scan_slab`
//   (event_scan.py: `_slab_kernel` over `_slab_waves` and
//   `_slab_waves_assoc(tree=True)`, pl.pallas_call at :677).  Per row:
//   the same masks and (remaining, tie, column) rank as event_scan, then
//   the row's next k completions under uninterrupted Fig 8 dynamics.
//   Bound: bytes (8 bytes a slot read, 8 bytes a wave written: ~82 KB at
//   [16, 640], ~25 ns of HBM time), so in practice launch latency and
//   the rank.  Design: one block per row with event_scan's shared-memory
//   keys (`row_keys`) and its bitonic sort (`sort_row`): the sorted
//   position of a valid slot is its rank, so the k heads (rank < k) are
//   the columns idx[0 .. min(occ, k) - 1]; their remaining and columns
//   are gathered into shared memory and the waves run on k values, not
//   on the row: assoc=0 is the sequential recurrence on one thread;
//   assoc=1 builds the k homogeneous (k+1)x(k+1) wave matrices in
//   parallel and composes them level by level in the Pallas body's
//   balanced tree (identity-padded, FMA chains in the inner index from
//   +0, as XLA:CPU compiles `_mats_mul`), then clamps and sums the last
//   column with XLA's tile-16 cumsum.  The Fig 8 share of rank p in wave
//   w is `Fig8Row(g - w).rate(p - w)`, the same code event_scan runs.
//   Every k >= 1 the reference takes: a row has at most J heads, so the
//   sequential form keeps min(k, J) of them beside the row whatever k
//   is; the associative form keeps its k + ceil(k/2) matrices in shared
//   memory up to `event_scan_slab_max_k` (32 at J = 640) and above it in
//   a global workspace the wrapper allocates (the same tree, the same
//   FMA chains, so the same bits).
//
// Every quotient and product uses the _rn intrinsics: IEEE f32, never
// contracted, matching the reference's `mips / max(divisor, 1)` and
// `rem / max(rate, 1e-30)`; an FMA is written as fmaf exactly where
// XLA:CPU contracts the reference (the slab's `rem - rate * dt` and its
// matrix products).  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "launch.cuh"

namespace {

using repro_torch::allow_smem;
using repro_torch::kDefaultSmem;

constexpr float kBig = 3.0e38f;
constexpr int kScanThreads = 256;
constexpr int kFrontierThreads = 512;
constexpr int kFrontierLoads = 8;   // candidates a thread loads at once
// A link row a block, kLinkHeld of its slots a thread; a trunk mate's
// row is counted by one warp, kLinkSlots loads a lane at a time.
constexpr int kLinkThreads = 256;
constexpr int kLinkHeld = 8;
constexpr int kLinkSlots = 24;
constexpr int kLinkStrip = 32 * kLinkSlots;

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

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : -INFINITY;
    w = warp_max(w);
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

// The Fig 8 share of one row with g jobs (`_fig8_rates`): the row
// constants, then the rate of a valid slot of a given rank.
struct Fig8Row {
  float k, msc, mips;
  bool whole_pe;
  __device__ Fig8Row(float g, float npe_e, float pol, float mips_r) {
    const float m = fmaxf(npe_e, 1.0f);
    k = floorf(__fdiv_rn(g, m));
    const float extra = __fsub_rn(g, __fmul_rn(k, m));
    msc = __fmul_rn(__fsub_rn(npe_e, extra), k);
    whole_pe = (g <= npe_e) || (pol > 0.5f);
    mips = mips_r;
  }
  __device__ float rate(float rank) const {
    const float divisor =
        whole_pe ? 1.0f : __fadd_rn(k, rank >= msc ? 1.0f : 0.0f);
    return __fdiv_rn(mips, fmaxf(divisor, 1.0f));
  }
};

// `_row_masks` for row r: the effective PE count and whether the row is
// dead.
struct RowMask {
  float npe_e, pol;
  bool dead;
  __device__ RowMask(const float* npe, const float* pol_, const float* blk,
                     const float* ok, int r) {
    npe_e = fmaxf(__fsub_rn(npe[r], blk[r]), 0.0f);
    pol = pol_[r];
    dead = (ok[r] < 0.5f) || ((pol < 0.5f) && (npe_e < 0.5f));
  }
};

// Where a row's slots come from: the [R, J] table itself (rem, tie), or
// -- the engine's checked form -- the slot map rg (gridlet index, -1 =
// empty) and the gridlets' remaining, gathered as `_table_inputs` does:
// an occupied slot holds its gridlet's remaining clamped to 1e-30 (0
// marks an empty slot) and the gridlet index as its tie key; an empty
// slot holds 0 and 2^30.
struct TableIn {
  const float* rem;
  const float* tie;
  const int* rg;            // non-null: gather from the slot map
  const float* g_rem;
  int n_gridlets;
  // The same source for scenario lane `lane`: its gridlets' remaining.
  __device__ TableIn at_lane(int lane) const {
    TableIn out = *this;
    if (g_rem != nullptr) out.g_rem += static_cast<size_t>(lane) * n_gridlets;
    return out;
  }
  __device__ void slot(size_t at, float* x, float* t) const {
    if (rg == nullptr) {
      *x = rem[at];
      *t = tie[at];
      return;
    }
    const int gid = rg[at];
    const bool occupied = gid >= 0;
    *x = occupied ? fmaxf(g_rem[min(gid, n_gridlets - 1)], 1e-30f) : 0.0f;
    *t = occupied ? __int2float_rn(gid) : 1073741824.0f;
  }
};

// The per-row inputs, f32 [R]: effective MIPS, PEs, policy (1 = space-
// shared), reserved PEs, row up.
struct RowIn {
  const float* mips;
  const float* npe;
  const float* pol;
  const float* blk;
  const float* ok;
};

// Fills the row's sort keys in shared memory (remaining and tie, BIG
// where the slot is invalid) and returns the occupancy.  Ends on a
// barrier: the keys are visible to the whole block.
__device__ int row_keys(const TableIn& in, size_t row, int J, bool dead,
                        float* key, float* tkey, int* redi) {
  int n_valid = 0;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    float x, t;
    in.slot(row + j, &x, &t);
    const bool valid = (x > 0.0f) && (x < kBig) && !dead;
    key[j] = valid ? x : kBig;
    tkey[j] = valid ? t : kBig;
    n_valid += valid ? 1 : 0;
  }
  return block_sum(n_valid, redi);
}

// Column a precedes column b in the row's lexsort order: (key, tie key,
// column) compared lexicographically as f32 values (the plain version's
// two stable sorts); padding columns (>= J) follow every slot.
__device__ __forceinline__ bool precedes(int a, int b, const float* key,
                                         const float* tkey, int J) {
  if (a >= J || b >= J) return a < b;
  const float ka = key[a], kb = key[b];
  if (ka != kb) return ka < kb;
  const float ta = tkey[a], tb = tkey[b];
  if (ta != tb) return ta < tb;
  return a < b;
}

// Sorts the columns 0..n-1 (n the power of two >= J) into idx by
// `precedes`: the bitonic network, pairs (lo, lo + s) with bit s of lo
// clear, ascending where bit k of lo is clear; a barrier after every
// stage, the last one included.  idx[p] for p < J is then the column of
// rank p.
__device__ void sort_row(const float* key, const float* tkey, int J, int n,
                         unsigned short* idx) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    idx[i] = static_cast<unsigned short>(i);
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int s = k >> 1; s > 0; s >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (s - 1)), hi = lo + s;
        const int a = idx[lo], b = idx[hi];
        if (precedes(b, a, key, tkey, J) == ((lo & k) == 0)) {
          idx[lo] = static_cast<unsigned short>(b);
          idx[hi] = static_cast<unsigned short>(a);
        }
      }
      __syncthreads();
    }
  }
}

// One block per resource row, blockIdx.y the scenario lane (one lane
// but for the checked lane form; row arrays are [L, R, ...]).  The rank
// the row's shares are cut by:
//   rank_in == nullptr: a fresh sort (written to rank_out when that is
//     non-null);
//   rank_in, flags == nullptr: the injected rank;
//   flags (the checked form): the carried rank rank_in if slab_ok[lane]
//     and every one of the lane's row flags hold (`use`), else, with
//     `reseed`, a fresh sort of each of the lane's rows; rank_out gets
//     the rank used; block 0 of the lane adds a reseed to *n_reseeds
//     (when non-null) and writes `use` to use_out[lane] (when non-null).
// Shared memory: key, tkey [J] f32, then idx [n] u16 for a sort.
__global__ void __launch_bounds__(kScanThreads)
event_scan_kernel(TableIn in, RowIn rows, const float* __restrict__ rank_in,
                  const int* __restrict__ flags,
                  const bool* __restrict__ slab_ok,
                  int* __restrict__ n_reseeds, bool* __restrict__ use_out,
                  int reseed, float* __restrict__ rate_out,
                  float* __restrict__ tmin_out, int* __restrict__ amin_out,
                  int* __restrict__ occ_out, float* __restrict__ rank_out,
                  int R, int J, int n) {
  extern __shared__ float smem[];
  float* key = smem;            // remaining, BIG where the slot is invalid
  float* tkey = smem + J;       // tie key, BIG where invalid
  unsigned short* idx = reinterpret_cast<unsigned short*>(smem + 2 * J);
  __shared__ float redf[32];
  __shared__ int redi[32];

  const int r = blockIdx.x, lane = blockIdx.y;
  const int lr = lane * R + r;  // the row among every lane's rows
  const size_t row = static_cast<size_t>(lr) * J;
  const RowMask rm(rows.npe, rows.pol, rows.blk, rows.ok, lr);
  const int occ = row_keys(in.at_lane(lane), row, J, rm.dead, key, tkey,
                           redi);
  const Fig8Row fig8(static_cast<float>(occ), rm.npe_e, rm.pol,
                     rows.mips[lr]);

  bool fresh = rank_in == nullptr;
  if (flags != nullptr) {       // the same answer in every block of a lane
    const int* lane_flags = flags + static_cast<size_t>(lane) * R;
    int all = slab_ok[lane] ? 1 : 0;
    for (int q = threadIdx.x; q < R; q += blockDim.x)
      all &= lane_flags[q] != 0;
    const bool use = __syncthreads_and(all);
    fresh = reseed && !use;
    if (r == 0 && threadIdx.x == 0) {
      if (n_reseeds != nullptr && fresh) *n_reseeds += 1;
      if (use_out != nullptr) use_out[lane] = use;
    }
  }

  // rate and forecast of column j at rank rk (BIG where invalid)
  auto emit = [&](int j, float rk) {
    const float kj = key[j];
    const bool valid = kj < kBig;
    const float rate = valid ? fig8.rate(rk) : 0.0f;
    rate_out[row + j] = rate;
    if (rank_out != nullptr) rank_out[row + j] = rk;
    return valid ? __fdiv_rn(kj, fmaxf(rate, 1e-30f)) : kBig;
  };
  float tmin_local = kBig;
  if (fresh) {
    sort_row(key, tkey, J, n, idx);
    for (int p = threadIdx.x; p < J; p += blockDim.x)
      tmin_local = fminf(tmin_local, emit(idx[p], static_cast<float>(p)));
  } else {
    for (int j = threadIdx.x; j < J; j += blockDim.x)
      tmin_local = fminf(tmin_local, emit(j, rank_in[row + j]));
  }
  const float tmin = block_min(tmin_local, redf);   // barrier: rates visible

  // argmin: earliest forecast, FIFO ties by the tie key, then the column;
  // a forecast is re-derived from the rate just written, as emit made it
  auto at_min = [&](int j) {
    const float kj = key[j];
    return kj < kBig &&
           __fdiv_rn(kj, fmaxf(rate_out[row + j], 1e-30f)) <= tmin;
  };
  float cand_local = kBig;
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    if (at_min(j)) cand_local = fminf(cand_local, tkey[j]);
  const float tie_min = block_min(cand_local, redf);
  int col_local = J;
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    if (at_min(j) && tkey[j] <= tie_min) col_local = min(col_local, j);
  const int amin = block_min(col_local, redi);
  if (threadIdx.x == 0) {
    tmin_out[lr] = tmin;
    amin_out[lr] = amin;
    occ_out[lr] = occ;
  }
}

// The checked form's first pass, one block per row: flags[r] = 1 iff the
// carried rank still yields row r's Fig 8 rates (`_partition_ok`): the
// row never consults its rank (space-shared, or g <= P_eff), or the
// lexicographic max of its carried MaxShare side (valid, rank < msc)
// lies strictly below the min of its MinShare side (rank >= msc).  With
// the lane's carry invalid (!slab_ok[lane]) there is nothing to decide.
// blockIdx.y is the scenario lane, as in event_scan_kernel.
__global__ void __launch_bounds__(kScanThreads)
event_scan_check_kernel(TableIn in, RowIn rows,
                        const float* __restrict__ carry,
                        const bool* __restrict__ slab_ok,
                        int* __restrict__ flags, int R, int J) {
  if (!slab_ok[blockIdx.y]) return;
  extern __shared__ float smem[];
  float* key = smem;
  float* tkey = smem + J;
  __shared__ float redf[32];
  __shared__ int redi[32];

  const int lr = blockIdx.y * R + blockIdx.x;
  const size_t row = static_cast<size_t>(lr) * J;
  const RowMask rm(rows.npe, rows.pol, rows.blk, rows.ok, lr);
  const int occ = row_keys(in.at_lane(blockIdx.y), row, J, rm.dead, key,
                           tkey, redi);
  const Fig8Row fig8(static_cast<float>(occ), rm.npe_e, rm.pol, 0.0f);
  if (fig8.whole_pe) {
    if (threadIdx.x == 0) flags[lr] = 1;
    return;
  }
  float lo = -kBig, hi = kBig;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    if (key[j] >= kBig) continue;
    if (carry[row + j] < fig8.msc)
      lo = fmaxf(lo, key[j]);
    else
      hi = fminf(hi, key[j]);
  }
  const float rem_lo = block_max(lo, redf);
  const float rem_hi = block_min(hi, redf);
  float tlo = -kBig, thi = kBig;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    if (key[j] >= kBig) continue;
    const bool left = carry[row + j] < fig8.msc;
    if (left && key[j] == rem_lo) tlo = fmaxf(tlo, tkey[j]);
    if (!left && key[j] == rem_hi) thi = fminf(thi, tkey[j]);
  }
  const float tie_lo = block_max(tlo, redf);
  const float tie_hi = block_min(thi, redf);
  if (threadIdx.x == 0)
    flags[lr] = (rem_lo < rem_hi) || (rem_lo == rem_hi && tie_lo < tie_hi);
}

// Where a link row's slots come from: the remaining bytes rem [L, T],
// and the tie key [L, T] (the public form) or the slot map lg (gridlet
// index, -1 = free; the engine form), whose tie key is the gridlet index,
// 2^30 on a free slot, as the reference's engine builds it.
struct LinkIn {
  const float* rem;
  const float* tie;
  const int* lg;
  __device__ float tie_at(size_t at) const {
    if (lg == nullptr) return tie[at];
    const int gid = lg[at];
    return gid >= 0 ? __int2float_rn(gid) : 1073741824.0f;
  }
};

// The per-row inputs of the link scan, f32 [L] but trunk_of i32 [L]:
// baud and background flows; then the rate cap, given (cap) or computed
// from the trunk ids (trunk_of, trunk_baud, trunk_bg), or neither (the
// private-link form).
struct LinkRows {
  const float* baud;
  const float* bg;
  const float* cap;
  const int* trunk_of;
  const float* trunk_baud;
  const float* trunk_bg;
  // subnormals count as zero, as in the reference's compiled compares
  __device__ bool live(int l) const {
    const float b = baud[l];
    return b >= FLT_MIN && b < kBig;
  }
};

__device__ __forceinline__ bool holds_transfer(float x) {
  return x >= FLT_MIN && x < kBig;
}

// The transfers on the link row at `row`, counted by one warp (every
// lane gets the count): kLinkSlots loads a lane in flight at once.
__device__ int warp_count_row(const float* rem, size_t row, int T,
                              int lane) {
  int n = 0;
  for (int base = 0; base < T; base += kLinkStrip) {
    float y[kLinkSlots];
#pragma unroll
    for (int u = 0; u < kLinkSlots; ++u) {
      const int j = base + u * 32 + lane;
      y[u] = j < T ? rem[row + j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLinkSlots; ++u)
      n += __popc(__ballot_sync(0xffffffffu, holds_transfer(y[u])));
  }
  return n;
}

// An order-preserving unsigned image of a (non-NaN) f32, -0 read as +0.
__device__ __forceinline__ unsigned tie_image(float f) {
  const unsigned b = __float_as_uint(__fadd_rn(f, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One block per link row, kLinkThreads threads, each holding kLinkHeld
// slots of the row (remaining and tie key) in registers (a wider row is
// walked in strips of kLinkThreads * kLinkHeld, re-read by the second
// pass).  Every load of the first pass is issued before any is waited
// on (nothing waits on the row's baud); the trunk mates' rows are the
// one second round of loads.  Two barriers:
//   pass 1: occupancy (ballots), the least remaining, and with trunks
//     the mates' transfers (warp w counts the mates w, w + 8, ...);
//   -- barrier: the row's m, M and least remaining --
//   the cap and the share; t_min = least remaining / rate (a correctly
//     rounded quotient by one positive divisor is monotone in the
//     dividend, so this is the least forecast), BIG if a slot is empty
//     and that is less;
//   pass 2: rates written; the least (tie image, column) and the count
//     of the slots at t_min;
//   -- barrier: the row's argmin --
__global__ void __launch_bounds__(kLinkThreads)
link_scan_kernel(LinkIn in, LinkRows rows, float* __restrict__ rate_out,
                 float* __restrict__ tmin_out, int* __restrict__ amin_out,
                 int* __restrict__ occ_out, int T) {
  constexpr int kWarps = kLinkThreads / 32;
  constexpr int kStrip = kLinkThreads * kLinkHeld;
  __shared__ int s_occ[kWarps], s_mates[kWarps], s_at[kWarps];
  __shared__ float s_xmin[kWarps];
  __shared__ unsigned long long s_key[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = blockIdx.x, L = gridDim.x;
  const size_t row = static_cast<size_t>(l) * T;
  const int n_strips = (T + kStrip - 1) / kStrip;
  float x[kLinkHeld], tk[kLinkHeld];
  auto load = [&](int s) {
#pragma unroll
    for (int u = 0; u < kLinkHeld; ++u) {
      const int j = s * kStrip + u * kLinkThreads + threadIdx.x;
      x[u] = j < T ? in.rem[row + j] : 0.0f;
      tk[u] = j < T ? in.tie_at(row + j) : 0.0f;
    }
  };
  // with trunks, the trunk ids and liveness of rows lane, 32 + lane, ...
  const int trunk = rows.trunk_of != nullptr ? rows.trunk_of[l] : -1;
  int lane_trunk = -1;
  bool lane_live = false;
  if (rows.trunk_of != nullptr && lane < L) {
    lane_trunk = rows.trunk_of[lane];
    lane_live = rows.live(lane);
  }
  load(0);
  // a dead row holds no transfer
  const bool live = rows.live(l);

  // Pass 1 (the last strip loaded stays in x)
  int occ = 0;
  float xmin = INFINITY;
  for (int s = 0; s < n_strips; ++s) {
    if (s > 0) load(s);
#pragma unroll
    for (int u = 0; u < kLinkHeld; ++u) {
      const bool v = live && holds_transfer(x[u]);
      occ += __popc(__ballot_sync(0xffffffffu, v));
      if (v) xmin = fminf(xmin, x[u]);
    }
  }
  int mates = 0;
  if (trunk >= 0) {
    int seen = 0;
    for (int q0 = 0; q0 < L; q0 += 32) {
      const int q = q0 + lane;
      if (q0 > 0 && q < L) {
        lane_trunk = rows.trunk_of[q];
        lane_live = rows.live(q);
      }
      unsigned found = __ballot_sync(
          0xffffffffu, q < L && q != l && lane_trunk == trunk && lane_live);
      for (; found; found &= found - 1, ++seen)
        if (seen % kWarps == warp)
          mates += warp_count_row(
              in.rem, static_cast<size_t>(q0 + __ffs(found) - 1) * T, T,
              lane);
    }
  }
  xmin = warp_min(xmin);
  if (lane == 0) {
    s_occ[warp] = occ;
    s_mates[warp] = mates;
    s_xmin[warp] = xmin;
  }
  __syncthreads();
  occ = 0;
  mates = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    occ += s_occ[w];
    mates += s_mates[w];
    xmin = fminf(xmin, s_xmin[w]);
  }

  // The cap: given, or the trunk's fair share over its rows' transfers
  float cap = rows.cap != nullptr ? rows.cap[l] : kBig;
  if (trunk >= 0)
    cap = __fdiv_rn(rows.trunk_baud[l],
                    fmaxf(__fadd_rn(static_cast<float>(occ + mates),
                                    rows.trunk_bg[l]),
                          1.0f));
  float share = __fdiv_rn(
      rows.baud[l],
      fmaxf(__fadd_rn(static_cast<float>(occ), rows.bg[l]), 1.0f));
  if (rows.cap != nullptr || rows.trunk_of != nullptr)
    share = fminf(share, cap);
  const float div_rate = fmaxf(share, 1e-30f);
  float tmin = occ > 0 ? __fdiv_rn(xmin, div_rate) : kBig;
  if (occ < T) tmin = fminf(tmin, kBig);

  // Pass 2: rates (0 on empty slots); the slots at t_min, their forecast
  // the same quotient
  unsigned long long best = ~0ull;
  int n_at = 0;
  for (int s = 0; s < n_strips; ++s) {
    if (n_strips > 1) load(s);
#pragma unroll
    for (int u = 0; u < kLinkHeld; ++u) {
      const int j = s * kStrip + u * kLinkThreads + threadIdx.x;
      const bool v = live && holds_transfer(x[u]);
      if (j < T) rate_out[row + j] = v ? share : 0.0f;
      const bool at = v && __fdiv_rn(x[u], div_rate) <= tmin;
      n_at += __popc(__ballot_sync(0xffffffffu, at));
      if (at) {
        const unsigned long long key =
            (static_cast<unsigned long long>(tie_image(tk[u])) << 32) |
            static_cast<unsigned>(j);
        best = min(best, key);
      }
    }
  }
  best = warp_min(best);
  if (lane == 0) {
    s_key[warp] = best;
    s_at[warp] = n_at;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_at = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      best = min(best, s_key[w]);
      n_at += s_at[w];
    }
    // `_link_math`'s second stage keeps j* unless a slot off t_min
    // (keyed BIG) undercuts tie*, or no slot is at t_min
    const bool kept = n_at == T ||
                      static_cast<unsigned>(best >> 32) <= tie_image(kBig);
    tmin_out[l] = tmin;
    amin_out[l] = (n_at > 0 && kept) ? static_cast<int>(best & 0xffffffffu)
                                     : T;
    occ_out[l] = occ;
  }
}

// An order-preserving image of a (non-NaN) f32 in a signed int, so that
// atomicMin on the images takes the f32 minimum, and its inverse.
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float from_ordered(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

// One block a scenario lane (blockIdx.x; one lane but for the lane form),
// over the lane's row of the [L, C] candidates and its outputs.  Shared
// memory: the S + 1 segment offsets, then the
// per-segment ordered minimum, ordered safe minimum and due count.  A
// thread takes candidates i = tid, tid + blockDim, ..., kFrontierLoads at
// a time (loads in flight together), keeps running values for the
// segment its candidate lies in, and folds them into that segment's
// shared entry when it moves on to a later segment, and at the end.
__global__ void __launch_bounds__(kFrontierThreads)
event_frontier_kernel(const float* __restrict__ cand,
                      const float* __restrict__ cuts,
                      const int* __restrict__ off, int S, int C,
                      float* __restrict__ t_star_out, bool* __restrict__ fired,
                      int* __restrict__ counts, float* __restrict__ t_safe_out,
                      float* __restrict__ mins) {
  {
    const size_t lane = blockIdx.x;
    cand += lane * C;
    if (cuts != nullptr) cuts += lane * C;
    fired += lane * S;
    counts += lane * S;
    mins += lane * S;
    t_star_out += lane;
    t_safe_out += lane;
  }
  extern __shared__ int fsm[];
  int* soff = fsm;              // [S + 1]
  int* smin = fsm + S + 1;      // [S]
  int* ssafe = smin + S;        // [S]
  int* scount = ssafe + S;      // [S]
  const int inf_o = ordered(INFINITY);
  for (int q = threadIdx.x; q <= S; q += blockDim.x) soff[q] = off[q];
  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    smin[q] = inf_o;
    ssafe[q] = inf_o;
    scount[q] = 0;
  }
  __syncthreads();
  constexpr int kStride = kFrontierThreads;
  constexpr int kSpan = kFrontierLoads * kStride;

  // pass 1: each segment's minimum and minimum horizon-cutting candidate
  int s = 0;
  float mn = INFINITY, sf = INFINITY;
  for (int base = threadIdx.x; base < C; base += kSpan) {
    float c[kFrontierLoads], cut[kFrontierLoads];
#pragma unroll
    for (int u = 0; u < kFrontierLoads; ++u) {
      const int i = base + u * kStride;
      c[u] = i < C ? cand[i] : INFINITY;
      cut[u] = (i < C && (cuts == nullptr || cuts[i] > 0.5f)) ? c[u]
                                                              : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kFrontierLoads; ++u) {
      const int i = base + u * kStride;
      if (i >= C) break;
      if (i >= soff[s + 1]) {
        if (mn < INFINITY) atomicMin(&smin[s], ordered(mn));
        if (sf < INFINITY) atomicMin(&ssafe[s], ordered(sf));
        mn = sf = INFINITY;
        do ++s; while (i >= soff[s + 1]);
      }
      mn = fminf(mn, c[u]);
      sf = fminf(sf, cut[u]);
    }
  }
  if (mn < INFINITY) atomicMin(&smin[s], ordered(mn));
  if (sf < INFINITY) atomicMin(&ssafe[s], ordered(sf));
  __syncthreads();

  float t_star = INFINITY;
  for (int q = 0; q < S; ++q) t_star = fminf(t_star, from_ordered(smin[q]));
  // pass 2: each segment's candidates due at t*
  s = 0;
  int due = 0;
  for (int base = threadIdx.x; base < C; base += kSpan) {
    float c[kFrontierLoads];
#pragma unroll
    for (int u = 0; u < kFrontierLoads; ++u) {
      const int i = base + u * kStride;
      c[u] = i < C ? cand[i] : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kFrontierLoads; ++u) {
      const int i = base + u * kStride;
      if (i >= C) break;
      if (i >= soff[s + 1]) {
        if (due) atomicAdd(&scount[s], due);
        due = 0;
        do ++s; while (i >= soff[s + 1]);
      }
      due += (c[u] <= t_star && c[u] < INFINITY) ? 1 : 0;
    }
  }
  if (due) atomicAdd(&scount[s], due);
  __syncthreads();

  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    const float m = from_ordered(smin[q]);
    mins[q] = m;
    counts[q] = scount[q];
    fired[q] = isfinite(m) && m <= t_star;
  }
  if (threadIdx.x == 0) {
    float t_safe = INFINITY;
    for (int q = 0; q < S; ++q) t_safe = fminf(t_safe, from_ordered(ssafe[q]));
    *t_star_out = t_star;
    *t_safe_out = t_safe;
  }
}

// `_wave_matrices`, entry (i, l) of wave matrix p: the identity but for
// row p = (-A[v,p]/d for v < p, 0, srem_p/d), d = max(A[p,p], 1e-30),
// clipped to +-BIG.  A[w,p] is the wave-w share of rank p: nonzero iff
// w <= p < occ.
__device__ __forceinline__ float slab_wave(int p, int i, int l, int K,
                                           int occ, float g,
                                           const RowMask& rm, float mips_r,
                                           const float* hrem) {
  float val = i == l ? 1.0f : 0.0f;
  if (i == p) {
    const float a_pp =
        p < occ ? Fig8Row(__fsub_rn(g, static_cast<float>(p)), rm.npe_e,
                          rm.pol, mips_r).rate(0.0f)
                : 0.0f;
    const float d = fmaxf(a_pp, 1e-30f);
    if (l == K) {
      val = __fdiv_rn(p < occ ? hrem[p] : 0.0f, d);
    } else if (l < p) {
      const float a_lp =
          p < occ ? Fig8Row(__fsub_rn(g, static_cast<float>(l)), rm.npe_e,
                            rm.pol, mips_r).rate(static_cast<float>(p - l))
                  : 0.0f;
      val = __fdiv_rn(-a_lp, d);
    } else {
      val = 0.0f;
    }
    val = val < -kBig ? -kBig : (val > kBig ? kBig : val);
  }
  return val;
}

// The Pallas body's balanced tree composes pairs (a, b) -> b @ a, an odd
// level padded with the identity; each entry an FMA chain over the inner
// index from +0.  Entry (i, l) of pair pr of the level of n (M x M)
// matrices at src.
__device__ __forceinline__ float slab_compose(const float* src, int n,
                                              int pr, int i, int l, int M) {
  const size_t mm = static_cast<size_t>(M) * M;
  const float* a = src + 2 * pr * mm;
  const bool pad = 2 * pr + 1 >= n;
  const float* b = a + mm;
  float acc = 0.0f;
  for (int jj = 0; jj < M; ++jj) {
    const float bv = pad ? (i == jj ? 1.0f : 0.0f) : b[i * M + jj];
    acc = fmaf(bv, a[jj * M + l], acc);
  }
  return acc;
}

// The block's threads striding over the entries of matrices of MM
// entries each, all at once: this thread's matrix p and entry x, stepped
// without a division (a 64-bit divide an entry costs the workspace's
// compose steps more than half again).
struct EntryWalk {
  int p, x;
  const int sp, sx, MM;
  __device__ explicit EntryWalk(int mm)
      : p(threadIdx.x / mm), x(threadIdx.x % mm), sp(blockDim.x / mm),
        sx(blockDim.x % mm), MM(mm) {}
  __device__ size_t at() const { return static_cast<size_t>(p) * MM + x; }
  __device__ void next() {
    p += sp;
    x += sx;
    if (x >= MM) {
      x -= MM;
      ++p;
    }
  }
};

// `_slab_waves_assoc(tree=True)` for one row: the K wave matrices in
// bank_a [K][M][M] (M = K + 1), composed in the balanced tree through
// bank_b [ceil(K/2)][M][M] right after it, then the composite's last
// column clamped and summed with XLA:CPU's cumsum into the row's
// outputs.  The banks are in shared memory or, past the shared-memory
// limit, in the workspace; each call site passes its own bank, so the
// compiler keeps shared pointers in the shared space.
__device__ __forceinline__ void slab_assoc(float* bank_a, int K, int J,
                                           int occ, float g,
                                           const RowMask& rm, float mips_r,
                                           const float* hrem,
                                           const int* hcol, float* t_row,
                                           int* c_row) {
  const int M = K + 1, MM = M * M;
  for (EntryWalk e(MM); e.p < K; e.next())
    bank_a[e.at()] = slab_wave(e.p, e.x / M, e.x % M, K, occ, g, rm, mips_r,
                               hrem);
  __syncthreads();
  float* src = bank_a;
  float* dst = bank_a + static_cast<size_t>(K) * MM;
  for (int n = K; n > 1; n = (n + 1) / 2) {
    for (EntryWalk e(MM); e.p < (n + 1) / 2; e.next())
      dst[e.at()] = slab_compose(src, n, e.p, e.x / M, e.x % M, M);
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  // dt = max(comp[:K, K], 0) on existing waves, then XLA:CPU's cumsum
  // (tiles of 16 left to right, tile totals scanned, offsets added)
  if (threadIdx.x == 0) {
    float prefix = 0.0f;   // running scan of the tile totals
    for (int t0 = 0; t0 < K; t0 += 16) {
      float acc = 0.0f;
      for (int p = t0; p < min(t0 + 16, K); ++p) {
        const float dt = p < occ ? fmaxf(src[p * M + K], 0.0f) : 0.0f;
        acc = __fadd_rn(acc, dt);
        const float cum = t0 == 0 ? acc : __fadd_rn(acc, prefix);
        t_row[p] = p < occ ? cum : kBig;
        c_row[p] = p < occ ? hcol[p] : J;
      }
      prefix = t0 == 0 ? acc : __fadd_rn(prefix, acc);
    }
  }
}

// One block per resource row: the next K completions of the row.  Shared
// memory (`slab_smem`): key, tkey [J]; the heads' remaining and column
// [KH], KH = min(K, J) (a row has at most J heads); for assoc, two banks
// of (K+1)^2 matrices (K, then ceil(K/2)), here or, when `work` is not
// null, in work's [R][K + ceil(K/2)][K+1][K+1]; then the sort's idx [n]
// u16, n the power of two >= J.
__global__ void __launch_bounds__(kScanThreads)
event_scan_slab_kernel(const float* __restrict__ rem,
                       const float* __restrict__ tie,
                       const float* __restrict__ mips,
                       const float* __restrict__ npe,
                       const float* __restrict__ pol,
                       const float* __restrict__ blk,
                       const float* __restrict__ ok,
                       float* __restrict__ t_out, int* __restrict__ col_out,
                       float* __restrict__ work, int J, int n, int K,
                       int assoc) {
  extern __shared__ float smem[];
  const int KH = min(K, J);
  float* key = smem;
  float* tkey = smem + J;
  float* hrem = smem + 2 * J;                       // [KH]
  int* hcol = reinterpret_cast<int*>(hrem + KH);    // [KH]
  const int MM = (K + 1) * (K + 1);
  const int n_mats = assoc ? K + (K + 1) / 2 : 0;
  // offsets from shared pointers only, so that the compiler keeps them
  // in the shared space
  unsigned short* idx = reinterpret_cast<unsigned short*>(   // [n]
      hrem + 2 * KH + (work == nullptr ? n_mats * MM : 0));
  __shared__ int redi[32];

  const int r = blockIdx.x;
  const size_t row = static_cast<size_t>(r) * J;
  const RowMask rm(npe, pol, blk, ok, r);
  const int occ = row_keys(TableIn{rem, tie, nullptr, nullptr, 0}, row, J,
                           rm.dead, key, tkey, redi);
  const float g = static_cast<float>(occ);
  const float mips_r = mips[r];

  // heads: the rank-p valid slot, idx[p], for p < min(occ, K) (valid
  // slots key below BIG and sort first); absent ranks read as remaining
  // 0, column 0 (the reference's empty sums)
  sort_row(key, tkey, J, n, idx);
  for (int p = threadIdx.x; p < KH; p += blockDim.x) {
    const bool has = p < occ;
    hrem[p] = has ? key[idx[p]] : 0.0f;
    hcol[p] = has ? static_cast<int>(idx[p]) : 0;
  }
  __syncthreads();
  float* t_row = t_out + static_cast<size_t>(r) * K;
  int* c_row = col_out + static_cast<size_t>(r) * K;

  if (!assoc) {
    // `_slab_waves` on the heads alone: wave w completes head w and
    // advances the later heads at their wave-w shares
    if (threadIdx.x == 0) {
      float t_acc = 0.0f;
      for (int w = 0; w < K; ++w) {
        if (w >= occ) {
          t_row[w] = kBig;
          c_row[w] = J;
          continue;
        }
        const Fig8Row fw(__fsub_rn(g, static_cast<float>(w)), rm.npe_e,
                         rm.pol, mips_r);
        const float dt = __fdiv_rn(hrem[w], fmaxf(fw.rate(0.0f), 1e-30f));
        t_acc = __fadd_rn(t_acc, dt);
        t_row[w] = t_acc;
        c_row[w] = hcol[w];
        for (int p = w + 1; p < min(occ, K); ++p) {
          const float rate = fw.rate(static_cast<float>(p - w));
          hrem[p] = fmaxf(fmaf(-rate, dt, hrem[p]), 0.0f);
        }
      }
    }
    return;
  }

  if (work == nullptr)
    slab_assoc(hrem + 2 * KH, K, J, occ, g, rm, mips_r, hrem, hcol, t_row,
               c_row);
  else
    slab_assoc(work + static_cast<size_t>(r) * n_mats * MM, K, J, occ, g,
               rm, mips_r, hrem, hcol, t_row, c_row);
}

}  // namespace

// The power of two the fresh rank's sort runs over: the least n >= J.
static size_t sort_width(int J) {
  size_t n = 1;
  while (n < static_cast<size_t>(J)) n <<= 1;
  return n;
}

// One limit per kernel, shared by the launchers that launch it.
static size_t scan_smem_allowed = kDefaultSmem;
static size_t check_smem_allowed = kDefaultSmem;

extern "C" int event_scan_launch(const float* rem, const float* tie,
                                 const float* mips, const float* npe,
                                 const float* pol, const float* blk,
                                 const float* ok, const float* rank_in,
                                 float* rate, float* tmin, int* amin,
                                 int* occ, float* rank_out, int R, int J,
                                 void* stream) {
  const size_t n = sort_width(J);
  const size_t smem = 2 * static_cast<size_t>(J) * sizeof(float) +
                      (rank_in == nullptr ? n * sizeof(unsigned short) : 0);
  const cudaError_t err =
      allow_smem(event_scan_kernel, smem, &scan_smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  event_scan_kernel<<<R, kScanThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      TableIn{rem, tie, nullptr, nullptr, 0},
      RowIn{mips, npe, pol, blk, ok}, rank_in, nullptr, nullptr, nullptr,
      nullptr, 1, rate, tmin, amin, occ, rank_out, R, J,
      static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// The checked form: the table gathered from the slot map rg [R, J] and
// the gridlets' remaining g_rem [N]; carry [R, J] and *slab_ok the
// carried rank and its flag; flags [R] int scratch; *n_reseeds the
// device counter; rank_out gets the rank used (never the carry itself).
static int checked_launch(const int* rg, const float* g_rem, int n_gridlets,
                          const float* mips, const float* npe,
                          const float* pol, const float* blk,
                          const float* ok, const float* carry,
                          const bool* slab_ok, int* flags, int* n_reseeds,
                          bool* use_out, int reseed, float* rate,
                          float* tmin, int* amin, int* occ, float* rank_out,
                          int L, int R, int J, void* stream) {
  const size_t n = sort_width(J);
  const size_t keys = 2 * static_cast<size_t>(J) * sizeof(float);
  const size_t smem = keys + n * sizeof(unsigned short);
  cudaError_t err =
      allow_smem(event_scan_check_kernel, keys, &check_smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(event_scan_kernel, smem, &scan_smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TableIn in{nullptr, nullptr, rg, g_rem, n_gridlets};
  const RowIn rows{mips, npe, pol, blk, ok};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(R, L);
  event_scan_check_kernel<<<grid, kScanThreads, keys, s>>>(
      in, rows, carry, slab_ok, flags, R, J);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  event_scan_kernel<<<grid, kScanThreads, smem, s>>>(
      in, rows, carry, flags, slab_ok, n_reseeds, use_out, reseed, rate,
      tmin, amin, occ, rank_out, R, J, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int event_scan_checked_launch(
    const int* rg, const float* g_rem, int n_gridlets, const float* mips,
    const float* npe, const float* pol, const float* blk, const float* ok,
    const float* carry, const bool* slab_ok, int* flags, int* n_reseeds,
    float* rate, float* tmin, int* amin, int* occ, float* rank_out, int R,
    int J, void* stream) {
  return checked_launch(rg, g_rem, n_gridlets, mips, npe, pol, blk, ok,
                        carry, slab_ok, flags, n_reseeds, nullptr, 1, rate,
                        tmin, amin, occ, rank_out, 1, R, J, stream);
}

// The checked form over L scenario lanes: rg [L, R, J], g_rem [L, N],
// the row inputs [L, R], carry and rank_out [L, R, J], slab_ok and use_out
// [L], flags [L, R] int scratch, the other outputs [L, R] (a lane's rows
// contiguous); `reseed` 0: every lane scans with its carry.
extern "C" int event_scan_checked_lanes_launch(
    const int* rg, const float* g_rem, int n_gridlets, const float* mips,
    const float* npe, const float* pol, const float* blk, const float* ok,
    const float* carry, const bool* slab_ok, int* flags, bool* use_out,
    int reseed, float* rate, float* tmin, int* amin, int* occ,
    float* rank_out, int L, int R, int J, void* stream) {
  return checked_launch(rg, g_rem, n_gridlets, mips, npe, pol, blk, ok,
                        carry, slab_ok, flags, nullptr, use_out, reseed,
                        rate, tmin, amin, occ, rank_out, L, R, J, stream);
}

// The public form passes tie and cap (or a null cap), the engine form lg
// and the trunk vectors (or a null trunk_of); L rows of T slots.
extern "C" int link_scan_launch(const float* rem, const float* tie,
                                const int* lg, const float* baud,
                                const float* bg, const float* cap,
                                const int* trunk_of, const float* trunk_baud,
                                const float* trunk_bg, float* rate,
                                float* tmin, int* amin, int* occ, int L,
                                int T, void* stream) {
  link_scan_kernel<<<L, kLinkThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      LinkIn{rem, tie, lg},
      LinkRows{baud, bg, cap, trunk_of, trunk_baud, trunk_bg}, rate, tmin,
      amin, occ, T);
  return static_cast<int>(cudaGetLastError());
}

// One block a lane; outputs t_star and t_safe [L], fired (bool), counts
// and mins [L, S]; cand (and cuts, or null) [L, C]; off [S + 1] the
// segment offsets every lane shares, C = off[S].
extern "C" int event_frontier_lanes_launch(const float* cand,
                                           const float* cuts, const int* off,
                                           int S, int C, int L, float* t_star,
                                           bool* fired, int* counts,
                                           float* t_safe, float* mins,
                                           void* stream) {
  static size_t allowed = kDefaultSmem;
  const size_t smem = (4 * static_cast<size_t>(S) + 1) * sizeof(int);
  const cudaError_t err = allow_smem(event_frontier_kernel, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  event_frontier_kernel<<<L, kFrontierThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      cand, cuts, off, S, C, t_star, fired, counts, t_safe, mins);
  return static_cast<int>(cudaGetLastError());
}

// The one-lane form: outputs t_star and t_safe [1], fired, counts and
// mins [S].
extern "C" int event_frontier_launch(const float* cand, const float* cuts,
                                     const int* off, int S, int C,
                                     float* t_star, bool* fired, int* counts,
                                     float* t_safe, float* mins,
                                     void* stream) {
  return event_frontier_lanes_launch(cand, cuts, off, S, C, 1, t_star, fired,
                                     counts, t_safe, mins, stream);
}

// The slab kernel's shared memory (its layout above), with the wave
// matrices' banks or without them (`banks` 0: sequential, or in `work`).
static size_t slab_smem(int J, int K, int banks) {
  const size_t mm = static_cast<size_t>(K + 1) * (K + 1);
  const size_t kh = static_cast<size_t>(K < J ? K : J);
  return (2 * static_cast<size_t>(J) + 2 * kh +
          (banks ? (K + (K + 1) / 2) * mm : 0)) * sizeof(float) +
         sort_width(J) * sizeof(unsigned short);
}

// The largest K whose associative slab, wave matrices included, fits in
// the card's shared memory at this J; 0 when none does; a negative CUDA
// error code if the card cannot be asked.  Larger K take a workspace.
extern "C" int event_scan_slab_max_k(int J) {
  size_t limit = 0;
  const cudaError_t err = repro_torch::smem_limit(&limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int k = 0;
  while (slab_smem(J, k + 1, 1) <= limit) ++k;
  return k;
}

// `work`: null, or (assoc) a [R][K + ceil(K/2)][K+1][K+1] f32 workspace
// for the wave matrices.
extern "C" int event_scan_slab_launch(const float* rem, const float* tie,
                                      const float* mips, const float* npe,
                                      const float* pol, const float* blk,
                                      const float* ok, float* t_out,
                                      int* col_out, float* work, int R,
                                      int J, int K, int assoc,
                                      void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = slab_smem(J, K, assoc && work == nullptr);
  static size_t allowed = kDefaultSmem;
  const cudaError_t err = allow_smem(event_scan_slab_kernel, smem, &allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  event_scan_slab_kernel<<<R, kScanThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      rem, tie, mips, npe, pol, blk, ok, t_out, col_out, work, J,
      static_cast<int>(sort_width(J)), K, assoc);
  return static_cast<int>(cudaGetLastError());
}
