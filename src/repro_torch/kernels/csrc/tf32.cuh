// 3xTF32 building blocks shared by the kernel sources of this directory:
// an f32 product at f32 accuracy as three TF32 tensor-core products.
// Each f32 operand v is split as big = cvt.rna.tf32(v), small =
// cvt.rna.tf32(v - big); a product is big.big + big.small + small.big,
// accumulated in f32.  The dropped small.small term and the rounding of
// small are each ~2^-22 of |v|, so a product errs by ~2^-21 relative,
// where one TF32 product errs by ~2^-11.
#pragma once

#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, both TF32, big the TF32 nearest v
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(v);
  small = tf32(__fsub_rn(v, __uint_as_float(big)));
}

// d += a b: one m16n8k8 TF32 tensor-core product, f32 accumulate (not
// volatile: the compiler may schedule it among independent work).
// Fragments (lane = 4 g + t): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro_torch
