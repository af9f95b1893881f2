// 3xTF32 on the tensor cores: an f32-accurate product from TF32 MMAs, for
// sm_90a. Shared by gmm.cu (gmm_tc) and flash_attention.cu.
//
// Each f32 operand v is split into hi + lo, and each product a b is taken
// as a_lo b_hi + a_hi b_lo + a_hi b_hi (three mma.sync.m16n8k8 TF32 issues
// with f32 accumulation, the small terms first); the dropped a_lo b_lo is
// below f32 rounding. An MMA adds into its accumulator with truncation, so
// a caller accumulates each 32-deep slice of a contraction from zero and
// adds the slices in f32 (gmm_tc's and flash's notes).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// v ~ hi + lo. hi is v rounded to TF32, to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives, done here with an integer add and
// mask (a conversion instruction issues at a fraction of the integer rate,
// and the split runs for every element of every fragment). lo = v - hi is
// exact in f32 and goes to the MMA as it is: a .tf32 operand is read from
// its top 19 bits, so lo is rounded toward zero there, an error of at most
// 2^-21 |v| (the f32 product's rounding is 2^-24 per term).
// Non-finite inputs: the add can carry a NaN's payload into its exponent or
// sign (hi may come out 0, Inf or finite), but v - hi is then the canonical
// NaN, so lo keeps the NaN and every output it reaches is NaN. An Inf gives
// hi = Inf and lo = Inf - Inf = NaN, so an output an Inf reaches is NaN
// where the f32 product has +-Inf; a finite v within half a TF32 step of
// the f32 maximum rounds to hi = Inf, as with cvt.rna. A caller that must
// keep the f32 product's Inf repairs it outside the hot loop (gmm_tc
// recomputes a tile that holds a NaN in plain f32).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a b for one m16n8k8 tile, TF32 inputs, f32 accumulation. With
// g = lane / 4 and t = lane % 4: a holds A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]; b holds B[t][g], B[t + 4][g]; c holds C[g][2t],
// C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
