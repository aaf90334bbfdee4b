// What the planar loops share: the division-free prefilter of a plane test
// and the cp.async helpers that stage rows into shared-memory tiles. Used
// by the forward megakernel's planar tiles (megakernel.cuh, K3) and by the
// staged path's closest-hit kernels (intersect.cu: K12 takes the
// prefilter's margins; K10, K11 and K12 the copies).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rtw {

// The planar test's division-free prefilter. Given 0 < t_min <= best (best
// may be +inf), it passes every row whose IEEE num / den satisfies
// t >= t_min && t < best, and rejects most rows that fail: a row behind the
// ray (num / den <= 0), or nearer than t_min or beyond best by more than
// the margin. With den > 0 (signs folded into np = num * sign(den)),
// RN(np / dp) >= t_min needs np / dp >= t_min (1 - 2^-24), and
// RN(np / dp) < best needs np / dp < best; each rounded product below errs
// by at most 2^-24 relative while it stays normal, so the 2^-20 margins
// cover two roundings, and a bound that fell below 2^-100 (inexact once
// subnormal) or overflowed passes. den = 0, NaN (a padded all-zero row)
// and np <= 0 fail, as the exact test does. Explicit _rn products: nvcc
// contracts nothing here, and megakernel.py:plane_candidate_plain computes
// the same bits on the CPU.
constexpr float kCandLo = 1.0f - 0x1p-20f;
constexpr float kCandHi = 1.0f + 0x1p-20f;
constexpr float kCandTiny = 0x1p-100f;

__device__ __forceinline__ bool plane_candidate(float num, float den,
                                                float t_min, float best) {
  const float dp = fabsf(den);
  const float np = den < 0.f ? -num : num;
  if (!(np > 0.f && dp > 0.f)) return false;
  const float lo = __fmul_rn(__fmul_rn(dp, t_min), kCandLo);
  const float hi = __fmul_rn(__fmul_rn(dp, best), kCandHi);
  return (np >= lo || lo < kCandTiny || lo == INFINITY) &&
         (np < hi || hi < kCandTiny);
}

// cp.async of 16 bytes, global -> shared, bypassing L1 (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace rtw
