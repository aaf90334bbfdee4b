// Closest-hit kernels of the staged path: K10 (moving spheres), K11
// (axis-aligned rects) and K12 (triangles).
//
// Replaces: raytracer_weekend_tpu/ops/pallas/sphere_intersect.py:_kernel
// (K10, through hit_spheres_pallas -> pl.pallas_call), rect_intersect.py:
// _kernel (K11, hit_rects_pallas) and triangle_intersect.py:_kernel (K12,
// hit_triangles_pallas). Each finds, for B rays against a table of
// primitives of one family, the closest accepted hit: t (B,) f32, +inf on a
// miss, and idx (B,) int32, the lowest row among equal t (the TPU kernel's
// iota-min, torch's argmin); a miss leaves idx 0.
//
// The arithmetic is the plain staged version's (ops/sphere.py, ops/rect.py,
// ops/triangle.py), operation for operation, so that the kernel is held to
// it on the card:
//   * K10 evaluates the expanded quadratic, with w = (time - t0) / dt (the
//     plain version divides; the TPU kernel multiplies by 1/dt, one ulp
//     away for a moving sphere), d.c = d.c0 + w d.dc, o.c likewise,
//     |c|^2 = |c0|^2 + (2w) c0.dc + (w w) |dc|^2, half_b = o.d - d.c,
//     c_term = |o|^2 - 2 o.c + |c|^2 - r^2, disc = half_b^2 - |d|^2 c_term,
//     and takes the first root >= t_min, else the second;
//   * K11 computes t = (k - o_f) / d_f on the rect's fixed axis (IEEE
//     division, no guard: a ray parallel to the rect gets +-inf or NaN and
//     misses, every comparison with NaN being false), then the bounds of
//     the two in-plane coordinates;
//   * K12 is Moller-Trumbore in scalar-triple form against per-triangle
//     rows {n, ab, ac, ac x v0, ab x v0, v0.n}, with w = o x d per ray and
//     the det == 0 guard.
// Per-ray scalars (|d|^2, o.d, |o|^2 for K10; w for K12) and per-primitive
// rows come from torch, computed as the plain version computes them; each
// elementwise operation here is one rounded IEEE operation (__fmul_rn,
// __fadd_rn, __fdiv_rn: no contraction into FMAs), and each pairwise dot
// product, a (B,3)x(3,S) matrix product in the plain version, is the FMA
// chain a float32 GEMM computes. No fast math.
//
// What bounds them on an H100: FP32 issue for K10 and K12. Per valid
// ray-primitive pair K10 does 41 operations (an FMA two), and 8 more where
// disc > 0; K12 48 (the numerators and the prefilter), and 12 more for a
// prefilter candidate. K11 (about 30 a pair by the JAX CostEstimate, with
// the compares) meets a few rects a ray in the scenes that reach it
// (cornell_box's 6, the cow's 1): its bytes bound it, the rays read once
// and the outputs written once (the table is read once per block from
// L2), 32 bytes a ray. A frame of jumpy_balls (1.44M rays, 486 spheres)
// is ~2.9e10 operations, ~0.43 ms at 67 TFLOP/s.
//
// All three are designed for what an SM issues, not only for its FP32
// rate: a scalar shared-memory load per table row and pair (13 for K10, 7
// for K11, 17 for K12) and K12's IEEE division 1 / det per pair cost as
// much as the arithmetic. So:
//   * Packed rows. Each primitive is one row of 4 (K10), 2 (K11) or 5
//     (K12) float4 (ops/cuda/{sphere,rect,triangle}_intersect.py:
//     TABLE_ROWS), staged by the whole block into dynamic shared memory by
//     cp.async in tiles of kSphTile, kRectTile or kTriTile rows,
//     double-buffered (the next tile is in flight while the block tests
//     this one; one buffer, staged once for the block's life, when the
//     table fits one tile: cornell_box's rects, the cow's). A pair reads
//     16-byte broadcasts: 4 for K10, 2 for K11, 5 for K12. The rows stay in
//     the table's order: K11's axis branch is the whole warp's, and the
//     strict-< update keeps the lowest row on a tie.
//   * Several rays a thread. A thread of a block of N carries R rays, ray
//     r of the thread at blockIdx * N * R + r * N + threadIdx, so each row
//     read from shared memory feeds R pair tests. Each ray's arithmetic and
//     its strict-< update over the rows in order are those of one thread per
//     ray: the winner is bit for bit the same.
//   * K10 takes the square root and the roots only where disc > 0.
//   * K12's division-free prefilter (tri_candidate). Only a pair that
//     passes it takes __fdiv_rn(1, det) and the exact test of the first
//     design; it passes every pair the exact test accepts (a superset,
//     below), so the winners are unchanged. K11 divides on every valid
//     pair: the planar loop's prefilter (plane_candidate) in front of its
//     one division made it slower on every input measured (PERF.md §6).
// R, the block and the tile are compile-time constants (kSph*, kRect*,
// kTri* below), chosen by a sweep on the card (PERF.md §6): K10 and K11
// two rays a thread, K12 one (at the staged path's 2^18-ray chunks its
// prefilter's arithmetic, not the row loads R shares, bounds it, and one
// ray a thread keeps more warps resident).
#include <cuda_runtime.h>
#include <math.h>

#include "plane_tiles.cuh"

namespace rtw {
namespace isect {

// K10's, K11's and K12's rays a thread, threads a block and rows a shared
// tile.
constexpr int kSphRays = 2, kSphBlock = 64, kSphTile = 64;
constexpr int kRectRays = 2, kRectBlock = 128, kRectTile = 128;
constexpr int kTriRays = 1, kTriBlock = 128, kTriTile = 128;
constexpr int kProbeBlock = 256;  // tri_candidate_kernel's block

// K10's packed row (ops/cuda/sphere_intersect.py: TABLE_ROWS):
// (c0x, c0y, c0z, |c0|^2), (r^2, valid, t0, dt), (dcx, dcy, dcz, c0.dc),
// (|dc|^2, 0, 0, 0).
constexpr int kSphereQ = 4;
// K11's packed row (ops/cuda/rect_intersect.py: TABLE_ROWS):
// (axis, valid, k, 0), (a0, a1, b0, b1).
constexpr int kRectQ = 2;
// K12's packed row (ops/cuda/triangle_intersect.py: TABLE_ROWS):
// (nx, ny, nz, v0.n), (acx, acy, acz, valid),
// (ac x v0, 0), (ab, 0), (ab x v0, 0).
constexpr int kTriQ = 5;

// a . b as a float32 GEMM of depth 3 accumulates it.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// The block's copy of packed rows [base, base + cnt) (kQ float4 each). It
// strides by blockDim.x, not the kernel's compile-time block: with that
// constant nvcc unrolled the copy, and the larger kernel re-derived the
// tile's shared address inside the row loop, 8-11% slower (PERF.md §6).
template <int kQ>
__device__ __forceinline__ void stage_rows(float4* dst,
                                           const float4* __restrict__ src,
                                           int base, int cnt) {
  const float4* from = src + (long long)base * kQ;
  for (int q = threadIdx.x; q < cnt * kQ; q += blockDim.x)
    cp_async16(dst + q, from + q);
}

// Walks a packed table of P rows in tiles of kRows rows, staged in the
// block's dynamic shared memory, the next tile's copy in flight while the
// block tests this one: body(rows, base, cnt) tests rows [base, base + cnt),
// row c at rows + kQ * c. Every thread of the block calls it (barriers).
template <int kQ, int kRows, class Body>
__device__ __forceinline__ void walk_tiles(const float4* __restrict__ tab,
                                           int P, Body&& body) {
  extern __shared__ float4 tiles[];
  const int n_tiles = (P + kRows - 1) / kRows;
  stage_rows<kQ>(tiles, tab, 0, min(kRows, P));
  cp_async_commit();
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int next = (tt + 1) * kRows;
    if (next < P)
      stage_rows<kQ>(tiles + ((tt + 1) & 1) * kRows * kQ, tab, next,
                     min(kRows, P - next));
    cp_async_commit();
    cp_async_wait_prev();  // tile tt has landed (this thread's copies)
    __syncthreads();       // ... and every thread's
    body(tiles + (tt & 1) * kRows * kQ, tt * kRows,
         min(kRows, P - tt * kRows));
    __syncthreads();       // every thread is done with buffer tt & 1
  }
}

// ---- K10 ---------------------------------------------------------------------

struct SphereRay {
  float ox, oy, oz, dx, dy, dz, tm, a, od, oo, inv_a, best;
  int bi;
};

// The roots of a pair with disc > 0, and the strict-< update.
__device__ __forceinline__ void take_root(SphereRay& y, float half_b,
                                          float disc, float t_min, int s) {
  const float sqrtd = __fsqrt_rn(disc);
  const float root1 = __fmul_rn(__fsub_rn(-half_b, sqrtd), y.inv_a);
  const float root2 = __fmul_rn(__fadd_rn(-half_b, sqrtd), y.inv_a);
  const float root = root1 >= t_min ? root1 : root2;
  if (root >= t_min && root < y.best) {
    y.best = root;
    y.bi = s;
  }
}

// A sphere's half_b and disc, the first design's arithmetic: q0 = (c0,
// |c0|^2), q1 = (r^2, valid, t0, dt), q2 = (dc, c0.dc), q3.x = |dc|^2.
__device__ __forceinline__ void sphere_disc(const SphereRay& y, float4 q0,
                                            float4 q1, float4 q2, float4 q3,
                                            float& half_b, float& disc) {
  const float w = __fdiv_rn(__fsub_rn(y.tm, q1.z), q1.w);
  const float o_c0 = dot3(y.ox, y.oy, y.oz, q0.x, q0.y, q0.z);
  const float o_dc = dot3(y.ox, y.oy, y.oz, q2.x, q2.y, q2.z);
  const float d_c0 = dot3(y.dx, y.dy, y.dz, q0.x, q0.y, q0.z);
  const float d_dc = dot3(y.dx, y.dy, y.dz, q2.x, q2.y, q2.z);
  const float d_dot_c = __fadd_rn(d_c0, __fmul_rn(w, d_dc));
  const float o_dot_c = __fadd_rn(o_c0, __fmul_rn(w, o_dc));
  const float c_sq = __fadd_rn(
      __fadd_rn(q0.w, __fmul_rn(__fmul_rn(2.0f, w), q2.w)),
      __fmul_rn(__fmul_rn(w, w), q3.x));
  half_b = __fsub_rn(y.od, d_dot_c);
  const float c_term = __fsub_rn(
      __fadd_rn(__fsub_rn(y.oo, __fmul_rn(2.0f, o_dot_c)), c_sq), q1.x);
  disc = __fsub_rn(__fmul_rn(half_b, half_b), __fmul_rn(y.a, c_term));
}

__global__ void __launch_bounds__(kSphBlock)
hit_spheres_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ time,
                   const float* __restrict__ ray_sc,  // (B, 3): |d|^2, o.d, |o|^2
                   int n, const float4* __restrict__ tab, int S, float t_min,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  constexpr int R = kSphRays;
  const long long first =
      (long long)blockIdx.x * kSphBlock * R + threadIdx.x;
  SphereRay ray[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = first + (long long)r * kSphBlock;
    SphereRay& y = ray[r];
    y = SphereRay{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f,
                  INFINITY, 0};
    if (i < n) {
      y.ox = o[3 * i + 0]; y.oy = o[3 * i + 1]; y.oz = o[3 * i + 2];
      y.dx = d[3 * i + 0]; y.dy = d[3 * i + 1]; y.dz = d[3 * i + 2];
      y.tm = time[i];
      y.a = ray_sc[3 * i + 0];
      y.od = ray_sc[3 * i + 1];
      y.oo = ray_sc[3 * i + 2];
    }
    y.inv_a = __fdiv_rn(1.0f, y.a);
  }
  walk_tiles<kSphereQ, kSphTile>(tab, S, [&](const float4* rows, int base,
                                             int cnt) {
    for (int c = 0; c < cnt; ++c) {
      const float4* q = rows + kSphereQ * c;
      const float4 q1 = q[1];
      if (q1.y == 0.0f) continue;  // an invalid row never hits
      const float4 q0 = q[0], q2 = q[2], q3 = q[3];
      // Every ray's disc first (independent chains the scheduler can
      // interleave), then the roots where disc > 0.
      float half_b[R], disc[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        sphere_disc(ray[r], q0, q1, q2, q3, half_b[r], disc[r]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (disc[r] > 0.0f)
          take_root(ray[r], half_b[r], disc[r], t_min, base + c);
    }
  });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = first + (long long)r * kSphBlock;
    if (i < n) {
      t_out[i] = ray[r].best;
      idx_out[i] = ray[r].bi;
    }
  }
}

// ---- K11 ---------------------------------------------------------------------

struct RectRay {
  float o[3], d[3], best;
  int bi;
};

// One valid rect row against a thread's R rays, its fixed axis F a
// compile-time constant (0: a YZ rect, in-plane axes (a, b) = (y, z); 1:
// XZ, (x, z); 2: XY, (x, y)): the first design's exact test on every ray,
// t = (k - o_f) / d_f by IEEE division, the in-plane bounds, t >= t_min and
// the strict-< update.
template <int F, int R>
__device__ __forceinline__ void rect_row(RectRay (&ray)[R], float k,
                                         const float4 q, int row,
                                         float t_min) {
  constexpr int A = F == 0 ? 1 : 0, B = F == 2 ? 1 : 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    RectRay& y = ray[r];
    const float t = __fdiv_rn(__fsub_rn(k, y.o[F]), y.d[F]);
    const float av = __fadd_rn(y.o[A], __fmul_rn(t, y.d[A]));
    const float bv = __fadd_rn(y.o[B], __fmul_rn(t, y.d[B]));
    if (t >= t_min && av >= q.x && av <= q.y && bv >= q.z && bv <= q.w &&
        t < y.best) {
      y.best = t;
      y.bi = row;
    }
  }
}

__global__ void __launch_bounds__(kRectBlock)
hit_rects_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 int n, const float4* __restrict__ tab, int P, float t_min,
                 float* __restrict__ t_out, int* __restrict__ idx_out) {
  constexpr int R = kRectRays;
  const long long first =
      (long long)blockIdx.x * kRectBlock * R + threadIdx.x;
  RectRay ray[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = first + (long long)r * kRectBlock;
    RectRay& y = ray[r];
    y = RectRay{{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, INFINITY, 0};
    if (i < n) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        y.o[c] = o[3 * i + c];
        y.d[c] = d[3 * i + c];
      }
    }
  }
  walk_tiles<kRectQ, kRectTile>(tab, P, [&](const float4* rows, int base,
                                            int cnt) {
    for (int c = 0; c < cnt; ++c) {
      const float4 q0 = rows[kRectQ * c];  // (axis, valid, k, 0)
      if (!(q0.y > 0.0f)) continue;        // an invalid row never hits
      const float4 q = rows[kRectQ * c + 1];  // (a0, a1, b0, b1)
      // The row, hence its axis, is the whole warp's: a uniform branch.
      const int f = (int)q0.x;
      if (f == 0)
        rect_row<0, R>(ray, q0.z, q, base + c, t_min);
      else if (f == 1)
        rect_row<1, R>(ray, q0.z, q, base + c, t_min);
      else
        rect_row<2, R>(ray, q0.z, q, base + c, t_min);
    }
  });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = first + (long long)r * kRectBlock;
    if (i < n) {
      t_out[i] = ray[r].best;
      idx_out[i] = ray[r].bi;
    }
  }
}

// ---- K12 ---------------------------------------------------------------------

// The exact test below: det != 0, u = RN(u_num * RN(1 / det)) >= 0 (a -0
// from an underflow passes), v likewise, RN(u + v) <= 1, t = RN(t_num *
// RN(1 / det)) >= t_min and t < best. Its division-free prefilter, for
// 2^-40 <= t_min <= 2^40, folds the sign of det into the numerators
// (dp = |det|, tn = t_num sign(det), un, vn likewise). A pair with
// dp > 0 and tn > 0 (else the exact test refuses it too) and dp outside
// [2^-60, 2^60] passes; inside, every bound below is a normal float, 1 / det
// is normal, and t >= t_min keeps t normal, so each rounding errs by at most
// 2^-24 relative, and the pair passes when
//   * tn >= RN(dp RN(t_min (1 - 2^-20))) and tn < RN(dp RN(best (1 +
//     2^-20))) (RN(best (1 + 2^-20)) is kept per ray beside best): t is two
//     roundings of tn / dp, inside the 2^-20 margins (the planar
//     prefilter's, plane_tiles.cuh plane_candidate);
//   * un >= -RN(dp 2^-100), vn likewise: a negative un beyond that has
//     |un| / dp >= 2^-100 and gives u <= -2^-101, never the -0 of an
//     underflow; where dp < 2^-26 makes the bound inexact, any nonzero
//     float32 un has |un| / dp > 2^-123;
//   * RN(un + vn) <= RN(dp (1 + 2^-18)): RN(u + v) <= 1 needs
//     (un + vn) / dp <= 1 + 2^-20 even with u and v rounded (and
//     underflowed to +-0); the sum cannot overflow, dp being <= 2^60.
// So it passes every pair the exact test accepts (a superset). Explicit
// _rn operations; triangle_intersect.py:tri_candidate_plain computes the
// same bits on the CPU.
constexpr float kSumHi = 1.0f + 0x1p-18f;
constexpr float kNegTol = 0x1p-100f;
constexpr float kDetLo = 0x1p-60f, kDetHi = 0x1p60f;
constexpr float kTMinLo = 0x1p-40f, kTMinHi = 0x1p40f;

// tmin_lo = RN(t_min kCandLo), best_hi = RN(best kCandHi).
__device__ __forceinline__ bool tri_candidate(float det, float u_num,
                                              float v_num, float t_num,
                                              float tmin_lo, float best_hi) {
  const float dp = fabsf(det);
  const bool neg = det < 0.0f;
  const float tn = neg ? -t_num : t_num;
  const float un = neg ? -u_num : u_num;
  const float vn = neg ? -v_num : v_num;
  const float lo = __fmul_rn(dp, tmin_lo);
  const float hi = __fmul_rn(dp, best_hi);
  const float neg_tol = __fmul_rn(dp, kNegTol);
  const float sum = __fadd_rn(un, vn);
  const float sum_hi = __fmul_rn(dp, kSumHi);
  const bool wild = (dp < kDetLo) | (dp > kDetHi);
  // Non-short-circuit &, |: compares and no branch.
  return (tn > 0.0f) & (dp > 0.0f) &
         (wild | ((tn >= lo) & (tn < hi) & (un >= -neg_tol) &
                  (vn >= -neg_tol) & (sum <= sum_hi)));
}

struct TriRay {
  float ox, oy, oz, dx, dy, dz, wx, wy, wz, best, best_hi;
  int bi;
};

// kCount adds the pairs that passed the prefilter (each takes the division)
// to *divides.
template <bool kCount>
__global__ void __launch_bounds__(kTriBlock)
hit_triangles_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ w,  // (B, 3): o x d
                     int n, const float4* __restrict__ tab, int T,
                     float t_min, float* __restrict__ t_out,
                     int* __restrict__ idx_out,
                     unsigned long long* __restrict__ divides) {
  constexpr int R = kTriRays;
  const long long first =
      (long long)blockIdx.x * kTriBlock * R + threadIdx.x;
  TriRay ray[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = first + (long long)r * kTriBlock;
    TriRay& y = ray[r];
    y = TriRay{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, INFINITY,
               INFINITY, 0};
    if (i < n) {
      y.ox = o[3 * i + 0]; y.oy = o[3 * i + 1]; y.oz = o[3 * i + 2];
      y.dx = d[3 * i + 0]; y.dy = d[3 * i + 1]; y.dz = d[3 * i + 2];
      y.wx = w[3 * i + 0]; y.wy = w[3 * i + 1]; y.wz = w[3 * i + 2];
    }
  }
  const bool pre = t_min >= kTMinLo && t_min <= kTMinHi;  // its premise
  const float tmin_lo = __fmul_rn(t_min, kCandLo);
  unsigned int n_div = 0;
  walk_tiles<kTriQ, kTriTile>(tab, T, [&](const float4* rows, int base,
                                          int cnt) {
    for (int c = 0; c < cnt; ++c) {
      const float4* q = rows + kTriQ * c;
      const float4 q1 = q[1];
      if (q1.w == 0.0f) continue;  // an invalid row never hits
      const float4 q0 = q[0], q2 = q[2], q3 = q[3], q4 = q[4];
      // Every ray's numerators and prefilter first (independent chains),
      // then the division and the exact test for the candidates.
      float det[R], u_num[R], v_num[R], t_num[R];
      bool cand[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const TriRay& y = ray[r];
        det[r] = -dot3(y.dx, y.dy, y.dz, q0.x, q0.y, q0.z);
        u_num[r] = __fsub_rn(dot3(y.wx, y.wy, y.wz, q1.x, q1.y, q1.z),
                             dot3(y.dx, y.dy, y.dz, q2.x, q2.y, q2.z));
        v_num[r] = -__fsub_rn(dot3(y.wx, y.wy, y.wz, q3.x, q3.y, q3.z),
                              dot3(y.dx, y.dy, y.dz, q4.x, q4.y, q4.z));
        t_num[r] = __fsub_rn(dot3(y.ox, y.oy, y.oz, q0.x, q0.y, q0.z), q0.w);
        cand[r] = !pre || tri_candidate(det[r], u_num[r], v_num[r], t_num[r],
                                        tmin_lo, y.best_hi);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!cand[r]) continue;
        if (kCount) ++n_div;
        TriRay& y = ray[r];
        const bool degenerate = det[r] == 0.0f;
        const float inv_det = __fdiv_rn(1.0f, degenerate ? 1.0f : det[r]);
        const float u = __fmul_rn(u_num[r], inv_det);
        const float v = __fmul_rn(v_num[r], inv_det);
        const float t = __fmul_rn(t_num[r], inv_det);
        const bool hit = t >= t_min && t >= 0.0f && u >= 0.0f && v >= 0.0f &&
                         __fadd_rn(u, v) <= 1.0f && !degenerate;
        if (hit && t < y.best) {
          y.best = t;
          y.best_hi = __fmul_rn(t, kCandHi);
          y.bi = base + c;
        }
      }
    }
  });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = first + (long long)r * kTriBlock;
    if (i < n) {
      t_out[i] = ray[r].best;
      idx_out[i] = ray[r].bi;
    }
  }
  if (kCount && n_div) atomicAdd(divides, (unsigned long long)n_div);
}

// tri_candidate on n independent cases (a probe of its superset property).
__global__ void tri_candidate_kernel(const float* __restrict__ det,
                                     const float* __restrict__ u_num,
                                     const float* __restrict__ v_num,
                                     const float* __restrict__ t_num,
                                     const float* __restrict__ best, int n,
                                     float t_min, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = tri_candidate(det[i], u_num[i], v_num[i], t_num[i],
                           __fmul_rn(t_min, kCandLo),
                           __fmul_rn(best[i], kCandHi)) ? 1 : 0;
}

// One launch of a tiled kernel (kRays rays a thread, kThreads a block) over
// P rows of kQ float4: two tiles of kRows rows of dynamic shared memory, or
// one holding the table when it fits; above the default 48 KB the kernel
// needs the attribute, whose error is returned.
template <int kQ, int kRays, int kThreads, int kRows, class Kernel,
          class... Args>
cudaError_t run_tiled(Kernel kernel, int n, int P, cudaStream_t stream,
                      Args... args) {
  const size_t smem =
      (size_t)(P > kRows ? 2 : 1) * min(kRows, P) * kQ * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long per_block = (long long)kThreads * kRays;
  const int grid = (int)((n + per_block - 1) / per_block);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace isect
}  // namespace rtw

extern "C" {

// K10: closest sphere of the packed (S x 16) table for n rays on `stream`.
// Returns cudaGetLastError() after the launch; it does not sync.
int rtw_hit_spheres(const float* o, const float* d, const float* time,
                    const float* ray_sc, int n, const float* tab, int S,
                    float t_min, float* t_out, int* idx_out, void* stream) {
  using namespace rtw::isect;
  if (n <= 0) return 0;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  return (int)run_tiled<kSphereQ, kSphRays, kSphBlock, kSphTile>(
      hit_spheres_kernel, n, S, (cudaStream_t)stream, o, d, time, ray_sc, n,
      reinterpret_cast<const float4*>(tab), S, t_min, t_out, idx_out);
}

// K11: closest rect of the packed (R x 8) table for n rays on `stream`.
int rtw_hit_rects(const float* o, const float* d, int n, const float* tab,
                  int R, float t_min, float* t_out, int* idx_out,
                  void* stream) {
  using namespace rtw::isect;
  if (n <= 0) return 0;
  if (R <= 0) return (int)cudaErrorInvalidValue;
  return (int)run_tiled<kRectQ, kRectRays, kRectBlock, kRectTile>(
      hit_rects_kernel, n, R, (cudaStream_t)stream, o, d, n,
      reinterpret_cast<const float4*>(tab), R, t_min, t_out, idx_out);
}

// K12: closest triangle of the packed (T x 20) table for n rays on
// `stream`; with a non-null `divides` (one zeroed uint64) it adds there the
// pairs that took the division.
int rtw_hit_triangles(const float* o, const float* d, const float* w, int n,
                      const float* tab, int T, float t_min, float* t_out,
                      int* idx_out, unsigned long long* divides,
                      void* stream) {
  using namespace rtw::isect;
  if (n <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const float4* t4 = reinterpret_cast<const float4*>(tab);
  const cudaStream_t st = (cudaStream_t)stream;
  if (divides != nullptr)
    return (int)run_tiled<kTriQ, kTriRays, kTriBlock, kTriTile>(
        hit_triangles_kernel<true>, n, T, st, o, d, w, n, t4, T, t_min,
        t_out, idx_out, divides);
  return (int)run_tiled<kTriQ, kTriRays, kTriBlock, kTriTile>(
      hit_triangles_kernel<false>, n, T, st, o, d, w, n, t4, T, t_min, t_out,
      idx_out, divides);
}

// K12's prefilter tri_candidate on n (det, u_num, v_num, t_num, best)
// cases at t_min -> out (n,) int32 0/1.
int rtw_tri_candidate(const float* det, const float* u_num,
                      const float* v_num, const float* t_num,
                      const float* best, int n, float t_min, int* out,
                      void* stream) {
  using namespace rtw::isect;
  if (n <= 0) return 0;
  tri_candidate_kernel<<<(n + kProbeBlock - 1) / kProbeBlock, kProbeBlock,
                         0, (cudaStream_t)stream>>>(det, u_num, v_num, t_num,
                                                    best, n, t_min, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
