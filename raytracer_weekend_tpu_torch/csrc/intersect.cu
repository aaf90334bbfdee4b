// Closest-hit kernels of the staged path, one thread per ray: K10 (moving
// spheres), K11 (axis-aligned rects) and K12 (triangles).
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
// Design: the table is read in tiles of kTile rows, staged through shared
// memory by the whole block (SoA, one row of the table per shared array),
// so a table of any length loops over tiles: the TPU kernel's VMEM caps
// (8,192 spheres, 16,384 rects or triangles) are not carried over. The
// winner is kept in registers and updated only on a strict t < best.
//
// What bounds it on an H100: FP32 throughput. Per ray-primitive pair K10 does
// about 40 operations, K11 about 30 (with the compares) and K12 about 45
// (the JAX CostEstimates); the bytes are the rays once and the outputs once
// (the table is read once per block from L2). A frame of jumpy_balls (1.44M
// rays, 486 spheres) is ~2.8e10 operations, ~0.42 ms at 67 TFLOP/s.
#include <cuda_runtime.h>
#include <math.h>

namespace rtw {
namespace isect {

constexpr int kBlock = 256;
constexpr int kTile = 256;

// Sphere rows (ops/cuda/sphere_intersect.py: TABLE_ROWS).
enum SRow {
  S_C0X, S_C0Y, S_C0Z, S_DCX, S_DCY, S_DCZ, S_T0, S_DT, S_R2,
  S_C0SQ, S_C0DC, S_DCSQ, S_VALID, kSRows
};
// Rect rows (ops/cuda/rect_intersect.py: TABLE_ROWS).
enum RRow { R_AXIS, R_K, R_A0, R_A1, R_B0, R_B1, R_VALID, kRRows };
// Triangle rows (ops/cuda/triangle_intersect.py: TABLE_ROWS).
enum TRow {
  T_NX, T_NY, T_NZ, T_ABX, T_ABY, T_ABZ, T_ACX, T_ACY, T_ACZ,
  T_ACV0X, T_ACV0Y, T_ACV0Z, T_ABV0X, T_ABV0Y, T_ABV0Z, T_V0N, T_VALID,
  kTRows
};

// a . b as a float32 GEMM of depth 3 accumulates it.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// Stages rows [base, base + m) of a (kRows x n) SoA table into shared memory.
template <int kRows>
__device__ __forceinline__ void load_tile(const float* __restrict__ tab,
                                          int n, int base, int m,
                                          float (*sh)[kTile]) {
  for (int j = threadIdx.x; j < kRows * kTile; j += kBlock) {
    const int r = j / kTile, c = j - r * kTile;
    if (c < m) sh[r][c] = tab[(long long)r * n + base + c];
  }
}

__global__ void __launch_bounds__(kBlock)
hit_spheres_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ time,
                   const float* __restrict__ ray_sc,  // (B, 3): |d|^2, o.d, |o|^2
                   int n, const float* __restrict__ tab, int S, float t_min,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float sh[kSRows][kTile];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tm = 0.f, a = 1.f, od = 0.f, oo = 0.f;
  if (live) {
    ox = o[3 * i + 0]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i + 0]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tm = time[i];
    a = ray_sc[3 * i + 0]; od = ray_sc[3 * i + 1]; oo = ray_sc[3 * i + 2];
  }
  const float inv_a = __fdiv_rn(1.0f, a);
  float best = INFINITY;
  int bi = 0;
  for (int base = 0; base < S; base += kTile) {
    const int m = min(kTile, S - base);
    __syncthreads();
    load_tile<kSRows>(tab, S, base, m, sh);
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < m; ++c) {
      const float w = __fdiv_rn(__fsub_rn(tm, sh[S_T0][c]), sh[S_DT][c]);
      const float o_c0 = dot3(ox, oy, oz, sh[S_C0X][c], sh[S_C0Y][c],
                              sh[S_C0Z][c]);
      const float o_dc = dot3(ox, oy, oz, sh[S_DCX][c], sh[S_DCY][c],
                              sh[S_DCZ][c]);
      const float d_c0 = dot3(dx, dy, dz, sh[S_C0X][c], sh[S_C0Y][c],
                              sh[S_C0Z][c]);
      const float d_dc = dot3(dx, dy, dz, sh[S_DCX][c], sh[S_DCY][c],
                              sh[S_DCZ][c]);
      const float d_dot_c = __fadd_rn(d_c0, __fmul_rn(w, d_dc));
      const float o_dot_c = __fadd_rn(o_c0, __fmul_rn(w, o_dc));
      const float c_sq = __fadd_rn(
          __fadd_rn(sh[S_C0SQ][c], __fmul_rn(__fmul_rn(2.0f, w), sh[S_C0DC][c])),
          __fmul_rn(__fmul_rn(w, w), sh[S_DCSQ][c]));
      const float half_b = __fsub_rn(od, d_dot_c);
      const float c_term = __fsub_rn(
          __fadd_rn(__fsub_rn(oo, __fmul_rn(2.0f, o_dot_c)), c_sq),
          sh[S_R2][c]);
      const float disc = __fsub_rn(__fmul_rn(half_b, half_b),
                                   __fmul_rn(a, c_term));
      const bool has_roots = disc > 0.0f;
      const float sqrtd = __fsqrt_rn(has_roots ? disc : 1.0f);
      const float root1 = __fmul_rn(__fsub_rn(-half_b, sqrtd), inv_a);
      const float root2 = __fmul_rn(__fadd_rn(-half_b, sqrtd), inv_a);
      const float root = root1 >= t_min ? root1 : root2;
      const bool hit = has_roots && root >= t_min && sh[S_VALID][c] > 0.0f;
      if (hit && root < best) {
        best = root;
        bi = base + c;
      }
    }
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = bi;
  }
}

__global__ void __launch_bounds__(kBlock)
hit_rects_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 int n, const float* __restrict__ tab, int R, float t_min,
                 float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float sh[kRRows][kTile];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float oc[3] = {0.f, 0.f, 0.f}, dc[3] = {0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      oc[k] = o[3 * i + k];
      dc[k] = d[3 * i + k];
    }
  }
  float best = INFINITY;
  int bi = 0;
  for (int base = 0; base < R; base += kTile) {
    const int m = min(kTile, R - base);
    __syncthreads();
    load_tile<kRRows>(tab, R, base, m, sh);
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < m; ++c) {
      // Fixed axis f; in-plane axes (a, b): YZ (y, z), XZ (x, z), XY (x, y).
      const int f = (int)sh[R_AXIS][c];
      const float o_f = f == 0 ? oc[0] : (f == 1 ? oc[1] : oc[2]);
      const float d_f = f == 0 ? dc[0] : (f == 1 ? dc[1] : dc[2]);
      const float o_a = f == 0 ? oc[1] : oc[0];
      const float d_a = f == 0 ? dc[1] : dc[0];
      const float o_b = f == 2 ? oc[1] : oc[2];
      const float d_b = f == 2 ? dc[1] : dc[2];
      const float t = __fdiv_rn(__fsub_rn(sh[R_K][c], o_f), d_f);
      const float av = __fadd_rn(o_a, __fmul_rn(t, d_a));
      const float bv = __fadd_rn(o_b, __fmul_rn(t, d_b));
      const bool hit = t >= t_min && av >= sh[R_A0][c] && av <= sh[R_A1][c] &&
                       bv >= sh[R_B0][c] && bv <= sh[R_B1][c] &&
                       sh[R_VALID][c] > 0.0f;
      if (hit && t < best) {
        best = t;
        bi = base + c;
      }
    }
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = bi;
  }
}

__global__ void __launch_bounds__(kBlock)
hit_triangles_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ w,  // (B, 3): o x d
                     int n, const float* __restrict__ tab, int T, float t_min,
                     float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float sh[kTRows][kTile];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float wx = 0.f, wy = 0.f, wz = 0.f;
  if (live) {
    ox = o[3 * i + 0]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i + 0]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    wx = w[3 * i + 0]; wy = w[3 * i + 1]; wz = w[3 * i + 2];
  }
  float best = INFINITY;
  int bi = 0;
  for (int base = 0; base < T; base += kTile) {
    const int m = min(kTile, T - base);
    __syncthreads();
    load_tile<kTRows>(tab, T, base, m, sh);
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < m; ++c) {
      const float det = -dot3(dx, dy, dz, sh[T_NX][c], sh[T_NY][c],
                              sh[T_NZ][c]);
      const float u_num = __fsub_rn(
          dot3(wx, wy, wz, sh[T_ACX][c], sh[T_ACY][c], sh[T_ACZ][c]),
          dot3(dx, dy, dz, sh[T_ACV0X][c], sh[T_ACV0Y][c], sh[T_ACV0Z][c]));
      const float v_num = -__fsub_rn(
          dot3(wx, wy, wz, sh[T_ABX][c], sh[T_ABY][c], sh[T_ABZ][c]),
          dot3(dx, dy, dz, sh[T_ABV0X][c], sh[T_ABV0Y][c], sh[T_ABV0Z][c]));
      const float t_num = __fsub_rn(
          dot3(ox, oy, oz, sh[T_NX][c], sh[T_NY][c], sh[T_NZ][c]),
          sh[T_V0N][c]);
      const bool degenerate = det == 0.0f;
      const float inv_det = __fdiv_rn(1.0f, degenerate ? 1.0f : det);
      const float u = __fmul_rn(u_num, inv_det);
      const float v = __fmul_rn(v_num, inv_det);
      const float t = __fmul_rn(t_num, inv_det);
      const bool hit = t >= t_min && t >= 0.0f && u >= 0.0f && v >= 0.0f &&
                       __fadd_rn(u, v) <= 1.0f && !degenerate &&
                       sh[T_VALID][c] > 0.0f;
      if (hit && t < best) {
        best = t;
        bi = base + c;
      }
    }
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = bi;
  }
}

inline int blocks(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace isect
}  // namespace rtw

extern "C" {

// K10: closest sphere of the (13 x S) table for n rays on `stream`.
// Returns cudaGetLastError() after the launch; it does not sync.
int rtw_hit_spheres(const float* o, const float* d, const float* time,
                    const float* ray_sc, int n, const float* tab, int S,
                    float t_min, float* t_out, int* idx_out, void* stream) {
  using namespace rtw::isect;
  if (n <= 0) return 0;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  hit_spheres_kernel<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
      o, d, time, ray_sc, n, tab, S, t_min, t_out, idx_out);
  return (int)cudaGetLastError();
}

// K11: closest rect of the (7 x R) table for n rays on `stream`.
int rtw_hit_rects(const float* o, const float* d, int n, const float* tab,
                  int R, float t_min, float* t_out, int* idx_out,
                  void* stream) {
  using namespace rtw::isect;
  if (n <= 0) return 0;
  if (R <= 0) return (int)cudaErrorInvalidValue;
  hit_rects_kernel<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
      o, d, n, tab, R, t_min, t_out, idx_out);
  return (int)cudaGetLastError();
}

// K12: closest triangle of the (17 x T) table for n rays on `stream`.
int rtw_hit_triangles(const float* o, const float* d, const float* w, int n,
                      const float* tab, int T, float t_min, float* t_out,
                      int* idx_out, void* stream) {
  using namespace rtw::isect;
  if (n <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  hit_triangles_kernel<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(
      o, d, w, n, tab, T, t_min, t_out, idx_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
