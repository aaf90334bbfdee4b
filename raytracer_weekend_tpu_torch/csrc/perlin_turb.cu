// Perlin turbulence (K8) and its vector-Jacobian product (K9), one thread per
// point.
//
// Replaces: raytracer_weekend_tpu/ops/pallas/perlin_turb.py:_kernel and
// _kernel_row (K8, reached through turbulence_pallas -> pl.pallas_call) and
// _vjp_kernel / _vjp_body (K9, through turbulence_vjp_pallas). K8 computes
//     turb(p) = | sum_{k<depth} 0.5^k noise(2^k p) |
// for points p (N, 3) f32 over the gradient table grad (256, 3) f32 and the
// permutation tables perm (3, 256) int32: noise is Hermite-smoothed
// trilinear interpolation of gradient dots over the 8 lattice corners, the
// corner hash perm_x[ix & 255] ^ perm_y[iy & 255] ^ perm_z[iz & 255], with
// the reference quirk that the Hermite-filtered point u (not the raw
// fraction) enters the offset vectors u - corner. The corner order (i-major
// over x, y, z) and every summation order are those of the plain version
// (raytracer_weekend_tpu_torch/perlin.py), so the two agree to rounding of
// the same operations. K9 takes the cotangent ct (N,) of turb and returns
// d_p (N, 3) and d_grad (256, 3): per octave k with weight w = 0.5^k and
// scale s = 2^k,
//     d noise/d u_x = sum_c (+-1) b_y b_z dot_c + blend_c g_c.x  (etc.),
//     d u/d p = 6 f (1 - f) s,   d noise/d g_c = blend_c (u - corner_c),
// times sign(accum) * ct from the |.|; the octave sum is recomputed first
// for that sign.
//
// Liveness: with a non-null `live` (N,) mask a dead point writes turb 0 (K8)
// and d_p 0 and adds nothing to d_grad (K9), inside the kernel. The TPU
// kernel gated whole tiles and left dead rows of a live tile to the caller;
// here no caller needs to zero dead cotangents.
//
// What bounds it on an H100: per live point and octave, 3 floors, 6
// permutation and 8 gradient lookups and 98 FP32 operations, an FMA counted
// as two (K9: 361, the octave recomputed and chained back, and 24
// shared-memory atomics); a live point reads 12 bytes (16 with ct), every
// point reads a mask byte and writes 4 (12 for d_p), so with most points
// dead (a frame's records) the bytes bound it. The lookups read the two
// tables (6 KB) from shared memory, loaded once per block, so each lookup
// is one shared-memory load, not a one-hot product as on the TPU. K9 sums
// d_grad per block in shared memory with shared-memory atomics and adds
// each nonzero entry to global memory once per block.
//
// Numerics: no fast math: floorf, IEEE arithmetic, in the plain version's
// order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtw {
namespace perlin {

constexpr int kBlock = 256;
constexpr int kPC = 256;  // table size

struct Octave {
  float f[3];   // cell-local fraction
  float u[3];   // Hermite-smoothed fraction
  int h[8];     // corner hashes, i-major over (x, y, z)
};

__device__ __forceinline__ void octave_terms(const int* __restrict__ sp,
                                             float x, float y, float z,
                                             Octave& o) {
  const float c[3] = {x, y, z};
  int p0[3], p1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pf = floorf(c[a]);
    const int b = (int)pf;
    o.f[a] = c[a] - pf;
    o.u[a] = o.f[a] * o.f[a] * (3.0f - 2.0f * o.f[a]);
    p0[a] = sp[a * kPC + (b & (kPC - 1))];
    p1[a] = sp[a * kPC + ((b + 1) & (kPC - 1))];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        o.h[i * 4 + j * 2 + k] =
            ((i ? p1[0] : p0[0]) ^ (j ? p1[1] : p0[1]) ^ (k ? p1[2] : p0[2])) &
            (kPC - 1);
}

// noise at the octave's point, from its terms.
__device__ __forceinline__ float noise_of(const float* __restrict__ sg,
                                          const Octave& o) {
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* g = sg + 3 * o.h[i * 4 + j * 2 + k];
        const float bx = i ? o.u[0] : 1.0f - o.u[0];
        const float by = j ? o.u[1] : 1.0f - o.u[1];
        const float bz = k ? o.u[2] : 1.0f - o.u[2];
        const float blend = bx * by * bz;
        const float dot = g[0] * (o.u[0] - (float)i) +
                          g[1] * (o.u[1] - (float)j) +
                          g[2] * (o.u[2] - (float)k);
        total = total + blend * dot;
      }
  return total;
}

__device__ __forceinline__ void load_tables(const float* __restrict__ grad,
                                            const int* __restrict__ perm,
                                            float* sg, int* sp) {
  for (int j = threadIdx.x; j < 3 * kPC; j += kBlock) {
    sg[j] = grad[j];
    sp[j] = perm[j];
  }
}

__device__ __forceinline__ float accum_of(const float* __restrict__ sg,
                                          const int* __restrict__ sp, float x,
                                          float y, float z, int depth) {
  float accum = 0.f, w = 1.0f;
  for (int k = 0; k < depth; ++k) {
    Octave o;
    octave_terms(sp, x, y, z, o);
    accum = accum + w * noise_of(sg, o);
    w *= 0.5f;
    x *= 2.0f;
    y *= 2.0f;
    z *= 2.0f;
  }
  return accum;
}

__global__ void __launch_bounds__(kBlock)
turb_kernel(const float* __restrict__ p, const uint8_t* __restrict__ live,
            const float* __restrict__ grad, const int* __restrict__ perm,
            int n, int depth, float* __restrict__ out) {
  __shared__ float sg[3 * kPC];
  __shared__ int sp[3 * kPC];
  load_tables(grad, perm, sg, sp);
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  if (live && !live[i]) {
    out[i] = 0.f;
    return;
  }
  out[i] = fabsf(accum_of(sg, sp, p[3 * i], p[3 * i + 1], p[3 * i + 2],
                          depth));
}

__global__ void __launch_bounds__(kBlock)
turb_vjp_kernel(const float* __restrict__ p, const float* __restrict__ ct,
                const uint8_t* __restrict__ live,
                const float* __restrict__ grad, const int* __restrict__ perm,
                int n, int depth, float* __restrict__ d_p,
                float* __restrict__ d_grad) {
  __shared__ float sg[3 * kPC];
  __shared__ int sp[3 * kPC];
  __shared__ float sdg[3 * kPC];  // this block's d_grad
  load_tables(grad, perm, sg, sp);
  for (int j = threadIdx.x; j < 3 * kPC; j += kBlock) sdg[j] = 0.f;
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < n) {
    float dpx = 0.f, dpy = 0.f, dpz = 0.f;
    if (!live || live[i]) {
      const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
      const float accum = accum_of(sg, sp, x, y, z, depth);
      const float sgn = accum > 0.f ? 1.0f : (accum < 0.f ? -1.0f : 0.f);
      const float g_out = sgn * ct[i];
      if (g_out != 0.f) {
        float xs = x, ys = y, zs = z, w = 1.0f, sc = 1.0f;
        for (int k = 0; k < depth; ++k) {
          Octave o;
          octave_terms(sp, xs, ys, zs, o);
          float dn_ux = 0.f, dn_uy = 0.f, dn_uz = 0.f;
          const float go = w * g_out;
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int h = o.h[a * 4 + b * 2 + c];
                const float* g = sg + 3 * h;
                const float bx = a ? o.u[0] : 1.0f - o.u[0];
                const float by = b ? o.u[1] : 1.0f - o.u[1];
                const float bz = c ? o.u[2] : 1.0f - o.u[2];
                const float blend = bx * by * bz;
                const float wx = o.u[0] - (float)a;
                const float wy = o.u[1] - (float)b;
                const float wz = o.u[2] - (float)c;
                const float dot = g[0] * wx + g[1] * wy + g[2] * wz;
                dn_ux += (a ? 1.0f : -1.0f) * by * bz * dot + blend * g[0];
                dn_uy += (b ? 1.0f : -1.0f) * bx * bz * dot + blend * g[1];
                dn_uz += (c ? 1.0f : -1.0f) * bx * by * dot + blend * g[2];
                const float cb = go * blend;
                atomicAdd(sdg + 3 * h + 0, cb * wx);
                atomicAdd(sdg + 3 * h + 1, cb * wy);
                atomicAdd(sdg + 3 * h + 2, cb * wz);
              }
          dpx += go * dn_ux * 6.0f * o.f[0] * (1.0f - o.f[0]) * sc;
          dpy += go * dn_uy * 6.0f * o.f[1] * (1.0f - o.f[1]) * sc;
          dpz += go * dn_uz * 6.0f * o.f[2] * (1.0f - o.f[2]) * sc;
          xs *= 2.0f;
          ys *= 2.0f;
          zs *= 2.0f;
          w *= 0.5f;
          sc *= 2.0f;
        }
      }
    }
    d_p[3 * i + 0] = dpx;
    d_p[3 * i + 1] = dpy;
    d_p[3 * i + 2] = dpz;
  }

  __syncthreads();
  for (int j = threadIdx.x; j < 3 * kPC; j += kBlock) {
    const float v = sdg[j];
    if (v != 0.f) atomicAdd(d_grad + j, v);
  }
}

}  // namespace perlin
}  // namespace rtw

extern "C" {

// turb (n,) of points p (n x 3) on `stream`; `live` (n bytes, 0 = dead) may
// be null (every point live). Returns cudaGetLastError() after the launch.
int rtw_turbulence(const float* p, const unsigned char* live,
                   const float* grad, const int* perm, int n, int depth,
                   float* out, void* stream) {
  using namespace rtw::perlin;
  if (n <= 0) return 0;
  turb_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
      p, live, grad, perm, n, depth, out);
  return (int)cudaGetLastError();
}

// d_p (n x 3) and d_grad (256 x 3) of turb with cotangent ct (n,) on
// `stream`; `d_grad` must be zero on entry (the kernel adds into it).
int rtw_turbulence_vjp(const float* p, const float* ct,
                       const unsigned char* live, const float* grad,
                       const int* perm, int n, int depth, float* d_p,
                       float* d_grad, void* stream) {
  using namespace rtw::perlin;
  if (n <= 0) return 0;
  turb_vjp_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                    (cudaStream_t)stream>>>(p, ct, live, grad, perm, n, depth,
                                            d_p, d_grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
