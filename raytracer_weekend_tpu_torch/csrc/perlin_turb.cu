// Perlin turbulence (K8) and its vector-Jacobian product (K9), both on
// persistent warps over the live points.
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
// shared-memory adds); a live point reads 12 bytes (16 with ct), every
// point reads a mask byte and writes 4 (12 for d_p), so with most points
// dead (a frame's records) the bytes bound it. The lookups read the two
// tables (6 KB) from shared memory, loaded once per block, so each lookup
// is one shared-memory load, not a one-hot product as on the TPU.
//
// The design of both. A frame's records are mostly dead
// (two_perlin_spheres at 400x225x16: 1.13M of 11.52M points live), so one
// thread per point left about nine lanes in ten idle through the seven
// octaves. Here resident blocks (occupancy x SMs) loop (for_live_points):
// each warp claims a window of points at a time from a counter, writes 0
// for the dead ones (coalesced, 32 at a time) and packs the live ones by
// ballot into full batches of 32, so every lane that computes carries a
// live point; the tables are loaded once per resident block. K8's dead
// points cost a mask byte and a 4-byte store, its live ones 12 bytes and
// 7 octaves of arithmetic. For K9: a float add to shared memory is a compare-and-swap
// loop on an H100 (LDS, FADD, ATOMS.CAST.SPIN), and a warp's points, taken
// in index order, share lattice cells (4 cells for 32 points at octave 0,
// 21 at octave 6, on that frame), so its lanes added into the same
// addresses together and the loop spun: on an H100 80GB HBM3 at 700 W, one
// shared copy of d_grad cost 1.7 of 1.8 ms on the compacted live points.
// Each block keeps kVjpCopies copies of d_grad and lane l adds into copy
// l % kVjpCopies; the copies are summed and added to global memory once
// per resident block, not once per 256 points. Each point's arithmetic is
// the one-thread-a-point kernels', in their order: turb and d_p are bitwise
// the same.
//
// Numerics: no fast math: floorf, IEEE arithmetic, in the plain version's
// order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtw {
namespace perlin {

constexpr int kPC = 256;  // table size
constexpr int kTurbBlock = 256;   // K8: threads a block
constexpr int kTurbWindow = 128;  // K8: points a warp claims at once
constexpr int kVjpBlock = 256;   // K9: threads a block
constexpr int kVjpWindow = 128;  // K9: points a warp claims at once
// K9 sums d_grad in kVjpCopies copies per block, lane l of each warp into
// copy l % kVjpCopies, so that lanes of one warp whose points share a
// lattice cell add into different addresses; the copies' stride is odd, so
// one entry of each copy lies in its own bank.
constexpr int kVjpCopies = 16;
constexpr int kVjpStride = 3 * kPC + 1;
// K9's dynamic shared memory: the two tables, the warps' queues of live
// points and the d_grad copies.
constexpr int kVjpSmem =
    (2 * 3 * kPC + (kVjpBlock / 32) * 64 + kVjpCopies * kVjpStride) * 4;
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
  for (int j = threadIdx.x; j < 3 * kPC; j += blockDim.x) {
    sg[j] = grad[j];
    sp[j] = perm[j];
  }
}

// The persistent warps' loop of K8 and K9: the warp claims kWindow points
// at a time from `next` (one atomicAdd by its first lane), scans the window
// 32 points at a time, calls dead(j) for each dead point and packs the
// live ones by ballot into its queue `q` (64 ints of shared memory);
// whenever the queue holds 32, each lane calls run(i) on one of them. The
// queue's last partial batch runs when the points are spent.
template <int kWindow, class Dead, class Run>
__device__ __forceinline__ void for_live_points(
    const uint8_t* __restrict__ live, int n, unsigned* __restrict__ next,
    int* __restrict__ q, Dead dead, Run run) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int queued = 0;  // live points in the queue (warp-uniform)
  for (;;) {
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(next, (unsigned)kWindow);
    base = __shfl_sync(kAll, base, 0);
    if (base >= (unsigned)n) break;
    const int end = min((int)base + kWindow, n);
    for (int j0 = (int)base; j0 < end; j0 += 32) {
      const int j = j0 + lane;
      const bool in = j < end;
      const bool lv = in && (!live || live[j]);
      if (in && !lv) dead(j);
      const unsigned m = __ballot_sync(kAll, lv);
      if (lv) q[queued + __popc(m & below)] = j;
      queued += __popc(m);
      __syncwarp();
      if (queued >= 32) {
        run(q[lane]);
        queued -= 32;
        const int carry = lane < queued ? q[32 + lane] : 0;
        __syncwarp();
        if (lane < queued) q[lane] = carry;
        __syncwarp();
      }
    }
  }
  if (lane < queued) run(q[lane]);
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

// K8 on the resident blocks: turb of each live point, 0 for each dead one.
__global__ void __launch_bounds__(kTurbBlock)
turb_kernel(const float* __restrict__ p, const uint8_t* __restrict__ live,
            const float* __restrict__ grad, const int* __restrict__ perm,
            int n, int depth, float* __restrict__ out,
            unsigned* __restrict__ next) {
  __shared__ float sg[3 * kPC];
  __shared__ int sp[3 * kPC];
  __shared__ int queues[(kTurbBlock / 32) * 64];  // 64 live points a warp
  load_tables(grad, perm, sg, sp);
  __syncthreads();
  for_live_points<kTurbWindow>(
      live, n, next, queues + (threadIdx.x >> 5) * 64,
      [&](int j) { out[j] = 0.f; },
      [&](int i) {
        out[i] = fabsf(accum_of(sg, sp, p[3 * i], p[3 * i + 1],
                                p[3 * i + 2], depth));
      });
}

// One live point's VJP (K9): d_p returned, d_grad added to the block's
// shared copy `sdg`, in the order of the first design (one thread per point
// over the whole array), so that d_p is bitwise that design's.
__device__ __forceinline__ void vjp_point(const float* __restrict__ sg,
                                          const int* __restrict__ sp,
                                          float* sdg, float x, float y,
                                          float z, float c, int depth,
                                          float& dpx, float& dpy,
                                          float& dpz) {
  dpx = dpy = dpz = 0.f;
  const float accum = accum_of(sg, sp, x, y, z, depth);
  const float sgn = accum > 0.f ? 1.0f : (accum < 0.f ? -1.0f : 0.f);
  const float g_out = sgn * c;
  if (g_out == 0.f) return;
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
        for (int c3 = 0; c3 < 2; ++c3) {
          const int h = o.h[a * 4 + b * 2 + c3];
          const float* g = sg + 3 * h;
          const float bx = a ? o.u[0] : 1.0f - o.u[0];
          const float by = b ? o.u[1] : 1.0f - o.u[1];
          const float bz = c3 ? o.u[2] : 1.0f - o.u[2];
          const float blend = bx * by * bz;
          const float wx = o.u[0] - (float)a;
          const float wy = o.u[1] - (float)b;
          const float wz = o.u[2] - (float)c3;
          const float dot = g[0] * wx + g[1] * wy + g[2] * wz;
          dn_ux += (a ? 1.0f : -1.0f) * by * bz * dot + blend * g[0];
          dn_uy += (b ? 1.0f : -1.0f) * bx * bz * dot + blend * g[1];
          dn_uz += (c3 ? 1.0f : -1.0f) * bx * by * dot + blend * g[2];
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

// K9 on the resident blocks (for_live_points): d_p = 0 for each dead
// point, each live point's VJP. d_grad is summed in the block's
// kVjpCopies copies and added to global memory once per resident block.
__global__ void __launch_bounds__(kVjpBlock)
turb_vjp_kernel(const float* __restrict__ p, const float* __restrict__ ct,
                const uint8_t* __restrict__ live,
                const float* __restrict__ grad, const int* __restrict__ perm,
                int n, int depth, float* __restrict__ d_p,
                float* __restrict__ d_grad, unsigned* __restrict__ next) {
  extern __shared__ float vjp_smem[];
  float* __restrict__ sg = vjp_smem;
  int* __restrict__ sp = (int*)(vjp_smem + 3 * kPC);
  int* __restrict__ queues = sp + 3 * kPC;  // 64 live points a warp
  float* __restrict__ copies = (float*)(queues + (kVjpBlock / 32) * 64);
  load_tables(grad, perm, sg, sp);
  for (int j = threadIdx.x; j < kVjpCopies * kVjpStride; j += kVjpBlock)
    copies[j] = 0.f;
  __syncthreads();

  float* __restrict__ sdg =
      copies + ((threadIdx.x & 31) % kVjpCopies) * kVjpStride;
  for_live_points<kVjpWindow>(
      live, n, next, queues + (threadIdx.x >> 5) * 64,
      [&](int j) {
        d_p[3 * j + 0] = 0.f;
        d_p[3 * j + 1] = 0.f;
        d_p[3 * j + 2] = 0.f;
      },
      [&](int i) {
        float dx, dy, dz;
        vjp_point(sg, sp, sdg, p[3 * i], p[3 * i + 1], p[3 * i + 2], ct[i],
                  depth, dx, dy, dz);
        d_p[3 * i + 0] = dx;
        d_p[3 * i + 1] = dy;
        d_p[3 * i + 2] = dz;
      });

  __syncthreads();
  for (int j = threadIdx.x; j < 3 * kPC; j += kVjpBlock) {
    float v = 0.f;
    for (int c = 0; c < kVjpCopies; ++c) v += copies[c * kVjpStride + j];
    if (v != 0.f) atomicAdd(d_grad + j, v);
  }
}

// Resident blocks of `kernel` at `block` threads and `smem` bytes of
// dynamic shared memory on the current device: its occupancy times the
// SMs, queried once per device into `cached` (with the opt-in to its shared
// memory above 48 KB).
template <class Kernel>
inline int resident_grid(Kernel kernel, int block, int smem, int* cached,
                         int* grid) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *grid = cached[dev];
    return 0;
  }
  int blocks = 0, sms = 0;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        block, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = blocks * sms;
  if (dev < kMaxDevices) cached[dev] = *grid;
  return 0;
}

}  // namespace perlin
}  // namespace rtw

extern "C" {

// turb (n,) of points p (n x 3) on `stream`; `live` (n bytes, 0 = dead) may
// be null (every point live). `next` is one unsigned of device memory, the
// warps' claim counter: the launch zeroes it first on `stream`. Returns
// cudaGetLastError() after the launch.
int rtw_turbulence(const float* p, const unsigned char* live,
                   const float* grad, const int* perm, int n, int depth,
                   float* out, unsigned* next, void* stream) {
  using namespace rtw::perlin;
  static int cached[64] = {};
  if (n <= 0) return 0;
  int grid = 0;
  int err = resident_grid(turb_kernel, kTurbBlock, 0, cached, &grid);
  if (err != 0) return err;
  const long long want = ((long long)n + kTurbWindow - 1) / kTurbWindow;
  if (want < grid) grid = (int)want;
  const cudaStream_t st = (cudaStream_t)stream;
  err = (int)cudaMemsetAsync(next, 0, sizeof(unsigned), st);
  if (err != 0) return err;
  turb_kernel<<<grid, kTurbBlock, 0, st>>>(p, live, grad, perm, n, depth,
                                           out, next);
  return (int)cudaGetLastError();
}

// d_p (n x 3) and d_grad (256 x 3) of turb with cotangent ct (n,) on
// `stream`; `d_grad` must be zero on entry (the kernel adds into it).
// `next` is one unsigned of device memory, the warps' claim counter: the
// launch zeroes it first on `stream`.
int rtw_turbulence_vjp(const float* p, const float* ct,
                       const unsigned char* live, const float* grad,
                       const int* perm, int n, int depth, float* d_p,
                       float* d_grad, unsigned* next, void* stream) {
  using namespace rtw::perlin;
  static int cached[64] = {};
  if (n <= 0) return 0;
  int grid = 0;
  int err = resident_grid(turb_vjp_kernel, kVjpBlock, kVjpSmem, cached,
                          &grid);
  if (err != 0) return err;
  const long long want = ((long long)n + kVjpWindow - 1) / kVjpWindow;
  if (want < grid) grid = (int)want;
  const cudaStream_t st = (cudaStream_t)stream;
  err = (int)cudaMemsetAsync(next, 0, sizeof(unsigned), st);
  if (err != 0) return err;
  turb_vjp_kernel<<<grid, kVjpBlock, kVjpSmem, st>>>(
      p, ct, live, grad, perm, n, depth, d_p, d_grad, next);
  return (int)cudaGetLastError();
}

}  // extern "C"
