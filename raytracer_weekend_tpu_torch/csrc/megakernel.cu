// Fused forward path-tracing kernel for sphere scenes, one thread per lane.
//
// Replaces: raytracer_weekend_tpu/ops/pallas/megakernel.py:_kernel, sphere
// branch (has_sph, no planar, no volumes, defer_tex=False), with
// emit_paths=False (K1) and emit_paths=True (K1-emit), reached through
// render_fused -> _render_fused_core -> pl.pallas_call.
// It computes what that kernel computes, not its TPU layout: per lane
// (lane = pixel*spp + sample) the thin-lens primary ray with a shutter time,
// then up to max_depth bounces of closest moving sphere, hit record with the
// signed-radius outward normal and front-face flip, solid/checker texture,
// and the Lambertian/Metal/Dielectric/DiffuseLight scatter; out come the
// lane's radiance (3 x f32) and its traced segment count (int32). K1-emit
// (kEmit = true) also writes the lane's winner code per bounce, int32
// 1 + 4*sphere where the lane was alive and hit, 0 after a miss and for the
// bounces after the lane left the loop: the record the backward replays
// (csrc/replay_bwd.cu). kEmit = false compiles to the kernel without the
// codes, so that launch is bitwise what it was before codes existed. The
// arithmetic follows the staged reference (integrator.trace_rays in both
// packages), which the wrapper's plain version reproduces in torch.
//
// What bounds it on an H100: FP32 issue and divergence. Every live lane tests
// all S spheres each bounce (jumpy_balls: ~486 spheres x ~2.6 segments per
// lane, ~20 flops per test), and lanes of a warp die at different depths and
// take different material branches. Memory traffic is tiny: the sphere table
// is a few tens of KB and outputs are 16 bytes per lane.
//
// What the design does about it: the per-sphere test is the direct form
// (one lerp of the center, two dots, one compare on the discriminant) with
// the square root and the root select only behind `disc > 0`; the table is
// structure-of-arrays and read through `const __restrict__`, and since every
// thread of a warp reads the same sphere at the same time each read is one
// broadcast from L1. A lane leaves the depth loop as soon as it dies, and
// only the winning material's branch draws its random numbers. Later work:
// shared-memory staging, ray sorting by material, a BVH.
//
// Numerics: no fast math. The ground is a radius-1000 sphere with a checker
// of frequency 10, so sinf takes arguments in the thousands; __sinf would
// flip checker cells. sinf/cosf/sqrtf/cbrtf and IEEE division throughout.
//
// Build (the wrapper does this at first use, see ops/cuda/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o librtw.so megakernel.cu
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pcg4d.cuh"

namespace rtw {

// Sphere table rows, each S floats long (ops/cuda/megakernel.py:TABLE_ROWS).
enum Row {
  C0X, C0Y, C0Z,      // center at t0
  DCX, DCY, DCZ,      // c1 - c0
  T0, INV_DT, DT,     // t0, 1/(t1 - t0), t1 - t0
  R2,                 // radius^2, or -inf for a padding row (never hits)
  RADIUS,             // signed radius
  MTYPE, FUZZ, IOR,   // material, pre-gathered per sphere
  TTYPE,              // texture type: 0 solid, 1 checker
  C1R, C1G, C1B,
  C2R, C2G, C2B,
  TSCALE,
  N_ROWS
};

// Camera and background, as megakernel.py:_pack_par packs them.
enum Par {
  P_ORIGIN = 0, P_LOWER_LEFT = 3, P_HORIZONTAL = 6, P_VERTICAL = 9,
  P_U = 12, P_V = 15, P_LENS_RADIUS = 18, P_TIME0 = 19, P_DTIME = 20,
  P_BACKGROUND = 21, N_PAR = 24
};

constexpr int kBlock = 128;

struct Launch {
  long long lane_start;
  int n_chunk, n_spheres, width, height, spp, max_depth;
  float t_min;
  uint32_t seed;
};

template <bool kEmit>
__global__ void __launch_bounds__(kBlock)
render_kernel(const float* __restrict__ tab, const float* __restrict__ par,
              Launch L, float* __restrict__ rad, int* __restrict__ seg,
              int* __restrict__ codes) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= L.n_chunk) return;
  const int S = L.n_spheres;
  const float* __restrict__ c0x = tab + C0X * S;
  const float* __restrict__ c0y = tab + C0Y * S;
  const float* __restrict__ c0z = tab + C0Z * S;
  const float* __restrict__ dcx = tab + DCX * S;
  const float* __restrict__ dcy = tab + DCY * S;
  const float* __restrict__ dcz = tab + DCZ * S;
  const float* __restrict__ t0s = tab + T0 * S;
  const float* __restrict__ inv_dt = tab + INV_DT * S;
  const float* __restrict__ r2s = tab + R2 * S;

  // ---- primary ray (integrator._pixel_rays + camera.get_rays) -----------
  const long long lane = L.lane_start + i;
  const uint32_t rid = (uint32_t)lane;
  const long long pix = lane / L.spp;
  const float col = (float)(pix % L.width);
  const float row = (float)(L.height - 1 - pix / L.width);  // bottom-up rows

  const float4 uj = rand4(L.seed, rid, 0u, SALT_PIXEL_JITTER);
  const float fs = (col + uj.x) / (float)(L.width - 1);
  const float ft = (row + uj.y) / (float)(L.height - 1);

  const float4 ul = rand4(L.seed, rid, 0u, SALT_LENS);
  const float lr = sqrtf(ul.x);
  const float lphi = TWO_PI_F * ul.y;
  const float lens = par[P_LENS_RADIUS];
  const float rdx = lens * (lr * cosf(lphi));
  const float rdy = lens * (lr * sinf(lphi));

  const float time =
      par[P_TIME0] + rand4(L.seed, rid, 0u, SALT_TIME).x * par[P_DTIME];

  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    const float off = par[P_U + k] * rdx + par[P_V + k] * rdy;
    o[k] = par[P_ORIGIN + k] + off;
    d[k] = par[P_LOWER_LEFT + k] + fs * par[P_HORIZONTAL + k] +
           ft * par[P_VERTICAL + k] - par[P_ORIGIN + k] - off;
  }
  float ox = o[0], oy = o[1], oz = o[2];
  float dx = d[0], dy = d[1], dz = d[2];

  float tpr = 1.f, tpg = 1.f, tpb = 1.f;  // throughput
  float rr = 0.f, rg = 0.f, rb = 0.f;     // radiance
  int nseg = 0;
  // This lane's row of the (n_chunk, max_depth) codes.
  int* __restrict__ lane_codes = kEmit ? codes + (long long)i * L.max_depth
                                       : nullptr;

  for (int depth = 0; depth < L.max_depth; ++depth) {
    ++nseg;  // this lane is alive at the start of the bounce

    // ---- closest sphere: strict < keeps the first minimum ----------------
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    float best = INFINITY;
    int win = -1;
    for (int s = 0; s < S; ++s) {
      const float w = (time - t0s[s]) * inv_dt[s];
      const float ocx = ox - (c0x[s] + w * dcx[s]);
      const float ocy = oy - (c0y[s] + w * dcy[s]);
      const float ocz = oz - (c0z[s] + w * dcz[s]);
      const float hb = ocx * dx + ocy * dy + ocz * dz;
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - r2s[s];
      const float disc = hb * hb - a * cc;
      if (disc > 0.f) {
        const float sq = sqrtf(disc);
        float root = (-hb - sq) * inv_a;
        if (!(root >= L.t_min)) root = (-hb + sq) * inv_a;  // t_min select
        if (root >= L.t_min && root < best) {
          best = root;
          win = s;
        }
      }
    }

    if (win < 0) {  // miss -> background, terminate
      if (kEmit) lane_codes[depth] = 0;
      rr += tpr * par[P_BACKGROUND + 0];
      rg += tpg * par[P_BACKGROUND + 1];
      rb += tpb * par[P_BACKGROUND + 2];
      break;
    }

    if (kEmit) lane_codes[depth] = 1 + 4 * win;

    // ---- hit record (ops.sphere.sphere_record) ---------------------------
    const float* __restrict__ row_ptr = tab + win;
    const float px = ox + best * dx;
    const float py = oy + best * dy;
    const float pz = oz + best * dz;
    const float w = (time - row_ptr[T0 * S]) / row_ptr[DT * S];
    const float r = row_ptr[RADIUS * S];
    float nx = (px - (row_ptr[C0X * S] + w * row_ptr[DCX * S])) / r;
    float ny = (py - (row_ptr[C0Y * S] + w * row_ptr[DCY * S])) / r;
    float nz = (pz - (row_ptr[C0Z * S] + w * row_ptr[DCZ * S])) / r;
    const bool front = (dx * nx + dy * ny + dz * nz) < 0.f;
    if (!front) {
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }

    // ---- texture: solid / checker ----------------------------------------
    float tr = row_ptr[C1R * S], tg = row_ptr[C1G * S], tb = row_ptr[C1B * S];
    if (row_ptr[TTYPE * S] == 1.0f) {
      const float sc = row_ptr[TSCALE * S];
      const float sines = sinf(sc * px) * sinf(sc * py) * sinf(sc * pz);
      if (sines < 0.f) {
        tr = row_ptr[C2R * S];
        tg = row_ptr[C2G * S];
        tb = row_ptr[C2B * S];
      }
    }

    // ---- scatter (materials.scatter_packed) ------------------------------
    const float mtype = row_ptr[MTYPE * S];
    if (mtype == 3.0f) {  // diffuse light: emit tp * tex and stop
      rr += tpr * tr;
      rg += tpg * tg;
      rb += tpb * tb;
      break;
    }
    const float len = sqrtf(a + 1e-20f);  // vecmath.normalize(d, eps=1e-20)
    const float ux = dx / len, uy = dy / len, uz = dz / len;
    const float udn = ux * nx + uy * ny + uz * nz;
    float ndx, ndy, ndz;
    if (mtype == 1.0f) {  // metal: fuzzed mirror, absorbs when dot <= 0
      const float4 um = rand4(L.seed, rid, (uint32_t)depth, SALT_METAL);
      const float3 b = unit_vector(um.x, um.y);
      const float br = cbrtf(um.z);
      const float fuzz = row_ptr[FUZZ * S];
      ndx = (ux - 2.0f * udn * nx) + fuzz * (b.x * br);
      ndy = (uy - 2.0f * udn * ny) + fuzz * (b.y * br);
      ndz = (uz - 2.0f * udn * nz) + fuzz * (b.z * br);
      if (!((ndx * nx + ndy * ny + ndz * nz) > 0.f)) break;
      tpr *= tr;
      tpg *= tg;
      tpb *= tb;
    } else if (mtype == 2.0f) {  // dielectric: Schlick against the draw ud
      const float ud =
          rand4(L.seed, rid, (uint32_t)depth, SALT_DIELECTRIC).x;
      const float ior = row_ptr[IOR * S];
      const float ratio = front ? 1.0f / ior : ior;
      const float cos_t = fminf(-udn, 1.0f);
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float omc = 1.0f - cos_t;
      const float omc2 = omc * omc;
      const float refl = r0 + (1.0f - r0) * (omc * (omc2 * omc2));
      if (ratio * sin_t > 1.0f || refl > ud) {
        ndx = ux - 2.0f * udn * nx;
        ndy = uy - 2.0f * udn * ny;
        ndz = uz - 2.0f * udn * nz;
      } else {  // refract (vecmath.refract)
        const float rpx = ratio * (ux + cos_t * nx);
        const float rpy = ratio * (uy + cos_t * ny);
        const float rpz = ratio * (uz + cos_t * nz);
        const float rp2 = rpx * rpx + rpy * rpy + rpz * rpz;
        const float pm = -sqrtf(fmaxf(fabsf(1.0f - rp2), 1e-12f));
        ndx = rpx + pm * nx;
        ndy = rpy + pm * ny;
        ndz = rpz + pm * nz;
      }
    } else {  // lambertian: normal + unit vector, degenerate -> normal
      const float4 ulm = rand4(L.seed, rid, (uint32_t)depth, SALT_LAMBERTIAN);
      const float3 v = unit_vector(ulm.x, ulm.y);
      ndx = nx + v.x;
      ndy = ny + v.y;
      ndz = nz + v.z;
      if (fabsf(ndx) < 1e-8f && fabsf(ndy) < 1e-8f && fabsf(ndz) < 1e-8f) {
        ndx = nx;
        ndy = ny;
        ndz = nz;
      }
      tpr *= tr;
      tpg *= tg;
      tpb *= tb;
    }
    // The scattered ray keeps the parent's shutter time.
    ox = px;
    oy = py;
    oz = pz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }

  rad[3 * i + 0] = rr;
  rad[3 * i + 1] = rg;
  rad[3 * i + 2] = rb;
  seg[i] = nseg;
  if (kEmit) {  // bounces [nseg, max_depth) were never started
    for (int k = nseg; k < L.max_depth; ++k) lane_codes[k] = 0;
  }
}

__global__ void rand4_kernel(const uint32_t* __restrict__ ids, int n,
                             uint32_t depth, uint32_t salt, uint32_t seed,
                             float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rand4(seed, ids[i], depth, salt);
}

}  // namespace rtw

extern "C" {

// Renders lanes [lane_start, lane_start + n_chunk) on `stream`; with a
// non-null `codes` (n_chunk x max_depth int32) it also writes the winner
// codes. Returns cudaGetLastError() after the launch (0 on success); it does
// not sync.
int rtw_render_fused(const float* tab, int n_spheres, const float* par,
                     long long lane_start, int n_chunk, int width, int height,
                     int spp, int max_depth, float t_min, unsigned int seed,
                     float* rad, int* seg, int* codes, void* stream) {
  if (n_chunk <= 0) return 0;
  rtw::Launch L{lane_start, n_chunk, n_spheres, width, height,
                spp, max_depth, t_min, seed};
  const int grid = (n_chunk + rtw::kBlock - 1) / rtw::kBlock;
  if (codes) {
    rtw::render_kernel<true><<<grid, rtw::kBlock, 0, (cudaStream_t)stream>>>(
        tab, par, L, rad, seg, codes);
  } else {
    rtw::render_kernel<false><<<grid, rtw::kBlock, 0, (cudaStream_t)stream>>>(
        tab, par, L, rad, seg, nullptr);
  }
  return (int)cudaGetLastError();
}

// The device rand4 for n ray ids (a probe for bit-exactness checks).
int rtw_rand4(const unsigned int* ids, int n, unsigned int depth,
              unsigned int salt, unsigned int seed, float* out, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  rtw::rand4_kernel<<<(n + block - 1) / block, block, 0,
                      (cudaStream_t)stream>>>(ids, n, depth, salt, seed,
                                              reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

const char* rtw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
