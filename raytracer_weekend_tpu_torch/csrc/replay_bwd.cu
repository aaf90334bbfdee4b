// Replay backward of the fused render for sphere scenes, one thread per lane.
//
// Replaces: raytracer_weekend_tpu/ops/pallas/replay_bwd.py:_kernel, sphere
// branch (has_sph, no planar, defer=False), reached through replay_bwd_fused
// -> _kernel_entry -> pl.pallas_call. For the radiance estimator
//     rad = sum_k tp_k * emit_k + miss * tp * background
// with the winners that the forward kernel recorded held fixed (the codes of
// csrc/megakernel.cu, kEmit), it returns the vector-Jacobian product with
// the radiance cotangent g: d(ktab) (KT, S) for the sphere table of
// ops/cuda/replay_bwd.py:pack_ktab, d_o and d_d (B, 3), d_time (B,) and
// d_background (3,). Its plain version is torch.autograd through
// replay.replay_packed on the same codes (replay_bwd_reference).
//
// A lane works in two sweeps. The forward sweep re-traces its own bounces
// from the codes (the sphere's row read by index, the quadratic with the
// t_min root select, hit point, outward normal (p - c)/r, front-face flip,
// solid/checker select, Lambertian/Metal/Dielectric/Light scatter with the
// same PCG4D draws as the forward kernel) and keeps (o, d, tp) of each
// bounce in a global scratch laid out (D, 9, B), so a bounce's loads and
// stores coalesce across the warp. Liveness needs no slot: a lane sweeps
// only its own live bounces, the per-lane form of the TPU kernel's per-tile
// trip count. The reverse sweep walks them back with the chain rules of the
// TPU kernel (scatter branches, normal and sphere geometry, texture select).
// A dead bounce is never evaluated, so no masked-zero cotangent ever meets
// the inf of 1/|d|^2 on a dead lane (the NaN hazard of replay_bwd.py:313).
//
// What bounds it on an H100: the sphere-table cotangent reduction. About
// 3.7M live bounces per jumpy_balls frame each add up to 19 values, and most
// of them land on the few columns of the ground sphere. Every block therefore
// accumulates into its own copy of d(ktab) in shared memory (KT * S * 4 bytes,
// 37 KB for jumpy_balls) with shared-memory atomics, skipping zeros, and
// adds each nonzero entry of that copy to global memory once. The wrapper
// raises when the copy does not fit the opt-in shared-memory limit. The
// per-lane math is a few hundred FP32 operations per bounce; the scratch is
// 36 bytes per bounce written once and read once.
//
// Numerics: no fast math; sinf/cosf/sqrtf/cbrtf and IEEE division, as in
// megakernel.cu. Float atomics make d(ktab) and d_background depend on the
// order of additions, so they match their plain version within tolerances,
// not bitwise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pcg4d.cuh"

namespace rtw {
namespace bwd {

// Rows of the sphere table, each S floats long (ops/cuda/replay_bwd.py).
enum KRow {
  AX, AY, AZ,         // alpha: center at time 0
  BX, BY, BZ,         // beta: center velocity
  R, R2,              // signed radius, radius^2
  MTYPE, FUZZ, IOR,
  TTYPE,
  C1R, C1G, C1B,
  C2R, C2G, C2B,
  TSCALE,
  KT
};

constexpr int kBlock = 256;
constexpr int kState = 9;  // o(3), d(3), tp(3) per bounce

struct Launch {
  int n, n_spheres, max_depth;
  float t_min;
  uint32_t seed;
};

// The forward values of one live bounce that hit sphere `s`.
struct Bounce {
  float bx, by, bz;               // beta of the sphere
  float ocx, ocy, ocz;            // o - center(time)
  float a, hb, ct, disc, sq, inv_a, t;
  bool near;                      // the near root was taken
  float px, py, pz;               // hit point
  float r, snx, sny, snz;         // radius, outward normal (p - c)/r
  bool front;
  float sgn, nx, ny, nz;          // shading normal = sgn * outward
  bool use2;                      // checker odd cell: color2
  float tr, tg, tb;               // texture color
  float mtype;
  float inv_len, ux, uy, uz, udn; // unit incoming direction
  float vx, vy, vz, br;           // metal: ball sample direction, radius
  float ior, ratio, cos_t;        // dielectric
  bool reflect;
  float rpx, rpy, rpz, q, sqm;    // dielectric refraction
  float ndx, ndy, ndz;            // scattered direction
  bool alive2;                    // the path goes on
};

__device__ __forceinline__ void recompute(
    const float* __restrict__ tab, int S, int s, float time, float t_min,
    uint32_t seed, uint32_t rid, uint32_t depth, float ox, float oy, float oz,
    float dx, float dy, float dz, Bounce& b) {
  const float* __restrict__ col = tab + s;
  b.bx = col[BX * S];
  b.by = col[BY * S];
  b.bz = col[BZ * S];
  const float cx = col[AX * S] + time * b.bx;
  const float cy = col[AY * S] + time * b.by;
  const float cz = col[AZ * S] + time * b.bz;
  b.ocx = ox - cx;
  b.ocy = oy - cy;
  b.ocz = oz - cz;
  b.a = dx * dx + dy * dy + dz * dz;
  b.hb = b.ocx * dx + b.ocy * dy + b.ocz * dz;
  b.ct = b.ocx * b.ocx + b.ocy * b.ocy + b.ocz * b.ocz - col[R2 * S];
  b.disc = b.hb * b.hb - b.a * b.ct;
  b.sq = sqrtf(b.disc > 0.f ? b.disc : 1.f);
  b.inv_a = 1.0f / fmaxf(b.a, 1e-20f);
  const float root1 = (-b.hb - b.sq) * b.inv_a;
  b.near = root1 >= t_min;
  b.t = b.near ? root1 : (-b.hb + b.sq) * b.inv_a;
  b.px = ox + b.t * dx;
  b.py = oy + b.t * dy;
  b.pz = oz + b.t * dz;
  b.r = col[R * S];
  b.snx = (b.px - cx) / b.r;
  b.sny = (b.py - cy) / b.r;
  b.snz = (b.pz - cz) / b.r;
  b.front = (dx * b.snx + dy * b.sny + dz * b.snz) < 0.f;
  b.sgn = b.front ? 1.f : -1.f;
  b.nx = b.sgn * b.snx;
  b.ny = b.sgn * b.sny;
  b.nz = b.sgn * b.snz;

  b.use2 = false;
  if (col[TTYPE * S] == 1.0f) {
    const float sc = col[TSCALE * S];
    b.use2 = sinf(sc * b.px) * sinf(sc * b.py) * sinf(sc * b.pz) < 0.f;
  }
  b.tr = b.use2 ? col[C2R * S] : col[C1R * S];
  b.tg = b.use2 ? col[C2G * S] : col[C1G * S];
  b.tb = b.use2 ? col[C2B * S] : col[C1B * S];

  b.mtype = col[MTYPE * S];
  const float len = sqrtf(b.a + 1e-20f);
  b.inv_len = 1.0f / len;
  b.ux = dx / len;
  b.uy = dy / len;
  b.uz = dz / len;
  b.udn = b.ux * b.nx + b.uy * b.ny + b.uz * b.nz;
  b.ndx = dx;
  b.ndy = dy;
  b.ndz = dz;
  if (b.mtype == 3.0f) {  // diffuse light: emits, the path ends
    b.alive2 = false;
  } else if (b.mtype == 1.0f) {  // metal
    const float4 um = rand4(seed, rid, depth, SALT_METAL);
    const float3 v = unit_vector(um.x, um.y);
    b.vx = v.x;
    b.vy = v.y;
    b.vz = v.z;
    b.br = cbrtf(um.z);
    const float fuzz = col[FUZZ * S];
    b.ndx = (b.ux - 2.0f * b.udn * b.nx) + fuzz * (v.x * b.br);
    b.ndy = (b.uy - 2.0f * b.udn * b.ny) + fuzz * (v.y * b.br);
    b.ndz = (b.uz - 2.0f * b.udn * b.nz) + fuzz * (v.z * b.br);
    b.alive2 = (b.ndx * b.nx + b.ndy * b.ny + b.ndz * b.nz) > 0.f;
  } else if (b.mtype == 2.0f) {  // dielectric
    const float ud = rand4(seed, rid, depth, SALT_DIELECTRIC).x;
    b.ior = col[IOR * S];
    b.ratio = b.front ? 1.0f / b.ior : b.ior;
    b.cos_t = fminf(-b.udn, 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - b.cos_t * b.cos_t, 1e-12f));
    float r0 = (1.0f - b.ratio) / (1.0f + b.ratio);
    r0 = r0 * r0;
    const float omc = 1.0f - b.cos_t;
    const float omc2 = omc * omc;
    const float refl = r0 + (1.0f - r0) * (omc * (omc2 * omc2));
    b.reflect = b.ratio * sin_t > 1.0f || refl > ud;
    if (b.reflect) {
      b.ndx = b.ux - 2.0f * b.udn * b.nx;
      b.ndy = b.uy - 2.0f * b.udn * b.ny;
      b.ndz = b.uz - 2.0f * b.udn * b.nz;
    } else {
      b.rpx = b.ratio * (b.ux + b.cos_t * b.nx);
      b.rpy = b.ratio * (b.uy + b.cos_t * b.ny);
      b.rpz = b.ratio * (b.uz + b.cos_t * b.nz);
      b.q = 1.0f - (b.rpx * b.rpx + b.rpy * b.rpy + b.rpz * b.rpz);
      b.sqm = sqrtf(fmaxf(fabsf(b.q), 1e-12f));
      b.ndx = b.rpx - b.sqm * b.nx;
      b.ndy = b.rpy - b.sqm * b.ny;
      b.ndz = b.rpz - b.sqm * b.nz;
    }
    b.alive2 = true;
  } else {  // lambertian: normal + unit vector, degenerate -> normal
    const float4 ul = rand4(seed, rid, depth, SALT_LAMBERTIAN);
    const float3 v = unit_vector(ul.x, ul.y);
    b.ndx = b.nx + v.x;
    b.ndy = b.ny + v.y;
    b.ndz = b.nz + v.z;
    if (fabsf(b.ndx) < 1e-8f && fabsf(b.ndy) < 1e-8f && fabsf(b.ndz) < 1e-8f) {
      b.ndx = b.nx;
      b.ndy = b.ny;
      b.ndz = b.nz;
    }
    b.alive2 = true;
  }
}

// The sphere a code names, or -1 for a miss, a dead bounce or a code that is
// not a sphere of this table (read as a miss, never as an out-of-range row).
__device__ __forceinline__ int code_sphere(int code, int S) {
  if (code <= 0 || (code & 3) != 1) return -1;
  const int s = code >> 2;
  return s < S ? s : -1;
}

__device__ __forceinline__ void acc(float* __restrict__ sdt, int S, int row,
                                    int s, float v) {
  if (v != 0.f) atomicAdd(sdt + row * S + s, v);
}

__global__ void __launch_bounds__(kBlock)
replay_bwd_kernel(const float* __restrict__ tab, const float* __restrict__ bg,
                  const float* __restrict__ o0, const float* __restrict__ d0,
                  const float* __restrict__ times,
                  const int* __restrict__ ray_ids,
                  const int* __restrict__ codes, const float* __restrict__ g,
                  Launch L, float* __restrict__ st,
                  float* __restrict__ dtab, float* __restrict__ d_o,
                  float* __restrict__ d_d, float* __restrict__ d_time,
                  float* __restrict__ d_bg) {
  extern __shared__ float smem[];
  const int S = L.n_spheres;
  const int n_tab = KT * S;
  float* __restrict__ sdt = smem;          // this block's d(ktab)
  float* __restrict__ sbg = smem + n_tab;  // this block's d_background
  for (int j = threadIdx.x; j < n_tab + 3; j += kBlock) smem[j] = 0.f;
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < L.n) {
    const long long n = L.n;
    const int D = L.max_depth;
    const int* __restrict__ lane_codes = codes + (long long)i * D;
    const uint32_t rid = (uint32_t)ray_ids[i];
    const float time = times[i];
    const float gr = g[3 * i + 0], gg = g[3 * i + 1], gb = g[3 * i + 2];

    // ---- forward sweep: re-trace the saved path, keep (o, d, tp) ---------
    float ox = o0[3 * i + 0], oy = o0[3 * i + 1], oz = o0[3 * i + 2];
    float dx = d0[3 * i + 0], dy = d0[3 * i + 1], dz = d0[3 * i + 2];
    float tpr = 1.f, tpg = 1.f, tpb = 1.f;
    int trips = 0;
    for (int k = 0; k < D; ++k) {
      float* __restrict__ sk = st + (long long)k * kState * n + i;
      sk[0 * n] = ox;
      sk[1 * n] = oy;
      sk[2 * n] = oz;
      sk[3 * n] = dx;
      sk[4 * n] = dy;
      sk[5 * n] = dz;
      sk[6 * n] = tpr;
      sk[7 * n] = tpg;
      sk[8 * n] = tpb;
      trips = k + 1;
      const int s = code_sphere(lane_codes[k], S);
      if (s < 0) break;  // miss: background, the path ends
      Bounce b;
      recompute(tab, S, s, time, L.t_min, L.seed, rid, (uint32_t)k, ox, oy,
                oz, dx, dy, dz, b);
      if (b.mtype != 2.0f) {  // dielectric attenuates by 1
        tpr *= b.tr;
        tpg *= b.tg;
        tpb *= b.tb;
      }
      if (!b.alive2) break;
      ox = b.px;
      oy = b.py;
      oz = b.pz;
      dx = b.ndx;
      dy = b.ndy;
      dz = b.ndz;
    }

    // ---- reverse sweep ----------------------------------------------------
    // Cotangents of the ray (o, d) and throughput entering bounce k + 1.
    float cox = 0.f, coy = 0.f, coz = 0.f;
    float cdx = 0.f, cdy = 0.f, cdz = 0.f;
    float ctr = 0.f, ctg = 0.f, ctb = 0.f;
    float ctime = 0.f;
    for (int k = trips - 1; k >= 0; --k) {
      const float* __restrict__ sk = st + (long long)k * kState * n + i;
      ox = sk[0 * n];
      oy = sk[1 * n];
      oz = sk[2 * n];
      dx = sk[3 * n];
      dy = sk[4 * n];
      dz = sk[5 * n];
      tpr = sk[6 * n];
      tpg = sk[7 * n];
      tpb = sk[8 * n];
      const int s = code_sphere(lane_codes[k], S);
      if (s < 0) {  // miss: rad += tp * bg
        const float ar = gr * tpr, ag = gg * tpg, ab = gb * tpb;
        if (ar != 0.f) atomicAdd(sbg + 0, ar);
        if (ag != 0.f) atomicAdd(sbg + 1, ag);
        if (ab != 0.f) atomicAdd(sbg + 2, ab);
        ctr += gr * bg[0];
        ctg += gg * bg[1];
        ctb += gb * bg[2];
        continue;
      }
      Bounce b;
      recompute(tab, S, s, time, L.t_min, L.seed, rid, (uint32_t)k, ox, oy,
                oz, dx, dy, dz, b);

      // o', d' = alive2 ? (p, nd) : (o, d)
      const float al = b.alive2 ? 1.f : 0.f;
      const float cpx = al * cox, cpy = al * coy, cpz = al * coz;
      const float cndx = al * cdx, cndy = al * cdy, cndz = al * cdz;
      cox -= cpx;
      coy -= cpy;
      coz -= cpz;
      cdx -= cndx;
      cdy -= cndy;
      cdz -= cndz;

      // rad += light ? tp * tex : 0 ;  tp' = tp * att
      const bool light = b.mtype == 3.0f;
      const bool die = b.mtype == 2.0f;
      float ctexr = 0.f, ctexg = 0.f, ctexb = 0.f;
      const float catr = ctr * tpr, catg = ctg * tpg, catb = ctb * tpb;
      if (light) {
        ctexr = gr * tpr;
        ctexg = gg * tpg;
        ctexb = gb * tpb;
        ctr = gr * b.tr;
        ctg = gg * b.tg;
        ctb = gb * b.tb;
      } else if (!die) {  // lambertian and metal attenuate by the texture
        ctexr = catr;
        ctexg = catg;
        ctexb = catb;
        ctr *= b.tr;
        ctg *= b.tg;
        ctb *= b.tb;
      }

      // nd -> (u, n, fuzz, ior)
      float cux = 0.f, cuy = 0.f, cuz = 0.f;
      float cnx = 0.f, cny = 0.f, cnz = 0.f;
      float cfuzz = 0.f, cior = 0.f;
      if (b.mtype == 1.0f || (die && b.reflect)) {
        // nd = u - 2(u.n)n [+ fuzz * br * v]
        const float m = b.nx * cndx + b.ny * cndy + b.nz * cndz;
        cux = cndx - 2.0f * b.nx * m;
        cuy = cndy - 2.0f * b.ny * m;
        cuz = cndz - 2.0f * b.nz * m;
        cnx = -2.0f * (b.ux * m + b.udn * cndx);
        cny = -2.0f * (b.uy * m + b.udn * cndy);
        cnz = -2.0f * (b.uz * m + b.udn * cndz);
        if (!die) cfuzz = b.br * (b.vx * cndx + b.vy * cndy + b.vz * cndz);
      } else if (die) {
        // nd = rp - sqrt(max(|q|, eps)) n,  q = 1 - rp.rp,
        // rp = ratio (u + cos n),  cos = min(-u.n, 1)
        const float ndot = b.nx * cndx + b.ny * cndy + b.nz * cndz;
        const float live_m = fabsf(b.q) > 1e-12f
                                 ? (b.q >= 0.f ? 1.f : -1.f) / b.sqm : 0.f;
        const float crpx = cndx + ndot * live_m * b.rpx;
        const float crpy = cndy + ndot * live_m * b.rpy;
        const float crpz = cndz + ndot * live_m * b.rpz;
        cnx = -b.sqm * cndx + b.ratio * b.cos_t * crpx;
        cny = -b.sqm * cndy + b.ratio * b.cos_t * crpy;
        cnz = -b.sqm * cndz + b.ratio * b.cos_t * crpz;
        cux = b.ratio * crpx;
        cuy = b.ratio * crpy;
        cuz = b.ratio * crpz;
        const float ccos = b.ratio * (b.nx * crpx + b.ny * crpy + b.nz * crpz);
        const float cratio = (b.ux + b.cos_t * b.nx) * crpx +
                             (b.uy + b.cos_t * b.ny) * crpy +
                             (b.uz + b.cos_t * b.nz) * crpz;
        if (-b.udn < 1.0f) {
          cux -= b.nx * ccos;
          cuy -= b.ny * ccos;
          cuz -= b.nz * ccos;
          cnx -= b.ux * ccos;
          cny -= b.uy * ccos;
          cnz -= b.uz * ccos;
        }
        cior = b.front ? -cratio / (b.ior * b.ior) : cratio;
      } else if (!light) {  // lambertian: nd = n + v (or n)
        cnx = cndx;
        cny = cndy;
        cnz = cndz;
      }

      // u = d / |d|
      const float udc = b.ux * cux + b.uy * cuy + b.uz * cuz;
      cdx += b.inv_len * (cux - b.ux * udc);
      cdy += b.inv_len * (cuy - b.uy * udc);
      cdz += b.inv_len * (cuz - b.uz * udc);

      // n = sgn * outward, outward = (p - c) / r
      const float csx = b.sgn * cnx, csy = b.sgn * cny, csz = b.sgn * cnz;
      const float cpsx = cpx + csx / b.r;
      const float cpsy = cpy + csy / b.r;
      const float cpsz = cpz + csz / b.r;
      float ccx = -csx / b.r, ccy = -csy / b.r, ccz = -csz / b.r;
      const float c_r = -(b.snx * csx + b.sny * csy + b.snz * csz) / b.r;

      // p = o + t d
      const float ct = dx * cpsx + dy * cpsy + dz * cpsz;
      cox += cpsx;
      coy += cpsy;
      coz += cpsz;
      cdx += b.t * cpsx;
      cdy += b.t * cpsy;
      cdz += b.t * cpsz;

      // t = (-half_b -+ sq) / a, the selected root
      const float s_r = b.near ? -1.f : 1.f;
      const float csq = ct * s_r * b.inv_a;
      float chb = -ct * b.inv_a;
      float ca = -ct * b.t * b.inv_a;
      const float cdisc = b.disc > 0.f ? csq / (2.0f * b.sq) : 0.f;
      chb += 2.0f * b.hb * cdisc;
      ca -= b.ct * cdisc;
      const float cct = -b.a * cdisc;
      // half_b = oc.d ;  c = oc.oc - r2 ;  a = d.d
      const float cocx = chb * dx + 2.0f * cct * b.ocx;
      const float cocy = chb * dy + 2.0f * cct * b.ocy;
      const float cocz = chb * dz + 2.0f * cct * b.ocz;
      cdx += chb * b.ocx + 2.0f * ca * dx;
      cdy += chb * b.ocy + 2.0f * ca * dy;
      cdz += chb * b.ocz + 2.0f * ca * dz;
      // oc = o - center,  center = alpha + time * beta
      cox += cocx;
      coy += cocy;
      coz += cocz;
      ccx -= cocx;
      ccy -= cocy;
      ccz -= cocz;
      ctime += b.bx * ccx + b.by * ccy + b.bz * ccz;

      acc(sdt, S, AX, s, ccx);
      acc(sdt, S, AY, s, ccy);
      acc(sdt, S, AZ, s, ccz);
      acc(sdt, S, BX, s, time * ccx);
      acc(sdt, S, BY, s, time * ccy);
      acc(sdt, S, BZ, s, time * ccz);
      acc(sdt, S, R, s, c_r);
      acc(sdt, S, R2, s, -cct);
      acc(sdt, S, FUZZ, s, cfuzz);
      acc(sdt, S, IOR, s, cior);
      const int c = b.use2 ? C2R : C1R;
      acc(sdt, S, c + 0, s, ctexr);
      acc(sdt, S, c + 1, s, ctexg);
      acc(sdt, S, c + 2, s, ctexb);
    }
    d_o[3 * i + 0] = cox;
    d_o[3 * i + 1] = coy;
    d_o[3 * i + 2] = coz;
    d_d[3 * i + 0] = cdx;
    d_d[3 * i + 1] = cdy;
    d_d[3 * i + 2] = cdz;
    d_time[i] = ctime;
  }

  // ---- one global add per nonzero entry of this block's copies -----------
  __syncthreads();
  for (int j = threadIdx.x; j < n_tab; j += kBlock) {
    const float v = sdt[j];
    if (v != 0.f) atomicAdd(dtab + j, v);
  }
  if (threadIdx.x < 3 && sbg[threadIdx.x] != 0.f)
    atomicAdd(d_bg + threadIdx.x, sbg[threadIdx.x]);
}

}  // namespace bwd
}  // namespace rtw

extern "C" {

// Shared memory the kernel needs for S spheres, in bytes.
long long rtw_replay_bwd_smem_bytes(int n_spheres) {
  return (long long)(rtw::bwd::KT * (long long)n_spheres + 3) * sizeof(float);
}

// The largest dynamic shared memory a block may opt in to on the current
// device (cudaDevAttrMaxSharedMemoryPerBlockOptin), into *bytes.
int rtw_replay_bwd_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Runs the replay backward for n lanes on `stream`. `dtab` (KT x S) and
// `d_bg` (3) must be zero on entry: the kernel adds into them. `scratch`
// holds max_depth * 9 * n floats. Returns the first CUDA error (0 on
// success); it does not sync.
int rtw_replay_bwd(const float* ktab, int n_spheres, const float* bg,
                   const float* o, const float* d, const float* time,
                   const int* ray_id, const int* codes, const float* g, int n,
                   int max_depth, float t_min, unsigned int seed,
                   float* scratch, float* dtab, float* d_o, float* d_d,
                   float* d_time, float* d_bg, void* stream) {
  if (n <= 0) return 0;
  const long long smem = rtw_replay_bwd_smem_bytes(n_spheres);
  cudaError_t err = cudaFuncSetAttribute(
      rtw::bwd::replay_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rtw::bwd::Launch L{n, n_spheres, max_depth, t_min, seed};
  const int grid = (n + rtw::bwd::kBlock - 1) / rtw::bwd::kBlock;
  rtw::bwd::replay_bwd_kernel<<<grid, rtw::bwd::kBlock, (size_t)smem,
                                (cudaStream_t)stream>>>(
      ktab, bg, o, d, time, ray_id, codes, g, L, scratch, dtab, d_o, d_d,
      d_time, d_bg);
  return (int)cudaGetLastError();
}

}  // extern "C"
