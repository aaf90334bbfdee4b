// Replay backward of the fused render, one thread per lane: spheres (K2), the
// planar family (K4: axis-aligned rects and triangles in one table) and the
// deferred-texture branch of both (K7).
//
// Replaces: raytracer_weekend_tpu/ops/pallas/replay_bwd.py:_kernel, its
// sphere branch (has_sph), its planar branch (has_pla, table of pack_ptab)
// and its deferred branch (defer, defer_noise), reached through
// replay_bwd_fused -> _kernel_entry -> pl.pallas_call. For the radiance estimator
//     rad = sum_k tp_k * emit_k + miss * tp * background
// with the winners that the forward kernel recorded held fixed (the codes of
// csrc/megakernel.cuh, kEmit), it returns the vector-Jacobian product with
// the radiance cotangent g: d(ktab) (KT, S) for the sphere table of
// ops/cuda/replay_bwd.py:pack_ktab, d(ptab) (KP, R) for the planar table of
// pack_ptab, d_o and d_d (B, 3), d_time (B,) and d_background (3,). Its
// plain version is torch.autograd through replay.replay_packed on the same
// codes (replay_bwd_reference).
//
// A lane works in two sweeps. The forward sweep re-traces its own bounces
// from the codes (the winner's row read by index; for a sphere the
// quadratic with the t_min root select and the outward normal (p - c)/r,
// for a planar primitive t = (o.n - k)/(-d.n), u_b = ua.p + ca,
// v_b = ub.p + cb and the raw outward normal ns0 + u_b*nsu + v_b*nsv; then
// the front-face flip, solid/checker select, Lambertian/Metal/Dielectric/
// Light scatter with the same PCG4D draws as the forward kernel) and keeps
// (o, d, tp) of each bounce in a global scratch laid out (D, 9, B), so a
// bounce's loads and stores coalesce across the warp. Liveness needs no
// slot: a lane sweeps only its own live bounces, the per-lane form of the
// TPU kernel's per-tile trip count. The reverse sweep walks them back with
// the chain rules of the TPU kernel (scatter branches, normal and family
// geometry, texture select). A dead bounce is never evaluated, so no
// masked-zero cotangent ever meets the inf of 1/|d|^2 on a dead lane (the
// NaN hazard of replay_bwd.py:313). kSph and kPla say which families the
// scene has; the sphere-only instantiation keeps every planar statement
// behind `if constexpr` or a constant-false test, so it compiles to the
// sphere kernel as it was before the planar branch (108 registers: even a
// loop whose bound is 0 there, left outside `if constexpr`, cost 4 more).
//
// What bounds it on an H100: the table cotangent reduction and the lanes'
// unequal lengths. About 3.7M live bounces per jumpy_balls frame each add
// up to 19 values, and most of them land on the few columns of the ground
// sphere. Every block therefore accumulates into copies of d(ktab) in
// shared memory (KT * S * 4 bytes each, 37 KB for jumpy_balls), skipping
// zeros, and adds each nonzero entry of the copies' sum to global memory
// once (kKShared). A float add to shared memory is a compare-and-swap loop
// on an H100 (ATOMS.CAST.SPIN), and lanes of one warp that add into one
// address together make it spin: on two_perlin_spheres (2 spheres) the
// shared d(ktab) adds cost 0.37 ms and the background's 0.32 ms of a 1.0 ms
// launch (H100 80GB HBM3, 700 W). So lane l of each warp adds into copy
// l % copies of the tables, as many copies as fit kCopyBudget up to one a
// lane (32 for two_perlin_spheres, 2 for cornell_box, 1 for jumpy_balls),
// and into its own of kBgCopies copies of d_background. A table whose copy
// does not fit the opt-in shared-memory limit (more than 3,053 spheres on
// an H100) is reduced as the mesh's d(ptab) is below: each warp groups its
// lanes by sphere, sums each group's values by shuffles, and one lane per
// group adds the nonzero sums to global memory. d(ptab) takes the same
// shared copies when both fit (kPShared: cornell_box, 30 primitives, 3.8
// KB, its hits piled on six wall columns). A mesh's table does not fit
// (the cow: 5,805 primitives x 32 rows x 4 B = 743 KB against 227 KB), so
// there each warp groups its lanes by planar row
// (cooperative_groups::labeled_partition, i.e. __match_any_sync), sums each
// group's 32 values by shuffles, and one lane per group adds the nonzero
// sums to global memory. The per-lane math is a few hundred FP32 operations
// per bounce; the scratch is 36 bytes per bounce written once and read once.
//
// A lane sweeps 1 to max_depth bounces (two_perlin_spheres: 2.56M over
// 1.44M lanes), and a warp as long as its longest lane, and a block holds
// its registers until its longest warp ends. So three small kernels first
// order the lanes by their live bounces, most first and stable by index
// (count per bin and order block, scan, scatter), and thread t of the
// replay sweeps lane order[t]: a warp's lanes, and a block's warps, run
// about as many bounces each. A lane's outputs go to its own index, and
// its scratch to column t. The order moves no lane's arithmetic: d_o, d_d
// and d_time are bitwise those of lanes swept in index order.
//
// Deferred textures (kDefer, kDeferNoise): for a scene whose noise and image
// texels the forward deferred (csrc/megakernel.cuh, kDefer), those texels
// are 1.0 here, as in the forward, and their cotangent belongs to the
// host's combine, not to the table's color rows. The radiance cotangent is
// then per bounce, g (B, D, 3): the cotangent of the bounce's contribution
// ctb_k, which the autograd of the host's combine gives (g times the
// product of the deferred texels up to that bounce); a lane reads its own
// row of bounce k in the reverse sweep. With kDeferNoise, cabc (B, D, 3),
// the combine's cotangent of a noise record's hit point, joins the hit
// point's cotangent of each bounce whose winner has a noise texture, and so
// rides the family's geometry chain back to the tables and the ray. As with
// kSph/kPla, every deferred statement sits behind `if constexpr`.
//
// Numerics: no fast math; sinf/cosf/sqrtf/cbrtf and IEEE division, as in
// megakernel.cuh. Float atomics make the table cotangents and d_background
// depend on the order of additions, so they match their plain version
// within tolerances, not bitwise.
#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
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

// Rows of the planar table, each R floats long (ops/cuda/replay_bwd.py:
// KP_ROWS, the JAX pack_ptab layout).
enum PRow {
  P_NX, P_NY, P_NZ,      // plane normal n
  P_K,                   // plane offset: t = (o.n - k)/(-d.n)
  P_UAX, P_UAY, P_UAZ,   // u_b = ua.p + ca
  P_CA,
  P_UBX, P_UBY, P_UBZ,   // v_b = ub.p + cb
  P_CB,
  P_S0X, P_S0Y, P_S0Z,   // outward = ns0 + u_b*nsu + v_b*nsv
  P_SUX, P_SUY, P_SUZ,
  P_SVX, P_SVY, P_SVZ,
  P_MTYPE, P_FUZZ, P_IOR,
  P_TTYPE,
  P_C1R, P_C1G, P_C1B,
  P_C2R, P_C2G, P_C2B,
  P_TSCALE,
  KP
};

constexpr int kBlock = 256;
constexpr int kState = 9;  // o(3), d(3), tp(3) per bounce
constexpr int kWarps = kBlock / 32;
// The sweep order: lanes by their live bounces, most first. A lane's count
// (its leading codes that name a primitive of the tables) is clamped to
// kBins - 1; an order block of the three order kernels ranks kOrderLanes
// lanes, kOrderPerThread a thread.
constexpr int kBins = 32;
constexpr int kOrderPerThread = 4;
constexpr int kOrderLanes = kBlock * kOrderPerThread;
// Each lane of a warp adds into its own copy of d_background (kBgCopies),
// and into copy (lane % copies) of the block's shared tables, as many
// copies as fit kCopyBudget bytes up to kMaxCopies, so that fewer lanes of
// one warp add into one address together (none with 32 copies). Small
// tables take the most copies: their few columns draw every lane's adds;
// a larger table's adds spread over more columns, and more copies of it
// shrink the L1 cache for little gain (cornell_box's 3.8 KB table: 8
// copies 0.38 ms a launch, 2 copies 0.36, on an H100 80GB HBM3).
constexpr int kBgCopies = 32;
constexpr int kMaxCopies = 32;
constexpr long long kCopyBudget = 8 * 1024;

struct Launch {
  int n, n_spheres, n_planar, max_depth;
  float t_min;
  uint32_t seed;
  int copies;  // copies of the shared tables, a power of two
};

// The forward values of one live bounce that hit sphere `s` or planar
// primitive `r`.
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
  float pnx, pny, pnz, inv_df;    // planar: plane normal, 1/(-d.n)
  float ub, vb;                   // planar: in-plane coordinates
  bool table_tex;                 // kDefer: a solid/checker texel
  bool noise;                     // kDefer: a (deferred) noise texel
};

// The family-independent part of a bounce, from the outward normal
// (b.snx..) and hit point (b.px..) on: front face, shading normal, texture
// and scatter. `col` is the winner's column of its table and `st` the
// table's row stride; kM is the table's MTYPE row, followed in both tables
// by FUZZ, IOR, TTYPE, C1R..C1B, C2R..C2B, TSCALE. With kDefer a noise or
// image texel (ttype 2 or 3) is 1.0.
template <int kM, bool kDefer>
__device__ __forceinline__ void shade(const float* __restrict__ col, int st,
                                      uint32_t seed, uint32_t rid,
                                      uint32_t depth, float dx, float dy,
                                      float dz, Bounce& b) {
  b.front = (dx * b.snx + dy * b.sny + dz * b.snz) < 0.f;
  b.sgn = b.front ? 1.f : -1.f;
  b.nx = b.sgn * b.snx;
  b.ny = b.sgn * b.sny;
  b.nz = b.sgn * b.snz;

  b.use2 = false;
  if (col[(kM + 3) * st] == 1.0f) {
    const float sc = col[(kM + 10) * st];
    b.use2 = sinf(sc * b.px) * sinf(sc * b.py) * sinf(sc * b.pz) < 0.f;
  }
  b.tr = b.use2 ? col[(kM + 7) * st] : col[(kM + 4) * st];
  b.tg = b.use2 ? col[(kM + 8) * st] : col[(kM + 5) * st];
  b.tb = b.use2 ? col[(kM + 9) * st] : col[(kM + 6) * st];
  if constexpr (kDefer) {
    const float ttype = col[(kM + 3) * st];
    b.table_tex = ttype <= 1.5f;
    b.noise = ttype == 2.0f;
    if (!b.table_tex) b.tr = b.tg = b.tb = 1.0f;
  }

  b.mtype = col[kM * st];
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
    const float fuzz = col[(kM + 1) * st];
    b.ndx = (b.ux - 2.0f * b.udn * b.nx) + fuzz * (v.x * b.br);
    b.ndy = (b.uy - 2.0f * b.udn * b.ny) + fuzz * (v.y * b.br);
    b.ndz = (b.uz - 2.0f * b.udn * b.nz) + fuzz * (v.z * b.br);
    b.alive2 = (b.ndx * b.nx + b.ndy * b.ny + b.ndz * b.nz) > 0.f;
  } else if (b.mtype == 2.0f) {  // dielectric
    const float ud = rand4(seed, rid, depth, SALT_DIELECTRIC).x;
    b.ior = col[(kM + 2) * st];
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

template <bool kDefer>
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
  shade<MTYPE, kDefer>(col, S, seed, rid, depth, dx, dy, dz, b);
}

// A planar bounce: t = (o.n - k) / df with df = -d.n, the in-plane
// coordinates u_b = ua.p + ca, v_b = ub.p + cb, and the raw outward normal
// ns0 + u_b*nsu + v_b*nsv (replay._pack_planar's coefficients).
template <bool kDefer>
__device__ __forceinline__ void recompute_planar(
    const float* __restrict__ ptab, int NR, int r, uint32_t seed,
    uint32_t rid, uint32_t depth, float ox, float oy, float oz, float dx,
    float dy, float dz, Bounce& b) {
  const float* __restrict__ col = ptab + r;
  b.a = dx * dx + dy * dy + dz * dz;
  b.pnx = col[P_NX * NR];
  b.pny = col[P_NY * NR];
  b.pnz = col[P_NZ * NR];
  const float df = -(dx * b.pnx + dy * b.pny + dz * b.pnz);
  b.inv_df = 1.0f / (df == 0.f ? 1.f : df);
  b.t = (ox * b.pnx + oy * b.pny + oz * b.pnz - col[P_K * NR]) * b.inv_df;
  b.px = ox + b.t * dx;
  b.py = oy + b.t * dy;
  b.pz = oz + b.t * dz;
  b.ub = col[P_UAX * NR] * b.px + col[P_UAY * NR] * b.py +
         col[P_UAZ * NR] * b.pz + col[P_CA * NR];
  b.vb = col[P_UBX * NR] * b.px + col[P_UBY * NR] * b.py +
         col[P_UBZ * NR] * b.pz + col[P_CB * NR];
  b.snx = col[P_S0X * NR] + b.ub * col[P_SUX * NR] +
          b.vb * col[P_SVX * NR];
  b.sny = col[P_S0Y * NR] + b.ub * col[P_SUY * NR] +
          b.vb * col[P_SVY * NR];
  b.snz = col[P_S0Z * NR] + b.ub * col[P_SUZ * NR] +
          b.vb * col[P_SVZ * NR];
  shade<P_MTYPE, kDefer>(col, NR, seed, rid, depth, dx, dy, dz, b);
}

// The sphere a code names, or -1 for a miss, a dead bounce or a code that is
// not a sphere of this table (read as a miss, never as an out-of-range row).
__device__ __forceinline__ int code_sphere(int code, int S) {
  if (code <= 0 || (code & 3) != 1) return -1;
  const int s = code >> 2;
  return s < S ? s : -1;
}

// The planar primitive a code names, or -1 (as code_sphere).
__device__ __forceinline__ int code_planar(int code, int NR) {
  if (code <= 0 || (code & 3) != 2) return -1;
  const int r = code >> 2;
  return r < NR ? r : -1;
}

__device__ __forceinline__ void acc(float* __restrict__ sdt, int S, int row,
                                    int s, float v) {
  if (v != 0.f) atomicAdd(sdt + row * S + s, v);
}

// The sweep-order bin of lane i among nb bins: nb - 1 less its live
// bounces, the leading codes that name a sphere or a planar primitive of
// the tables, clamped to nb - 1 (most bounces, bin 0).
__device__ __forceinline__ int order_bin(const int* __restrict__ codes,
                                         const Launch& L, int nb, int i) {
  const int* __restrict__ c = codes + (long long)i * L.max_depth;
  int hits = 0;
  bool run = true;  // every code so far a hit; the loads go out together
#pragma unroll 8
  for (int k = 0; k < nb - 1; ++k) {
    const int code = c[k];
    run = run && (code_sphere(code, L.n_spheres) >= 0 ||
                  code_planar(code, L.n_planar) >= 0);
    hits += run ? 1 : 0;
  }
  return nb - 1 - hits;
}

// Order kernel 1: each lane's bin into bins[lane], and each order block's
// lanes per bin into hist[bin * gridDim.x + block].
__global__ void __launch_bounds__(kBlock)
order_count_kernel(const int* __restrict__ codes, Launch L, int nb,
                   uint8_t* __restrict__ bins, int* __restrict__ hist) {
  __shared__ int count[kBins];
  if (threadIdx.x < kBins) count[threadIdx.x] = 0;
  __syncthreads();
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  for (int r = 0; r < kOrderPerThread; ++r) {
    const long long i =
        (long long)blockIdx.x * kOrderLanes + r * kBlock + threadIdx.x;
    const int bin = i < L.n ? order_bin(codes, L, nb, (int)i) : -1;
    if (bin >= 0) bins[i] = (uint8_t)bin;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && (peers & below) == 0)
      atomicAdd(count + bin, __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < nb)
    hist[(long long)threadIdx.x * gridDim.x + blockIdx.x] = count[threadIdx.x];
}

// Order kernel 2, one block of 1,024 threads: hist[0, m) scanned in place
// (exclusive): each (bin, order block)'s first position in the order.
__global__ void __launch_bounds__(1024)
order_scan_kernel(int* __restrict__ hist, int m) {
  __shared__ int part[1024];
  const int per = (m + 1023) / 1024;
  const int b = threadIdx.x * per;
  const int e = min(b + per, m);
  int own = 0;
  for (int j = b; j < e; ++j) own += hist[j];
  part[threadIdx.x] = own;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {
    const int v = threadIdx.x >= d ? part[threadIdx.x - d] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int run = part[threadIdx.x] - own;
  for (int j = b; j < e; ++j) {
    const int h = hist[j];
    hist[j] = run;
    run += h;
  }
}

// Order kernel 3: each lane's index at its position, stable within a bin
// (by lane index): order[pos] = lane.
__global__ void __launch_bounds__(kBlock)
order_scatter_kernel(const uint8_t* __restrict__ bins, Launch L, int nb,
                     const int* __restrict__ hist, int* __restrict__ order) {
  __shared__ int base[kBins];             // the next position of each bin
  __shared__ int count[kWarps * kBins];   // this round's lanes, per warp
  if (threadIdx.x < nb)
    base[threadIdx.x] =
        hist[(long long)threadIdx.x * gridDim.x + blockIdx.x];
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  for (int r = 0; r < kOrderPerThread; ++r) {
    const long long i =
        (long long)blockIdx.x * kOrderLanes + r * kBlock + threadIdx.x;
    const int bin = i < L.n ? (int)bins[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    for (int j = threadIdx.x; j < kWarps * kBins; j += kBlock) count[j] = 0;
    __syncthreads();
    if (bin >= 0 && (peers & below) == 0)
      count[warp * kBins + bin] = __popc(peers);
    __syncthreads();
    if (bin >= 0) {
      int pos = base[bin] + __popc(peers & below);
      for (int w = 0; w < warp; ++w) pos += count[w * kBins + bin];
      order[pos] = (int)i;
    }
    __syncthreads();
    if (threadIdx.x < nb) {
      int t = 0;
      for (int w = 0; w < kWarps; ++w) t += count[w * kBins + threadIdx.x];
      base[threadIdx.x] += t;
    }
    __syncthreads();
  }
}

// Adds this lane's column `cv` of d(ptab), at planar row r, to global
// memory once per distinct row among the lanes of the warp that arrive
// together: they are grouped by r, each group's values are summed by
// shuffles, and the group's first lane adds the nonzero sums. The rows that
// are zero by construction (mtype, ttype, tscale) are skipped.
__device__ __forceinline__ void add_column(float* __restrict__ dst, int NR,
                                           int r, const float (&cv)[KP]) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group peers =
      cg::labeled_partition(cg::coalesced_threads(), r);
  const bool lead = peers.thread_rank() == 0;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    if (j == P_MTYPE || j == P_TTYPE || j == P_TSCALE) continue;
    const float sum = cg::reduce(peers, cv[j], cg::plus<float>());
    if (lead && sum != 0.f) atomicAdd(dst + (long long)j * NR + r, sum);
  }
}

// Adds this lane's column `cv` of d(ktab), at sphere s, to global memory as
// add_column does for d(ptab): once per distinct sphere among the lanes of
// the warp that arrive together. The rows that are zero by construction
// (mtype, ttype, tscale) are skipped.
__device__ __forceinline__ void add_sphere_column(float* __restrict__ dst,
                                                  int S, int s,
                                                  const float (&cv)[KT]) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group peers =
      cg::labeled_partition(cg::coalesced_threads(), s);
  const bool lead = peers.thread_rank() == 0;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j == MTYPE || j == TTYPE || j == TSCALE) continue;
    const float sum = cg::reduce(peers, cv[j], cg::plus<float>());
    if (lead && sum != 0.f) atomicAdd(dst + (long long)j * S + s, sum);
  }
}

template <bool kSph, bool kPla, bool kPShared, bool kDefer, bool kDeferNoise,
          bool kKShared>
__global__ void __launch_bounds__(kBlock)
replay_bwd_kernel(const float* __restrict__ tab,
                  const float* __restrict__ ptab,
                  const float* __restrict__ bg,
                  const float* __restrict__ o0, const float* __restrict__ d0,
                  const float* __restrict__ times,
                  const int* __restrict__ ray_ids,
                  const int* __restrict__ codes, const float* __restrict__ g,
                  const float* __restrict__ cabc,
                  const int* __restrict__ order,
                  Launch L, float* __restrict__ st,
                  float* __restrict__ dtab, float* __restrict__ dptab,
                  float* __restrict__ d_o, float* __restrict__ d_d,
                  float* __restrict__ d_time, float* __restrict__ d_bg) {
  extern __shared__ float smem[];
  const int S = L.n_spheres;
  const int NR = L.n_planar;
  // The block's copies of d_background, then of its tables: d(ktab) in
  // shared memory (kKShared) or by global atomics, then d(ptab) (kPShared).
  // A copy's stride is odd, so one entry of each copy lies in its own bank.
  const int n_tab = kKShared ? KT * S : 0;
  const int n_ptab = (kPla && kPShared) ? KP * NR : 0;
  const int stride = (n_tab + n_ptab) | 1;
  const int n_smem = 3 * kBgCopies + (n_tab + n_ptab ? L.copies * stride : 0);
  for (int j = threadIdx.x; j < n_smem; j += kBlock) smem[j] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float* __restrict__ sbg = smem + 3 * lane;  // this lane's d_background
  float* __restrict__ sdt =                  // its d(ktab)
      smem + 3 * kBgCopies + (lane & (L.copies - 1)) * stride;
  float* __restrict__ spt = sdt + n_tab;     // its d(ptab), kPShared

  // The lane this thread sweeps (its place in the sweep order); its
  // forward values go to the scratch's column `slot`.
  const int slot = blockIdx.x * kBlock + threadIdx.x;
  const int i = slot < L.n ? order[slot] : -1;
  if (i >= 0) {
    const long long n = L.n;
    const int D = L.max_depth;
    const int* __restrict__ lane_codes = codes + (long long)i * D;
    const uint32_t rid = (uint32_t)ray_ids[i];
    const float time = times[i];
    // The radiance cotangent: per lane, or with kDefer per bounce (read in
    // the reverse sweep).
    float gr = 0.f, gg = 0.f, gb = 0.f;
    if constexpr (!kDefer) {
      gr = g[3 * i + 0];
      gg = g[3 * i + 1];
      gb = g[3 * i + 2];
    }

    // ---- forward sweep: re-trace the saved path, keep (o, d, tp) ---------
    float ox = o0[3 * i + 0], oy = o0[3 * i + 1], oz = o0[3 * i + 2];
    float dx = d0[3 * i + 0], dy = d0[3 * i + 1], dz = d0[3 * i + 2];
    float tpr = 1.f, tpg = 1.f, tpb = 1.f;
    int trips = 0;
    for (int k = 0; k < D; ++k) {
      float* __restrict__ sk = st + (long long)k * kState * n + slot;
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
      const int s = kSph ? code_sphere(lane_codes[k], S) : -1;
      const int r = kPla ? code_planar(lane_codes[k], NR) : -1;
      if (s < 0 && r < 0) break;  // miss: background, the path ends
      Bounce b;
      if (!kSph || (kPla && r >= 0)) {
        recompute_planar<kDefer>(ptab, NR, r, L.seed, rid, (uint32_t)k, ox,
                                 oy, oz, dx, dy, dz, b);
      } else {
        recompute<kDefer>(tab, S, s, time, L.t_min, L.seed, rid, (uint32_t)k,
                          ox, oy, oz, dx, dy, dz, b);
      }
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
      const float* __restrict__ sk = st + (long long)k * kState * n + slot;
      ox = sk[0 * n];
      oy = sk[1 * n];
      oz = sk[2 * n];
      dx = sk[3 * n];
      dy = sk[4 * n];
      dz = sk[5 * n];
      tpr = sk[6 * n];
      tpg = sk[7 * n];
      tpb = sk[8 * n];
      if constexpr (kDefer) {
        const float* __restrict__ gk = g + ((long long)i * D + k) * 3;
        gr = gk[0];
        gg = gk[1];
        gb = gk[2];
      }
      const int s = kSph ? code_sphere(lane_codes[k], S) : -1;
      const int r = kPla ? code_planar(lane_codes[k], NR) : -1;
      if (s < 0 && r < 0) {  // miss: rad += tp * bg
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
      if (!kSph || (kPla && r >= 0)) {
        recompute_planar<kDefer>(ptab, NR, r, L.seed, rid, (uint32_t)k, ox,
                                 oy, oz, dx, dy, dz, b);
      } else {
        recompute<kDefer>(tab, S, s, time, L.t_min, L.seed, rid, (uint32_t)k,
                          ox, oy, oz, dx, dy, dz, b);
      }

      // o', d' = alive2 ? (p, nd) : (o, d)
      const float al = b.alive2 ? 1.f : 0.f;
      float cpx = al * cox, cpy = al * coy, cpz = al * coz;
      const float cndx = al * cdx, cndy = al * cdy, cndz = al * cdz;
      cox -= cpx;
      coy -= cpy;
      coz -= cpz;
      cdx -= cndx;
      cdy -= cndy;
      cdz -= cndz;
      if constexpr (kDeferNoise) {
        // A noise record's abc is this bounce's hit point p.
        if (b.noise) {
          const float* __restrict__ ck = cabc + ((long long)i * D + k) * 3;
          cpx += ck[0];
          cpy += ck[1];
          cpz += ck[2];
        }
      }

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
      if constexpr (kDefer) {
        // A deferred texel's cotangent belongs to the host's combine.
        if (!b.table_tex) ctexr = ctexg = ctexb = 0.f;
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

      if (!kSph || (kPla && r >= 0)) {
        // n = sgn * outward, outward = ns0 + u_b*nsu + v_b*nsv
        const float* __restrict__ col = ptab + r;
        const float cnox = b.sgn * cnx, cnoy = b.sgn * cny, cnoz = b.sgn * cnz;
        const float cub = col[P_SUX * NR] * cnox + col[P_SUY * NR] * cnoy +
                          col[P_SUZ * NR] * cnoz;
        const float cvb = col[P_SVX * NR] * cnox + col[P_SVY * NR] * cnoy +
                          col[P_SVZ * NR] * cnoz;
        // u_b = ua.p + ca ;  v_b = ub.p + cb
        const float cqx = cpx + cub * col[P_UAX * NR] + cvb * col[P_UBX * NR];
        const float cqy = cpy + cub * col[P_UAY * NR] + cvb * col[P_UBY * NR];
        const float cqz = cpz + cub * col[P_UAZ * NR] + cvb * col[P_UBZ * NR];

        // p = o + t d
        const float ct = dx * cqx + dy * cqy + dz * cqz;
        cox += cqx;
        coy += cqy;
        coz += cqz;
        cdx += b.t * cqx;
        cdy += b.t * cqy;
        cdz += b.t * cqz;

        // t = (o.n - k) / df, df = -d.n:  dt/do = n/df, dt/dd = t n/df,
        // dt/dn = p/df, dt/dk = -1/df
        const float cti = ct * b.inv_df;
        cox += cti * b.pnx;
        coy += cti * b.pny;
        coz += cti * b.pnz;
        cdx += cti * b.t * b.pnx;
        cdy += cti * b.t * b.pny;
        cdz += cti * b.t * b.pnz;

        float cv[KP];  // this bounce's column of d(ptab)
        cv[P_NX] = cti * b.px;
        cv[P_NY] = cti * b.py;
        cv[P_NZ] = cti * b.pz;
        cv[P_K] = -cti;
        cv[P_UAX] = cub * b.px;
        cv[P_UAY] = cub * b.py;
        cv[P_UAZ] = cub * b.pz;
        cv[P_CA] = cub;
        cv[P_UBX] = cvb * b.px;
        cv[P_UBY] = cvb * b.py;
        cv[P_UBZ] = cvb * b.pz;
        cv[P_CB] = cvb;
        cv[P_S0X] = cnox;
        cv[P_S0Y] = cnoy;
        cv[P_S0Z] = cnoz;
        cv[P_SUX] = b.ub * cnox;
        cv[P_SUY] = b.ub * cnoy;
        cv[P_SUZ] = b.ub * cnoz;
        cv[P_SVX] = b.vb * cnox;
        cv[P_SVY] = b.vb * cnoy;
        cv[P_SVZ] = b.vb * cnoz;
        cv[P_MTYPE] = 0.f;
        cv[P_FUZZ] = cfuzz;
        cv[P_IOR] = cior;
        cv[P_TTYPE] = 0.f;
        cv[P_C1R] = b.use2 ? 0.f : ctexr;
        cv[P_C1G] = b.use2 ? 0.f : ctexg;
        cv[P_C1B] = b.use2 ? 0.f : ctexb;
        cv[P_C2R] = b.use2 ? ctexr : 0.f;
        cv[P_C2G] = b.use2 ? ctexg : 0.f;
        cv[P_C2B] = b.use2 ? ctexb : 0.f;
        cv[P_TSCALE] = 0.f;
        if constexpr (kPShared) {
#pragma unroll
          for (int j = 0; j < KP; ++j) acc(spt, NR, j, r, cv[j]);
        } else {
          add_column(dptab, NR, r, cv);
        }
      } else {
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

        if constexpr (kKShared) {
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
        } else {
          float kv[KT];  // this bounce's column of d(ktab)
          kv[AX] = ccx;
          kv[AY] = ccy;
          kv[AZ] = ccz;
          kv[BX] = time * ccx;
          kv[BY] = time * ccy;
          kv[BZ] = time * ccz;
          kv[R] = c_r;
          kv[R2] = -cct;
          kv[MTYPE] = 0.f;
          kv[FUZZ] = cfuzz;
          kv[IOR] = cior;
          kv[TTYPE] = 0.f;
          kv[C1R] = b.use2 ? 0.f : ctexr;
          kv[C1G] = b.use2 ? 0.f : ctexg;
          kv[C1B] = b.use2 ? 0.f : ctexb;
          kv[C2R] = b.use2 ? ctexr : 0.f;
          kv[C2G] = b.use2 ? ctexg : 0.f;
          kv[C2B] = b.use2 ? ctexb : 0.f;
          kv[TSCALE] = 0.f;
          add_sphere_column(dtab, S, s, kv);
        }
      }
    }
    d_o[3 * i + 0] = cox;
    d_o[3 * i + 1] = coy;
    d_o[3 * i + 2] = coz;
    d_d[3 * i + 0] = cdx;
    d_d[3 * i + 1] = cdy;
    d_d[3 * i + 2] = cdz;
    d_time[i] = ctime;
  }

  // ---- one global add per nonzero entry, the copies summed ---------------
  __syncthreads();
  const float* __restrict__ tabs = smem + 3 * kBgCopies;
  for (int j = threadIdx.x; j < n_tab + n_ptab; j += kBlock) {
    float v = 0.f;
    for (int c = 0; c < L.copies; ++c) v += tabs[c * stride + j];
    if (v != 0.f) atomicAdd(j < n_tab ? dtab + j : dptab + (j - n_tab), v);
  }
  if (threadIdx.x < 3) {
    float v = 0.f;
    for (int c = 0; c < kBgCopies; ++c) v += smem[3 * c + threadIdx.x];
    if (v != 0.f) atomicAdd(d_bg + threadIdx.x, v);
  }
}

// The operands of one launch.
struct Args {
  const float *ktab, *ptab, *bg, *o, *d, *time;
  const int *ray_id, *codes;
  const float *g, *cabc;
  const int* order;
  float *scratch, *dtab, *dptab, *d_o, *d_d, *d_time, *d_bg;
};

template <bool kSph, bool kPla, bool kPShared, bool kDefer, bool kDeferNoise,
          bool kKShared>
int launch(const Args& a, const Launch& L, long long smem,
           cudaStream_t stream) {
  auto* kernel =
      replay_bwd_kernel<kSph, kPla, kPShared, kDefer, kDeferNoise, kKShared>;
  // Shared memory above the default 48 KB needs the attribute, set once per
  // device to the largest size launched there so far.
  constexpr int kMaxDevices = 64;
  static long long opted[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || smem > opted[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) opted[dev] = smem;
    }
  }
  const int grid = (L.n + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, (size_t)smem, stream>>>(
      a.ktab, a.ptab, a.bg, a.o, a.d, a.time, a.ray_id, a.codes, a.g, a.cabc,
      a.order, L, a.scratch, a.dtab, a.dptab, a.d_o, a.d_d, a.d_time,
      a.d_bg);
  return (int)cudaGetLastError();
}

// The family instantiation, dispatched on the deferred-texture flags.
template <bool kSph, bool kPla, bool kPShared, bool kKShared = true>
int launch_tex(const Args& a, bool defer, const Launch& L, long long smem,
               cudaStream_t stream) {
  if (!defer)
    return launch<kSph, kPla, kPShared, false, false, kKShared>(a, L, smem,
                                                                stream);
  if (a.cabc)
    return launch<kSph, kPla, kPShared, true, true, kKShared>(a, L, smem,
                                                              stream);
  return launch<kSph, kPla, kPShared, true, false, kKShared>(a, L, smem,
                                                             stream);
}

}  // namespace bwd
}  // namespace rtw

namespace {

// Shared memory of `copies` copies of tables of n_tab floats, with the
// background's copies, in bytes.
long long smem_bytes(long long n_tab, int copies) {
  using namespace rtw::bwd;
  return (3LL * kBgCopies + (n_tab > 0 ? copies * (n_tab | 1) : 0)) *
         (long long)sizeof(float);
}

// Bins of the sweep order for codes of max_depth bounces.
int order_bins(int max_depth) {
  using namespace rtw::bwd;
  return (max_depth < kBins - 1 ? max_depth : kBins - 1) + 1;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for S spheres and, when d(ptab) is kept in
// shared memory, R planar primitives (else pass 0), in bytes, with one copy
// of the tables; pass S = 0 when d(ktab) is reduced by global atomics.
long long rtw_replay_bwd_smem_bytes(int n_spheres, int n_planar_shared) {
  return smem_bytes((long long)rtw::bwd::KT * n_spheres +
                        (long long)rtw::bwd::KP * n_planar_shared, 1);
}

// Ints of the sweep order's workspace for n lanes of max_depth bounces: the
// order (n), each order block's first position per bin, and each lane's bin
// (a byte).
long long rtw_replay_bwd_order_ints(int n, int max_depth) {
  using namespace rtw::bwd;
  const long long blocks = ((long long)n + kOrderLanes - 1) / kOrderLanes;
  return (long long)n + order_bins(max_depth) * blocks + ((long long)n + 3) / 4;
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

// Runs the replay backward for n lanes on `stream`: sphere table `ktab`
// (KT x n_spheres) and planar table `ptab` (KP x n_planar), either count 0
// (and its table unused) but not both. `dtab`, `dptab` and `d_bg` must be
// zero on entry: the kernel adds into them. With `sphere_shared` each block
// reduces d(ktab) in shared memory, and with `planar_shared` (which needs
// `sphere_shared` when the scene has spheres) d(ptab) too; else each by
// warp-aggregated global atomics. `scratch` holds max_depth * 9 * n floats
// and `order` rtw_replay_bwd_order_ints(n, max_depth) ints. With `defer`
// the cotangent `g` is per bounce (n x max_depth x 3) and noise and image
// texels are 1.0 (K7); a non-null `cabc` (n x max_depth x 3) then adds to
// the noise records' hit points. Four launches: the three order kernels,
// then the replay backward. Returns the first CUDA error (0 on success); it
// does not sync.
int rtw_replay_bwd(const float* ktab, int n_spheres, const float* ptab,
                   int n_planar, int sphere_shared, int planar_shared,
                   const float* bg,
                   const float* o, const float* d, const float* time,
                   const int* ray_id, const int* codes, const float* g,
                   const float* cabc, int defer, int n, int max_depth,
                   float t_min, unsigned int seed, int* order,
                   float* scratch, float* dtab, float* dptab, float* d_o,
                   float* d_d, float* d_time, float* d_bg, void* stream) {
  using namespace rtw::bwd;
  if (n <= 0) return 0;
  if (n_spheres <= 0 && n_planar <= 0) return (int)cudaErrorInvalidValue;
  if (cabc && !defer) return (int)cudaErrorInvalidValue;
  if (n_spheres > 0 && planar_shared && !sphere_shared)
    return (int)cudaErrorInvalidValue;
  // As many copies of the shared tables as fit kCopyBudget, up to one per
  // lane of a warp.
  const long long n_tab = (sphere_shared ? (long long)KT * n_spheres : 0) +
                          (planar_shared ? (long long)KP * n_planar : 0);
  int copies = 1;
  while (copies < kMaxCopies && smem_bytes(n_tab, 2 * copies) <= kCopyBudget)
    copies *= 2;
  const long long smem = smem_bytes(n_tab, copies);
  const Launch L{n, n_spheres, n_planar, max_depth, t_min, seed, copies};
  const cudaStream_t st = (cudaStream_t)stream;

  // The sweep order: count, scan, scatter.
  const int nb = order_bins(max_depth);
  const int blocks = (int)(((long long)n + kOrderLanes - 1) / kOrderLanes);
  int* hist = order + n;
  uint8_t* bins = (uint8_t*)(hist + (long long)nb * blocks);
  order_count_kernel<<<blocks, kBlock, 0, st>>>(codes, L, nb, bins, hist);
  order_scan_kernel<<<1, 1024, 0, st>>>(hist, nb * blocks);
  order_scatter_kernel<<<blocks, kBlock, 0, st>>>(bins, L, nb, hist, order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Args a{ktab, ptab, bg, o, d, time, ray_id, codes, g, cabc,
               order, scratch, dtab, dptab, d_o, d_d, d_time, d_bg};

  if (n_spheres > 0 && !sphere_shared) {
    if (n_planar == 0)
      return launch_tex<true, false, true, false>(a, defer, L, smem, st);
    return launch_tex<true, true, false, false>(a, defer, L, smem, st);
  }
  if (n_planar == 0)
    return launch_tex<true, false, true>(a, defer, L, smem, st);
  if (n_spheres == 0) {
    if (planar_shared)
      return launch_tex<false, true, true>(a, defer, L, smem, st);
    return launch_tex<false, true, false>(a, defer, L, smem, st);
  }
  if (planar_shared) return launch_tex<true, true, true>(a, defer, L, smem, st);
  return launch_tex<true, true, false>(a, defer, L, smem, st);
}

}  // extern "C"
