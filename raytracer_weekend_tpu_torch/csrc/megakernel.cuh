// Fused forward path-tracing kernel, a lane per thread (or per group of G
// threads in the phased launches): spheres, the planar family
// (axis-aligned rects and triangles in one table) and
// constant-density media (kVol), with noise and image texels deferred to
// the host (kDefer) and the lane state written out and read back between
// depth phases (kPhase). The templates live here; megakernel.cu,
// megakernel_vp.cu and megakernel_media.cu instantiate them, so that three
// nvcc processes compile them.
//
// Replaces: raytracer_weekend_tpu/ops/pallas/megakernel.py:_kernel, its
// sphere branch (has_sph: K1, and K1-emit with emit_paths=True), its planar
// branch (has_planar, tables from _build_planar_tables: K3), its
// deferred-texture record arm (defer_tex=True: K6a), its volume branch
// (n_vol, the table of _build_vol_par: K5) and its phase I/O (phase_in /
// phase_out of render_fused_deep: K6b), reached through render_fused ->
// _render_fused_core -> pl.pallas_call.
// It computes what that kernel computes, not its TPU layout: per lane
// (lane = pixel*spp + sample) the thin-lens primary ray with a shutter time,
// then up to max_depth bounces of closest hit over the moving spheres, the
// planar primitives and the media, the hit record (signed-radius outward
// normal for a sphere; the raw, unnormalised barycentric shading normal
// ns0 + u*nsu + v*nsv for a planar primitive), the front-face flip,
// solid/checker/uv-debug texture, and the Lambertian/Metal/Dielectric/
// DiffuseLight scatter, or the isotropic scatter of a medium; out come the
// lane's radiance (3 x f32) and its traced segment count (int32). With kEmit
// it also writes the lane's winner code per bounce, int32 1 + 4*sphere,
// 2 + 4*planar (the unified planar index: rects first, then triangles) or
// 3 + 4*volume where the lane was alive and hit, 0 after a miss and for the
// bounces after the lane left the loop: the record the backward replays
// (csrc/replay_bwd.cu, replay.py). kSph and kPla say which families the
// scene has; in the sphere-only instantiation (kSph, !kPla) every planar
// statement sits behind `if constexpr` or a constant-false test, so it
// compiles to the sphere kernel as it was before the planar branch existed,
// as kEmit = false does without the codes, and likewise every kVol and
// kPhase statement.
//
// The sphere test keeps the large terms apart (the JAX kernel's K0 row, the
// staged ops/sphere.py grouping):
//     hb = o.d - d.c(t),  c(t) = c0 + w*dc,
//     cc = (|o|^2 - 2 o.c(t)) + (K0 + w*(K1 + w*K2)),
// K0 = |c0|^2 - r^2, K1 = 2 c0.dc and K2 = |dc|^2 from the host in float64.
// Computing o - c first rounded away the offset of an origin on the
// radius-1000 ground (ulp(1000) = 6e-5), so rays leaving it re-hit it.
//
// With kDefer (scenes with noise or image textures) a noise or image texel
// is shaded as 1.0 and the lane writes, per bounce, its deferred-texture
// record in lane-major order: ctb (D x 3 f32) the bounce's radiance
// contribution (miss background or emission, texel 1.0), abc (D x 3 f32)
// the hit point for a noise texel, the pre-flip outward normal for a
// sphere's image texel and (u, v, 0) in the winner's in-plane coordinates
// for a planar image texel, else 0, and dcode (D x int32) +(texid + 1), or
// -(texid + 1) for a planar winner, where the texel was deferred, else 0;
// bounces after the lane left the loop, and medium scatters, read as zero
// records. The host folds the true texels back in (ops/cuda/megakernel.py:
// combine_deferred); the radiance the kernel writes then lacks them.
//
// With kVol each live lane tests every medium per bounce (ops/volume.py):
// the ray moved into the medium's frame (Y-rotation, translation), the
// boundary's [enter, exit] from the sphere's roots or the box's slabs (NaN
// from 0 * inf where a ray runs parallel to a slab propagates through the
// min/max and compares false, as torch's does), clamped to t_min and to 0,
// the scatter distance -1/density * log(U) (times 1/ln 10 under the
// reference's log10 flag, a launch parameter), and the candidate
// enter + distance/|d| against the surfaces' best with strict <. A medium
// winner scatters isotropically (a direction in the unit ball, not unit
// length: the next bounce's a = |d|^2 is < 1) and attenuates by the
// medium's solid albedo.
//
// With kPhase the lane writes its state after the launch's bounces, 15
// floats (o, d, throughput, radiance, time, alive, segments), and, given a
// state in, reads it and its global lane id (compacted lanes are not
// contiguous) instead of casting the primary ray, and runs bounces
// d0 .. d0 + max_depth - 1, the random numbers keyed on the absolute depth,
// so a lane's path does not depend on its phase or batch position.
//
// The arithmetic follows the staged reference (integrator.
// trace_rays in both packages), which the wrapper's plain version reproduces
// in torch; the planar test is the JAX kernel's affine form
//     t = (k - n.o)/(n.d),  u = ua.p + ca,  v = ub.p + cb,
//     hit: t >= t_min, u >= 0, v >= 0, v <= 1, u + flag*v <= 1
// (flag 0 for a rect, 1 for a triangle), where the plain version uses the
// staged (k - o_f)/d_f and scalar triple products: the two differ by
// rounding on wall corners and cuboid edges. A padded or degenerate row has
// all-zero coefficients, so t = 0/0 = NaN and it never hits.
//
// What bounds it on an H100: FP32 issue and divergence, not bytes. Every
// live lane tests every primitive each bounce (jumpy_balls: 486 spheres x
// ~2.6 segments per lane, 29 FP32 operations per test as chip_smoke.py
// counts them; the cow: 5,805 planar rows; book2: 1,006 spheres and 2,401
// rects), and lanes of a warp
// die at different depths and take different material branches. Outputs
// are 16 bytes per lane (plus 4 per bounce with the codes, 28 with the
// records, 120 of state per phase).
//
// What the design does about it:
// - The sphere-only single-pass launches (K1, K1-emit, K6a on sphere
//   scenes) are their own kernel, sphere_kernel below: persistent warps
//   that refill dead lanes, the packed sphere rows in shared memory, and
//   the deferred records as one 32-byte row each (see the note above
//   sphere_kernel). render_kernel
//   keeps the sphere-only phased launches (K6b), whose sphere test is the
//   direct form (one lerp of the center, two dots, a compare on the
//   discriminant, the square root behind `disc > 0`) over the
//   structure-of-arrays table read through `const __restrict__`.
// - The single-pass media launches (K5, K5-emit, K6a on media scenes) are
//   their own kernel too, media_kernel below, on sphere_kernel's scheme:
//   persistent warps that refill dead lanes, the volume, sphere and planar
//   tables read from global memory through L1 and L2 (see the note above
//   media_kernel). So are the phased launches with media at one lane a ray
//   (G = 1: a phase whose live lanes fill the card, book2's first phase at
//   full frame), with phase I/O (kPhase): there a block walking its 128
//   lanes in lockstep left over half its lane-bounces to dead lanes.
//   render_kernel keeps media for the phased launches at G > 1 only.
// - The planar loop (K3, every launch with planar rows): the block stages
//   the packed plane rows (nx, ny, nz, k), one float4 each, in 512-row
//   tiles of dynamic shared memory by cp.async, double-buffered, so the
//   next tile is in flight while the block tests the current one; a test
//   reads one 16-byte broadcast instead of four L1 loads. The division is
//   taken only by rows that pass a division-free prefilter
//   (plane_candidate) of num = k - n.o against den = n.d, t_min and the
//   running best, and only its candidates read their in-plane rows
//   (ua, ca), (ub, cb), flag from global memory. The block walks the
//   bounces together (a dead or out-of-range lane joins the barriers and
//   tests nothing) and stops when __syncthreads_or(alive) is 0. Bound now:
//   FP32 issue of each row's two dots and prefilter across all live lanes,
//   and lanes idling in a block whose other lanes live on (PERF.md §6).
// - Phased launches (K6b) carry a ray on a group of G lanes of one warp
//   (G from the live count, `group`): rank j tests spheres and planar rows
//   j mod G, and the group merges by shuffles the lexicographic minimum of
//   (t, family, index), spheres before planar rows and the lower index on
//   an exact tie, which is what the serial strict-< loops choose; every
//   rank then shades and scatters the same bits (keyed on seed, ray id and
//   absolute depth) and rank 0 writes. The tail of a deep render (a few
//   thousand long paths) then fills the card. Bound: the first phase as
//   K3's loop; the tail by the merges and the redundant shading. A phase
//   at G = 1 with media is media_kernel's (above); the grouped tail keeps
//   the block walk, since a group's ranks must stay in one warp through
//   every shuffle, and without media the phased launches stay here too:
//   media_kernel's arithmetic is written to be bitwise only the kVol
//   instantiations'.
// - The families share one running closest t, so the planar loop starts
//   from the sphere winner and strict `<` keeps the sphere on an exact tie
//   and the lowest index among planar ties, as argmin and the family merge
//   do in the plain version. The material and texture rows sit at the same
//   row numbers in both tables, so the shading reads the winner's column
//   through one pointer and one stride; only the winning material's branch
//   draws its random numbers.
// Later work: ray sorting by material, a BVH, the same tiles for spheres
// in the launches with planar rows or media.
//
// Numerics: no fast math. The ground is a radius-1000 sphere with a checker
// of frequency 10, so sinf takes arguments in the thousands; __sinf would
// flip checker cells; the slab test needs IEEE division by 0.
// sinf/cosf/sqrtf/cbrtf/logf and IEEE division throughout.
//
// Build (the wrapper does this at first use, see ops/cuda/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o librtw.so megakernel.cu megakernel_vp.cu \
//        megakernel_media.cu
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pcg4d.cuh"
#include "plane_tiles.cuh"

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
  TEXID,              // texture row id (the deferred record's code)
  K0,                 // |c0|^2 - r^2, or +inf for a padding row
  K1, K2,             // 2 c0.dc, |dc|^2
  N_ROWS
};

// Planar table rows, each R floats long (ops/cuda/megakernel.py:
// PLANAR_ROWS). Rows MTYPE..TSCALE (11-21) are the sphere table's rows of
// the same names: the shading code reads either table's winner column.
enum PRow {
  PNX, PNY, PNZ,      // plane normal n (unnormalised for a triangle)
  PK,                 // plane offset: t = (k - n.o)/(n.d)
  UAX, UAY, UAZ,      // u = ua.p + ca
  CA,
  UBX, UBY, UBZ,      // v = ub.p + cb
  P_MTYPE, P_FUZZ, P_IOR, P_TTYPE,
  P_C1R, P_C1G, P_C1B,
  P_C2R, P_C2G, P_C2B,
  P_TSCALE,
  CB,
  FLAG,               // 0 rect (u <= 1), 1 triangle (u + v <= 1)
  NS0X, NS0Y, NS0Z,   // shading normal = ns0 + u*nsu + v*nsv
  NSUX, NSUY, NSUZ,
  NSVX, NSVY, NSVZ,
  TU0, TUU, TUV,      // uv-debug u = tu0 + u*tuu + v*tuv
  TV0, TVU, TVV,      //          v = tv0 + u*tvu + v*tvv
  P_TEXID,            // texture row id (the deferred record's code)
  N_PROWS
};
static_assert(P_MTYPE == MTYPE && P_FUZZ == FUZZ && P_IOR == IOR &&
                  P_TTYPE == TTYPE && P_C1R == C1R && P_C2R == C2R &&
                  P_TSCALE == TSCALE,
              "the shading rows must be shared by both tables");

// Volume table columns, a row of N_VCOLS floats per medium
// (ops/cuda/megakernel.py:VOL_COLS, the JAX _build_vol_par layout plus a
// valid flag: the [1, 0] slab of an invalid JAX row is the unit box again
// under min/max, so the kernel skips invalid rows instead).
enum VCol {
  V_ISBOX,
  V_CX, V_CY, V_CZ, V_R2,   // sphere boundary (object frame)
  V_B0X, V_B0Y, V_B0Z,      // box boundary (object frame)
  V_B1X, V_B1Y, V_B1Z,
  V_COS, V_SIN,             // Y-rotation
  V_OFFX, V_OFFY, V_OFFZ,   // translation
  V_NID,                    // -1/density
  V_CR, V_CG, V_CB,         // isotropic albedo (solid color)
  V_VALID,
  N_VCOLS
};

// The lane state between depth phases (kPhase), 15 floats per lane.
enum StateCol {
  S_OX, S_OY, S_OZ, S_DX, S_DY, S_DZ, S_TPR, S_TPG, S_TPB,
  S_RR, S_RG, S_RB, S_TIME, S_ALIVE, S_SEG, N_STATE
};

// Camera and background, as megakernel.py:_pack_par packs them.
enum Par {
  P_ORIGIN = 0, P_LOWER_LEFT = 3, P_HORIZONTAL = 6, P_VERTICAL = 9,
  P_U = 12, P_V = 15, P_LENS_RADIUS = 18, P_TIME0 = 19, P_DTIME = 20,
  P_BACKGROUND = 21, N_PAR = 24
};

constexpr int kBlock = 128;
// Plane rows (one float4 each) per shared-memory tile; a block holds two,
// the next one's copy in flight while it tests the current one.
constexpr int kTile = 512;
constexpr int kTileBytes = 2 * kTile * (int)sizeof(float4);

struct Launch {
  long long lane_start;
  int n_chunk, n_spheres, n_planar, width, height, spp, max_depth;
  float t_min;
  uint32_t seed;
};

// Media (kVol) and phase I/O (kPhase). st_in and gid are null for the
// first phase, which casts its primary rays.
struct Extra {
  const float* __restrict__ vtab;   // (n_volumes, N_VCOLS)
  int n_volumes;
  float log_scale;                  // 1/ln 10 (the log10 quirk) or 1
  const float* __restrict__ st_in;  // (n_chunk, N_STATE)
  const int* __restrict__ gid;      // (n_chunk,) global lane ids
  float* __restrict__ st_out;       // (n_chunk, N_STATE)
  int d0;                           // absolute depth of the first bounce
  int group;  // lanes per ray of a phased launch (1, 2, 4, ..., 32), else 1
};

// min/max that return NaN when either operand is NaN (torch.minimum/
// maximum); fminf/fmaxf would drop it.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// The block's dynamic shared memory: 2 x kTile plane rows.
__device__ __forceinline__ float4* plane_tiles() {
  extern __shared__ float4 tiles[];
  return tiles;
}

// The block's copy of plane rows [base, base + kTile) of R into `dst`.
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float4* __restrict__ src,
                                           int R, int base) {
  const int cnt = min(kTile, R - base);
  for (int q = threadIdx.x; q < cnt; q += kBlock)
    cp_async16(dst + q, src + base + q);
}

// The per-lane rows of the deferred-texture records (kDefer).
struct Records {
  float* __restrict__ ctb;   // (n_chunk, max_depth, 3)
  float* __restrict__ abc;   // (n_chunk, max_depth, 3)
  int* __restrict__ dcode;   // (n_chunk, max_depth)
};

__device__ __forceinline__ void put_record(const Records& R, long long k,
                                           float cr, float cg, float cb,
                                           float a, float b, float c,
                                           int code) {
  R.ctb[3 * k + 0] = cr;
  R.ctb[3 * k + 1] = cg;
  R.ctb[3 * k + 2] = cb;
  R.abc[3 * k + 0] = a;
  R.abc[3 * k + 1] = b;
  R.abc[3 * k + 2] = c;
  R.dcode[k] = code;
}

template <bool kEmit, bool kSph, bool kPla, bool kDefer, bool kVol,
          bool kPhase>
__global__ void __launch_bounds__(kBlock)
render_kernel(const float* __restrict__ tab, const float* __restrict__ ptab,
              const float* __restrict__ par, Launch L, Extra X,
              float* __restrict__ rad, int* __restrict__ seg,
              int* __restrict__ codes, Records rec,
              const float4* __restrict__ ptest) {
  // Every launch here has planar tiles or lane groups (the sphere-only
  // single pass is sphere_kernel's), so the whole block walks the bounces
  // together: no thread returns or leaves the loop early, since it must
  // join every barrier and shuffle.
  static_assert(kPla || kPhase,
                "the sphere-only single pass is sphere_kernel's");
  static_assert(!kVol || kPhase,
                "the single pass with media is media_kernel's");
  const int G = kPhase ? X.group : 1;    // lanes per ray, a power of two
  const int tid = blockIdx.x * kBlock + threadIdx.x;
  const int i = kPhase ? tid / G : tid;  // the ray (lane of the frame)
  const int j = kPhase ? tid - i * G : 0;  // this thread's rank in its group
  const bool lead = j == 0;              // the group's writer
  const bool in_range = i < L.n_chunk;
  const int S = L.n_spheres;
  const int R = L.n_planar;
  const float* __restrict__ c0x = tab + C0X * S;
  const float* __restrict__ c0y = tab + C0Y * S;
  const float* __restrict__ c0z = tab + C0Z * S;
  const float* __restrict__ dcx = tab + DCX * S;
  const float* __restrict__ dcy = tab + DCY * S;
  const float* __restrict__ dcz = tab + DCZ * S;
  const float* __restrict__ t0s = tab + T0 * S;
  const float* __restrict__ inv_dt = tab + INV_DT * S;
  const float* __restrict__ k0s = tab + K0 * S;
  const float* __restrict__ k1s = tab + K1 * S;
  const float* __restrict__ k2s = tab + K2 * S;

  const bool resume = kPhase && X.st_in != nullptr;
  const long long lane = resume ? (in_range ? (long long)X.gid[i] : 0)
                                : L.lane_start + i;
  const uint32_t rid = (uint32_t)lane;
  // A lane out of range only joins the barriers: it never uses these.
  float ox, oy, oz, dx, dy, dz, time;
  float tpr = 1.f, tpg = 1.f, tpb = 1.f;  // throughput
  float rr = 0.f, rg = 0.f, rb = 0.f;     // radiance
  int nseg = 0;
  bool alive = in_range;
  if (resume) {  // the state the previous phase wrote (kPhase only)
    if (in_range) {
      const float* __restrict__ st = X.st_in + (long long)i * N_STATE;
      ox = st[S_OX]; oy = st[S_OY]; oz = st[S_OZ];
      dx = st[S_DX]; dy = st[S_DY]; dz = st[S_DZ];
      tpr = st[S_TPR]; tpg = st[S_TPG]; tpb = st[S_TPB];
      rr = st[S_RR]; rg = st[S_RG]; rb = st[S_RB];
      time = st[S_TIME];
      alive = st[S_ALIVE] > 0.f;
      nseg = (int)st[S_SEG];
    }
  } else {
    // ---- primary ray (integrator._pixel_rays + camera.get_rays) ---------
    const long long pix = lane / L.spp;
    const float col = (float)(pix % L.width);
    const float row = (float)(L.height - 1 - pix / L.width);  // bottom-up

    const float4 uj = rand4(L.seed, rid, 0u, SALT_PIXEL_JITTER);
    const float fs = (col + uj.x) / (float)(L.width - 1);
    const float ft = (row + uj.y) / (float)(L.height - 1);

    const float4 ul = rand4(L.seed, rid, 0u, SALT_LENS);
    const float lr = sqrtf(ul.x);
    const float lphi = TWO_PI_F * ul.y;
    const float lens = par[P_LENS_RADIUS];
    const float rdx = lens * (lr * cosf(lphi));
    const float rdy = lens * (lr * sinf(lphi));

    time = par[P_TIME0] + rand4(L.seed, rid, 0u, SALT_TIME).x * par[P_DTIME];

    float o[3], d[3];
    for (int k = 0; k < 3; ++k) {
      const float off = par[P_U + k] * rdx + par[P_V + k] * rdy;
      o[k] = par[P_ORIGIN + k] + off;
      d[k] = par[P_LOWER_LEFT + k] + fs * par[P_HORIZONTAL + k] +
             ft * par[P_VERTICAL + k] - par[P_ORIGIN + k] - off;
    }
    ox = o[0]; oy = o[1]; oz = o[2];
    dx = d[0]; dy = d[1]; dz = d[2];
  }
  const int seg0 = nseg;  // segments before this launch's bounces
  // This lane's row of the (n_chunk, max_depth) codes.
  int* __restrict__ lane_codes = kEmit ? codes + (long long)i * L.max_depth
                                       : nullptr;
  // This lane's records: record k sits at index lane0 + k.
  const long long lane0 = (long long)i * L.max_depth;

  for (int k = 0; k < L.max_depth; ++k) {
    // The block leaves together, once all are dead.
    if (!__syncthreads_or(alive)) break;
    // The absolute depth keys the random numbers.
    const int depth = kPhase ? X.d0 + k : k;
    if (alive) ++nseg;  // alive at the start of the bounce

    // ---- closest sphere: strict < keeps the first minimum ----------------
    // Rank j of a group tests spheres s = j (mod G).
    // |d|^2 (and |o|^2, o.d below): in the kernels without media, nvcc's
    // choice of which product to fuse moved with unrelated edits of the
    // kernel and flipped lanes, so there the contraction it made before is
    // written out; the media kernels keep the compiler's.
    const float a =
        kVol ? dx * dx + dy * dy + dz * dz
             : __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
    const float inv_a = 1.0f / a;
    float best = INFINITY;
    int win = -1;
    if constexpr (kSph) {
      if (alive) {
        const float oo =
            kVol ? ox * ox + oy * oy + oz * oz
                 : __fmaf_rn(oz, oz, __fmaf_rn(oy, oy, __fmul_rn(ox, ox)));
        const float od =
            kVol ? ox * dx + oy * dy + oz * dz
                 : __fmaf_rn(oz, dz, __fmaf_rn(oy, dy, __fmul_rn(ox, dx)));
        for (int s = j; s < S; s += G) {
          const float w = (time - t0s[s]) * inv_dt[s];
          const float cx = c0x[s] + w * dcx[s];
          const float cy = c0y[s] + w * dcy[s];
          const float cz = c0z[s] + w * dcz[s];
          const float hb = od - (dx * cx + dy * cy + dz * cz);
          const float cc = (oo - 2.0f * (ox * cx + oy * cy + oz * cz)) +
                           (k0s[s] + w * (k1s[s] + w * k2s[s]));
          const float disc = hb * hb - a * cc;
          if (disc > 0.f) {
            const float sq = sqrtf(disc);
            float root = (-hb - sq) * inv_a;
            if (!(root >= L.t_min)) root = (-hb + sq) * inv_a;  // t_min
            if (root >= L.t_min && root < best) {
              best = root;
              win = s;
            }
          }
        }
      }
    }

    // ---- closest planar primitive, against the sphere winner's t --------
    // The block stages the packed plane rows (n, k) tile by tile in shared
    // memory, the next tile's copy in flight while it tests this one; rank
    // j of a group tests rows r = j (mod G). Only a row that passes the
    // division-free prefilter takes the division, and only a row with
    // t >= t_min && t < best reads its in-plane rows.
    bool planar = false;     // the winner is planar primitive `win`
    float bu = 0.f, bv = 0.f;  // its in-plane / barycentric coordinates
    if constexpr (kPla) {
      float4* __restrict__ tiles = plane_tiles();
      const int n_tiles = (R + kTile - 1) / kTile;
      stage_tile(tiles, ptest, R, 0);
      cp_async_commit();
      for (int tt = 0; tt < n_tiles; ++tt) {
        if (tt + 1 < n_tiles)
          stage_tile(tiles + ((tt + 1) & 1) * kTile, ptest, R,
                     (tt + 1) * kTile);
        cp_async_commit();
        cp_async_wait_prev();  // tile tt has landed (this thread's copies)
        __syncthreads();       // ... and every thread's
        if (alive) {
          const float4* __restrict__ buf = tiles + (tt & 1) * kTile;
          const int base = tt * kTile;
          const int cnt = min(kTile, R - base);
          for (int q = j; q < cnt; q += G) {
            const float4 pl = buf[q];  // (nx, ny, nz, k)
            const float num = pl.w - (pl.x * ox + pl.y * oy + pl.z * oz);
            const float den = pl.x * dx + pl.y * dy + pl.z * dz;
            if (!plane_candidate(num, den, L.t_min, best)) continue;
            const float t = num / den;
            if (t >= L.t_min && t < best) {  // NaN (a padded row) fails
              const int r = base + q;
              const float4* __restrict__ in = ptest + R + 3 * r;
              const float4 ua = in[0], ub = in[1];  // (ua, ca), (ub, cb)
              const float flag = in[2].x;
              const float hx = ox + t * dx;
              const float hy = oy + t * dy;
              const float hz = oz + t * dz;
              const float u = ua.x * hx + ua.y * hy + ua.z * hz + ua.w;
              const float v = ub.x * hx + ub.y * hy + ub.z * hz + ub.w;
              if (u >= 0.f && v >= 0.f && v <= 1.f && u + flag * v <= 1.f) {
                best = t;
                win = r;
                planar = true;
                bu = u;
                bv = v;
              }
            }
          }
        }
        __syncthreads();  // every thread is done with buffer tt & 1
      }
    }

    // ---- the group's winner: lexicographic min of (t, family, index) ------
    // Spheres rank before planar rows and an exact tie keeps the lower
    // index, as the serial strict-< loops choose; u and v ride along.
    if constexpr (kPhase) {
      int fam = win < 0 ? 2 : (planar ? 1 : 0);
      for (int off = G >> 1; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, best, off);
        const int of = __shfl_xor_sync(0xffffffffu, fam, off);
        const int ow = __shfl_xor_sync(0xffffffffu, win, off);
        const float ou = __shfl_xor_sync(0xffffffffu, bu, off);
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        if (ot < best ||
            (ot == best && (of < fam || (of == fam && ow < win)))) {
          best = ot;
          fam = of;
          win = ow;
          bu = ou;
          bv = ov;
        }
      }
      planar = fam == 1;
    }

    if (!alive) continue;  // a dead lane only joins the barriers
    // ---- closest medium scatter, against the surfaces' best (ops/volume) -
    int vwin = -1;
    if constexpr (kVol) {
      const float ray_len = sqrtf(a);
      for (int v = 0; v < X.n_volumes; ++v) {
        const float* __restrict__ vp = X.vtab + v * N_VCOLS;
        if (vp[V_VALID] == 0.f) continue;
        const float cth = vp[V_COS], sth = vp[V_SIN];
        const float otx = ox - vp[V_OFFX];
        const float oty = oy - vp[V_OFFY];
        const float otz = oz - vp[V_OFFZ];
        const float oox = cth * otx - sth * otz;
        const float ooz = sth * otx + cth * otz;
        const float odx = cth * dx - sth * dz;
        const float odz = sth * dx + cth * dz;
        float enter, exitt;
        bool ok;
        if (vp[V_ISBOX] != 0.f) {  // slab test
          const float ivx = 1.0f / odx, ivy = 1.0f / dy, ivz = 1.0f / odz;
          const float tx0 = (vp[V_B0X] - oox) * ivx;
          const float tx1 = (vp[V_B1X] - oox) * ivx;
          const float ty0 = (vp[V_B0Y] - oty) * ivy;
          const float ty1 = (vp[V_B1Y] - oty) * ivy;
          const float tz0 = (vp[V_B0Z] - ooz) * ivz;
          const float tz1 = (vp[V_B1Z] - ooz) * ivz;
          enter = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                          nan_min(tz0, tz1));
          exitt = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                          nan_max(tz0, tz1));
          ok = enter < exitt;
        } else {  // the sphere's roots
          const float ocx = oox - vp[V_CX];
          const float ocy = oty - vp[V_CY];
          const float ocz = ooz - vp[V_CZ];
          const float ao = odx * odx + dy * dy + odz * odz;
          const float hb = ocx * odx + ocy * dy + ocz * odz;
          const float ct = ocx * ocx + ocy * ocy + ocz * ocz - vp[V_R2];
          const float disc = hb * hb - ao * ct;
          ok = disc > 0.f;
          const float sq = sqrtf(ok ? disc : 1.0f);
          const float iao = 1.0f / ao;
          enter = (-hb - sq) * iao;
          exitt = (-hb + sq) * iao;
        }
        const float t1c = nan_max(enter, L.t_min);
        if (!(ok && t1c < exitt)) continue;
        const float tin = fmaxf(t1c, 0.f);
        const float dist_in = (exitt - tin) * ray_len;
        float u = rand4(L.seed, rid, (uint32_t)depth, SALT_VOLUME + v).x;
        u = fminf(fmaxf(u, 1e-12f), 1.0f);
        const float hd = vp[V_NID] * (logf(u) * X.log_scale);
        if (!(hd <= dist_in)) continue;
        const float tv = tin + hd / ray_len;
        if (tv < best) {
          best = tv;
          vwin = v;
        }
      }
    }

    if (win < 0 && vwin < 0) {  // miss -> background, terminate
      if (kEmit) lane_codes[k] = 0;
      if constexpr (kDefer) {
        if (lead)
          put_record(rec, lane0 + k, tpr * par[P_BACKGROUND + 0],
                     tpg * par[P_BACKGROUND + 1],
                     tpb * par[P_BACKGROUND + 2], 0.f, 0.f, 0.f, 0);
      }
      rr += tpr * par[P_BACKGROUND + 0];
      rg += tpg * par[P_BACKGROUND + 1];
      rb += tpb * par[P_BACKGROUND + 2];
      alive = false;
      continue;  // the block's barriers still need it
    }

    if constexpr (kVol) {
      if (vwin >= 0) {  // medium scatter: isotropic over the solid albedo
        if (kEmit) lane_codes[k] = 3 + 4 * vwin;
        if constexpr (kDefer) {
          if (lead)
            put_record(rec, lane0 + k, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0);
        }
        const float* __restrict__ vp = X.vtab + vwin * N_VCOLS;
        ox = ox + best * dx;
        oy = oy + best * dy;
        oz = oz + best * dz;
        const float4 q =
            rand4(L.seed, rid, (uint32_t)depth, SALT_ISOTROPIC);
        const float3 b = unit_vector(q.x, q.y);
        const float br = cbrtf(q.z);
        dx = b.x * br;
        dy = b.y * br;
        dz = b.z * br;
        tpr *= vp[V_CR];
        tpg *= vp[V_CG];
        tpb *= vp[V_CB];
        continue;
      }
    }

    if (kEmit) lane_codes[k] = (kPla && planar) ? 2 + 4 * win : 1 + 4 * win;

    // ---- hit record (ops.sphere.sphere_record / the planar affine) -------
    // The winner's column, and the row stride of its table.
    const float* __restrict__ row_ptr = tab + win;
    int st = S;
    if constexpr (kPla) {
      if (planar) {
        row_ptr = ptab + win;
        st = R;
      }
    }
    const float px = ox + best * dx;
    const float py = oy + best * dy;
    const float pz = oz + best * dz;
    float nx, ny, nz;
    if (!kSph || (kPla && planar)) {  // raw barycentric shading normal
      nx = row_ptr[NS0X * st] + bu * row_ptr[NSUX * st] +
           bv * row_ptr[NSVX * st];
      ny = row_ptr[NS0Y * st] + bu * row_ptr[NSUY * st] +
           bv * row_ptr[NSVY * st];
      nz = row_ptr[NS0Z * st] + bu * row_ptr[NSUZ * st] +
           bv * row_ptr[NSVZ * st];
    } else {
      const float w = (time - row_ptr[T0 * S]) / row_ptr[DT * S];
      const float r = row_ptr[RADIUS * S];
      nx = (px - (row_ptr[C0X * S] + w * row_ptr[DCX * S])) / r;
      ny = (py - (row_ptr[C0Y * S] + w * row_ptr[DCY * S])) / r;
      nz = (pz - (row_ptr[C0Z * S] + w * row_ptr[DCZ * S])) / r;
    }
    const bool front = (dx * nx + dy * ny + dz * nz) < 0.f;
    if (!front) {
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }

    // ---- texture: solid / checker / uv-debug -----------------------------
    float tr = row_ptr[C1R * st], tg = row_ptr[C1G * st],
          tb = row_ptr[C1B * st];
    if (row_ptr[TTYPE * st] == 1.0f) {
      const float sc = row_ptr[TSCALE * st];
      const float sines = sinf(sc * px) * sinf(sc * py) * sinf(sc * pz);
      if (sines < 0.f) {
        tr = row_ptr[C2R * st];
        tg = row_ptr[C2G * st];
        tb = row_ptr[C2B * st];
      }
    }
    if constexpr (kPla) {
      // (u, v, 0); the builder admits uv-debug on planar primitives only.
      if (planar && row_ptr[TTYPE * st] == 4.0f) {
        tr = row_ptr[TU0 * st] + bu * row_ptr[TUU * st] +
             bv * row_ptr[TUV * st];
        tg = row_ptr[TV0 * st] + bu * row_ptr[TVU * st] +
             bv * row_ptr[TVV * st];
        tb = 0.f;
      }
    }

    const float mtype = row_ptr[MTYPE * st];
    if constexpr (kDefer) {
      // A noise or image texel is shaded as 1.0 and recorded for the host.
      const float ttype = row_ptr[TTYPE * st];
      float ra = 0.f, rb = 0.f, rc = 0.f;
      int dcode = 0;
      if (ttype == 2.0f || ttype == 3.0f) {
        bool on_planar = false;
        if constexpr (kPla) on_planar = planar;
        const int texid =
            (int)row_ptr[(on_planar ? (int)P_TEXID : (int)TEXID) * st];
        dcode = on_planar ? -(texid + 1) : texid + 1;
        if (ttype == 2.0f) {  // noise: the hit point
          ra = px;
          rb = py;
          rc = pz;
        } else if (on_planar) {  // planar image: its in-plane (u, v)
          ra = bu;
          rb = bv;
        } else {  // sphere image: the pre-flip outward normal
          ra = front ? nx : -nx;
          rb = front ? ny : -ny;
          rc = front ? nz : -nz;
        }
        tr = tg = tb = 1.0f;
      }
      const bool emits = mtype == 3.0f;
      if (lead)
        put_record(rec, lane0 + k, emits ? tpr * tr : 0.f,
                   emits ? tpg * tg : 0.f, emits ? tpb * tb : 0.f, ra, rb,
                   rc, dcode);
    }

    // ---- scatter (materials.scatter_packed) ------------------------------
    if (mtype == 3.0f) {  // diffuse light: emit tp * tex and stop
      rr += tpr * tr;
      rg += tpg * tg;
      rb += tpb * tb;
      alive = false;
      continue;  // the block's barriers still need it
    }
    const float len = sqrtf(a + 1e-20f);  // vecmath.normalize(d, eps=1e-20)
    const float ux = dx / len, uy = dy / len, uz = dz / len;
    const float udn = ux * nx + uy * ny + uz * nz;
    float ndx, ndy, ndz;
    if (mtype == 1.0f) {  // metal: fuzzed mirror, absorbs when dot <= 0
      const float4 um = rand4(L.seed, rid, (uint32_t)depth, SALT_METAL);
      const float3 b = unit_vector(um.x, um.y);
      const float br = cbrtf(um.z);
      const float fuzz = row_ptr[FUZZ * st];
      ndx = (ux - 2.0f * udn * nx) + fuzz * (b.x * br);
      ndy = (uy - 2.0f * udn * ny) + fuzz * (b.y * br);
      ndz = (uz - 2.0f * udn * nz) + fuzz * (b.z * br);
      if (!((ndx * nx + ndy * ny + ndz * nz) > 0.f)) {
        alive = false;
        continue;
      }
      tpr *= tr;
      tpg *= tg;
      tpb *= tb;
    } else if (mtype == 2.0f) {  // dielectric: Schlick against the draw ud
      const float ud =
          rand4(L.seed, rid, (uint32_t)depth, SALT_DIELECTRIC).x;
      const float ior = row_ptr[IOR * st];
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

  if (!(in_range && lead)) return;
  rad[3 * i + 0] = rr;
  rad[3 * i + 1] = rg;
  rad[3 * i + 2] = rb;
  seg[i] = nseg;
  const int started = nseg - seg0;  // bounces this launch began
  if (kEmit) {  // bounces [started, max_depth) were never started
    for (int k = started; k < L.max_depth; ++k) lane_codes[k] = 0;
  }
  if constexpr (kDefer) {
    for (int k = started; k < L.max_depth; ++k)
      put_record(rec, lane0 + k, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0);
  }
  if constexpr (kPhase) {
    float* __restrict__ so = X.st_out + (long long)i * N_STATE;
    so[S_OX] = ox; so[S_OY] = oy; so[S_OZ] = oz;
    so[S_DX] = dx; so[S_DY] = dy; so[S_DZ] = dz;
    so[S_TPR] = tpr; so[S_TPG] = tpg; so[S_TPB] = tpb;
    so[S_RR] = rr; so[S_RG] = rg; so[S_RB] = rb;
    so[S_TIME] = time;
    so[S_ALIVE] = alive ? 1.f : 0.f;
    so[S_SEG] = (float)nseg;
  }
}

// One instantiation's launch (or, with `occ`, its resident blocks per SM
// at the launch's shared memory). A planar tile pair above the default 48 KB
// of dynamic shared memory needs the attribute; an error there is returned.
template <bool kEmit, bool kSph, bool kPla, bool kDefer, bool kVol,
          bool kPhase>
cudaError_t run_render(const float* tab, const float* ptab,
                       const float4* ptest, const float* par, const Launch& L,
                       const Extra& X, float* rad, int* seg, int* codes,
                       const Records& rec, cudaStream_t stream, int* occ) {
  const auto kernel = render_kernel<kEmit, kSph, kPla, kDefer, kVol, kPhase>;
  const int smem = kPla ? kTileBytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (occ != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, kBlock,
                                                         smem);
  const long long threads = (long long)L.n_chunk * (kPhase ? X.group : 1);
  const int grid = (int)((threads + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, smem, stream>>>(tab, ptab, par, L, X, rad, seg,
                                         codes, rec, ptest);
  return cudaGetLastError();
}

// ---- The sphere-only single-pass launches (K1, K1-emit, K6a) ----------------
//
// What held render_kernel back there (PERF.md §6): a thread carried one lane
// and left the bounce loop when it died, so a warp ran until its longest
// lane ended (jumpy_balls: half the issue slots of the sphere loop went to
// dead lanes); every lane read each sphere's 11 terms as scalar loads; and
// K6a wrote each record as 7 scalar stores, 96 bytes apart between a warp's
// threads, which took most of its launch. So:
// - Persistent warps that refill dead lanes (Aila and Laine, "Understanding
//   the Efficiency of Ray Traversal on GPUs", HPG 2009: persistent threads
//   with dynamic fetch). The grid is the resident blocks. A thread holds
//   kSphereRays lane slots (one); each step, a warp claims lanes for all of
//   its empty slots with one atomicAdd on a per-launch counter (the slots
//   in ballot order), an empty slot casts its new lane's primary ray, and
//   every live slot runs one bounce. A lane that ends writes its outputs
//   and its zero tail at its own index and frees its slot. The warp stays
//   converged (full-mask ballots) until the window has no lane left and its
//   slots are empty.
// - Packed sphere rows: three float4 a sphere, (c0, k0), (dc, k1), (t0,
//   1/dt, k2, 0) (ops/cuda/megakernel.py: build_sphere_rows). Up to
//   kSphereRowLimit rows the block stages the table once into dynamic shared
//   memory by cp.async (one barrier at the start, none after); a larger
//   table is read from global memory (L1/L2) with the same 16-byte loads.
//   A row is three 16-byte broadcasts where render_kernel made 11 scalar
//   loads; with more than one slot a thread, each read would feed them all.
// - Records (kDefer) as one 32-byte row per lane and bounce, two 16-byte
//   stores: (ctb, abc.x), (abc.y, abc.z, dcode bits, 0). The wrapper returns
//   ctb, abc and dcode as views of that (n, D, 8) buffer.
// Each lane's arithmetic and random keys (seed, lane id, depth) are
// render_kernel's, so every output element is bitwise its: only the order
// in which lanes run changes. The products render_kernel's sphere-only
// instantiations fused into FMAs (read from their SASS, cuobjdump -sass)
// are written out here with __fmaf_rn / __fmul_rn / __fadd_rn, so that
// nvcc's contraction, which moved with unrelated edits before, cannot move
// them: the primary ray, the sphere test, the hit record and every
// scatter.
// The lane slots a thread, the block and the row limit were chosen on the
// card (PERF.md §6): with one slot a thread jumpy_balls' launch took ~30%
// less time than with two (fewer registers, more resident warps, and a
// step that shades one slot instead of two in turn), three and four more
// still; blocks of 64 to 256 threads within a few percent.
constexpr int kSphereRays = 1;          // lane slots a thread
constexpr int kSphereBlock = 128;       // threads a block
constexpr int kSphereRowLimit = 1024;   // packed rows kept in shared memory
constexpr int kSphereQ = 3;             // float4 a packed row

// One slot's lane: i its index in the window (-1: the slot is empty), k the
// bounce it runs next. Its radiance is 0 until the bounce that ends it (a
// miss or a light), so it is not carried.
struct Lane {
  int i, k;
  float ox, oy, oz, dx, dy, dz, time;
  float tpr, tpg, tpb;
};

// The lane's primary ray (integrator._pixel_rays + camera.get_rays).
__device__ __forceinline__ void cast_primary(Lane& y, int i,
                                             const float* __restrict__ par,
                                             const Launch& L) {
  const long long lane = L.lane_start + i;
  const uint32_t rid = (uint32_t)lane;
  const long long pix = lane / L.spp;
  const float col = (float)(pix % L.width);
  const float row = (float)(L.height - 1 - pix / L.width);  // bottom-up
  const float4 uj = rand4(L.seed, rid, 0u, SALT_PIXEL_JITTER);
  const float fs = __fadd_rn(col, uj.x) / (float)(L.width - 1);
  const float ft = __fadd_rn(row, uj.y) / (float)(L.height - 1);
  const float4 ul = rand4(L.seed, rid, 0u, SALT_LENS);
  const float lr = sqrtf(ul.x);
  const float lphi = __fmul_rn(TWO_PI_F, ul.y);
  const float lens = par[P_LENS_RADIUS];
  const float rdx = __fmul_rn(lens, __fmul_rn(lr, cosf(lphi)));
  const float rdy = __fmul_rn(lens, __fmul_rn(lr, sinf(lphi)));
  y.time = __fmaf_rn(rand4(L.seed, rid, 0u, SALT_TIME).x, par[P_DTIME],
                     par[P_TIME0]);
  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float off =
        __fmaf_rn(par[P_U + k], rdx, __fmul_rn(par[P_V + k], rdy));
    o[k] = __fadd_rn(par[P_ORIGIN + k], off);
    d[k] = __fsub_rn(
        __fsub_rn(__fmaf_rn(ft, par[P_VERTICAL + k],
                            __fmaf_rn(fs, par[P_HORIZONTAL + k],
                                      par[P_LOWER_LEFT + k])),
                  par[P_ORIGIN + k]),
        off);
  }
  y.i = i;
  y.k = 0;
  y.ox = o[0]; y.oy = o[1]; y.oz = o[2];
  y.dx = d[0]; y.dy = d[1]; y.dz = d[2];
  y.tpr = y.tpg = y.tpb = 1.f;
}

// |d|^2, |o|^2 and o.d of a slot's ray.
__device__ __forceinline__ float3 ray_terms(const Lane& y) {
  return make_float3(
      __fmaf_rn(y.dz, y.dz, __fmaf_rn(y.dy, y.dy, __fmul_rn(y.dx, y.dx))),
      __fmaf_rn(y.oz, y.oz, __fmaf_rn(y.oy, y.oy, __fmul_rn(y.ox, y.ox))),
      __fmaf_rn(y.oz, y.dz, __fmaf_rn(y.oy, y.dy, __fmul_rn(y.ox, y.dx))));
}

// One packed row against one slot's ray (rt: |d|^2, |o|^2, o.d): the
// strict-< update of (best, win).
__device__ __forceinline__ void sphere_row(const Lane& y, float3 rt,
                                           float inv_a, float4 q0, float4 q1,
                                           float4 q2, float t_min, int s,
                                           float& best, int& win) {
  const float w = __fmul_rn(__fsub_rn(y.time, q2.x), q2.y);
  const float cx = __fmaf_rn(w, q1.x, q0.x);
  const float cy = __fmaf_rn(w, q1.y, q0.y);
  const float cz = __fmaf_rn(w, q1.z, q0.z);
  const float dc =
      __fmaf_rn(y.dz, cz, __fmaf_rn(y.dx, cx, __fmul_rn(y.dy, cy)));
  const float oc =
      __fmaf_rn(y.oz, cz, __fmaf_rn(y.ox, cx, __fmul_rn(y.oy, cy)));
  const float hb = __fsub_rn(rt.z, dc);
  const float kq = __fmaf_rn(w, __fmaf_rn(w, q2.z, q1.w), q0.w);
  const float cc = __fadd_rn(__fsub_rn(rt.y, __fadd_rn(oc, oc)), kq);
  const float disc = __fmaf_rn(hb, hb, -__fmul_rn(rt.x, cc));
  if (disc > 0.f) {
    const float sq = sqrtf(disc);
    float root = __fmul_rn(__fsub_rn(-hb, sq), inv_a);
    if (!(root >= t_min)) root = __fmul_rn(__fadd_rn(-hb, sq), inv_a);
    if (root >= t_min && root < best) {
      best = root;
      win = s;
    }
  }
}

// A unit-sphere direction's parts (rng.unit_vector_from_uniforms): r, the
// angle phi and z; the direction is (r cos phi, r sin phi, z).
__device__ __forceinline__ float3 unit_parts(float u1, float u2) {
  const float z = __fmaf_rn(-2.0f, u1, 1.0f);
  const float r = sqrtf(fmaxf(__fmaf_rn(-z, z, 1.0f), 0.0f));
  return make_float3(r, __fmul_rn(TWO_PI_F, u2), z);
}

// The slot's lane has ended after `nseg` bounces with radiance (rr, rg,
// rb): its outputs, the zero tail of its codes and records, and the slot
// freed (a zero direction, so that its sphere tests never take a root).
template <bool kEmit, bool kDefer>
__device__ __forceinline__ void end_lane(Lane& y, int nseg, float rr,
                                         float rg, float rb, const Launch& L,
                                         float* __restrict__ rad,
                                         int* __restrict__ seg,
                                         int* __restrict__ codes,
                                         float4* __restrict__ recs) {
  const long long i = y.i;
  const int D = L.max_depth;
  rad[3 * i + 0] = rr;
  rad[3 * i + 1] = rg;
  rad[3 * i + 2] = rb;
  seg[i] = nseg;
  if constexpr (kEmit) {
    for (int k = nseg; k < D; ++k) codes[i * D + k] = 0;
  }
  if constexpr (kDefer) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = nseg; k < D; ++k) {
      recs[2 * (i * D + k) + 0] = zero;
      recs[2 * (i * D + k) + 1] = zero;
    }
  }
  y.i = -1;
  y.dx = y.dy = y.dz = 0.f;
}

// One bounce of a live slot's lane, given its closest sphere (best, win;
// win < 0 for none) and |d|^2 = a: the code, the record, the hit record,
// the texture and the scatter of render_kernel's sphere-only branch.
template <bool kEmit, bool kDefer>
__device__ __forceinline__ void sphere_bounce(
    Lane& y, float a, float best, int win, const float* __restrict__ tab,
    const float* __restrict__ par, const Launch& L, float* __restrict__ rad,
    int* __restrict__ seg, int* __restrict__ codes,
    float4* __restrict__ recs) {
  const int k = y.k;
  const int S = L.n_spheres;
  const long long at = (long long)y.i * L.max_depth + k;
  const uint32_t rid = (uint32_t)(L.lane_start + y.i);
  const uint32_t depth = (uint32_t)k;
  if (win < 0) {  // miss -> background, terminate
    const float br = par[P_BACKGROUND + 0], bg = par[P_BACKGROUND + 1],
                bb = par[P_BACKGROUND + 2];
    if constexpr (kEmit) codes[at] = 0;
    if constexpr (kDefer) {
      recs[2 * at + 0] = make_float4(__fmul_rn(y.tpr, br),
                                     __fmul_rn(y.tpg, bg),
                                     __fmul_rn(y.tpb, bb), 0.f);
      recs[2 * at + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    end_lane<kEmit, kDefer>(y, k + 1, __fmaf_rn(y.tpr, br, 0.f),
                            __fmaf_rn(y.tpg, bg, 0.f),
                            __fmaf_rn(y.tpb, bb, 0.f), L, rad, seg, codes,
                            recs);
    return;
  }
  if constexpr (kEmit) codes[at] = 1 + 4 * win;

  // ---- hit record (ops.sphere.sphere_record) ------------------------------
  const float* __restrict__ col = tab + win;  // the winner's column, stride S
  const float px = __fmaf_rn(best, y.dx, y.ox);
  const float py = __fmaf_rn(best, y.dy, y.oy);
  const float pz = __fmaf_rn(best, y.dz, y.oz);
  const float w = __fsub_rn(y.time, col[T0 * S]) / col[DT * S];
  const float r = col[RADIUS * S];
  float nx = __fsub_rn(px, __fmaf_rn(w, col[DCX * S], col[C0X * S])) / r;
  float ny = __fsub_rn(py, __fmaf_rn(w, col[DCY * S], col[C0Y * S])) / r;
  float nz = __fsub_rn(pz, __fmaf_rn(w, col[DCZ * S], col[C0Z * S])) / r;
  const bool front =
      __fmaf_rn(y.dz, nz, __fmaf_rn(y.dx, nx, __fmul_rn(y.dy, ny))) < 0.f;
  if (!front) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }

  // ---- texture: solid / checker --------------------------------------------
  float tr = col[C1R * S], tg = col[C1G * S], tb = col[C1B * S];
  const float ttype = col[TTYPE * S];
  if (ttype == 1.0f) {
    const float sc = col[TSCALE * S];
    const float sines =
        __fmul_rn(__fmul_rn(sinf(__fmul_rn(sc, px)), sinf(__fmul_rn(sc, py))),
                  sinf(__fmul_rn(sc, pz)));
    if (sines < 0.f) {
      tr = col[C2R * S];
      tg = col[C2G * S];
      tb = col[C2B * S];
    }
  }
  const float mtype = col[MTYPE * S];
  if constexpr (kDefer) {
    // A noise or image texel is shaded as 1.0 and recorded for the host.
    float ra = 0.f, rb = 0.f, rc = 0.f;
    int dcode = 0;
    if (ttype == 2.0f || ttype == 3.0f) {
      dcode = (int)col[TEXID * S] + 1;
      if (ttype == 2.0f) {  // noise: the hit point
        ra = px;
        rb = py;
        rc = pz;
      } else {  // image: the pre-flip outward normal
        ra = front ? nx : -nx;
        rb = front ? ny : -ny;
        rc = front ? nz : -nz;
      }
      tr = tg = tb = 1.0f;
    }
    const bool emits = mtype == 3.0f;
    recs[2 * at + 0] =
        make_float4(emits ? __fmul_rn(y.tpr, tr) : 0.f,
                    emits ? __fmul_rn(y.tpg, tg) : 0.f,
                    emits ? __fmul_rn(y.tpb, tb) : 0.f, ra);
    recs[2 * at + 1] = make_float4(rb, rc, __int_as_float(dcode), 0.f);
  }

  // ---- scatter (materials.scatter_packed) ----------------------------------
  if (mtype == 3.0f) {  // diffuse light: emit tp * tex and stop
    end_lane<kEmit, kDefer>(y, k + 1, __fmaf_rn(y.tpr, tr, 0.f),
                            __fmaf_rn(y.tpg, tg, 0.f),
                            __fmaf_rn(y.tpb, tb, 0.f), L, rad, seg, codes,
                            recs);
    return;
  }
  const float len = sqrtf(__fadd_rn(a, 1e-20f));  // normalize(d, eps=1e-20)
  const float ux = y.dx / len, uy = y.dy / len, uz = y.dz / len;
  const float udn = __fmaf_rn(uz, nz, __fmaf_rn(ux, nx, __fmul_rn(uy, ny)));
  float ndx, ndy, ndz;
  if (mtype == 1.0f) {  // metal: fuzzed mirror, absorbs when dot <= 0
    const float4 um = rand4(L.seed, rid, depth, SALT_METAL);
    const float3 b = unit_parts(um.x, um.y);  // (r, phi, z)
    const float br = cbrtf(um.z);
    const float fuzz = col[FUZZ * S];
    const float u2 = __fadd_rn(udn, udn);
    ndx = __fmaf_rn(fuzz, __fmul_rn(__fmul_rn(b.x, cosf(b.y)), br),
                    __fmaf_rn(-u2, nx, ux));
    ndy = __fmaf_rn(fuzz, __fmul_rn(__fmul_rn(b.x, sinf(b.y)), br),
                    __fmaf_rn(-u2, ny, uy));
    ndz = __fmaf_rn(fuzz, __fmul_rn(b.z, br), __fmaf_rn(-u2, nz, uz));
    if (!(__fmaf_rn(nz, ndz, __fmaf_rn(nx, ndx, __fmul_rn(ny, ndy))) > 0.f)) {
      end_lane<kEmit, kDefer>(y, k + 1, 0.f, 0.f, 0.f, L, rad, seg, codes,
                              recs);
      return;
    }
    y.tpr = __fmul_rn(y.tpr, tr);
    y.tpg = __fmul_rn(y.tpg, tg);
    y.tpb = __fmul_rn(y.tpb, tb);
  } else if (mtype == 2.0f) {  // dielectric: Schlick against the draw ud
    const float ud = rand4(L.seed, rid, depth, SALT_DIELECTRIC).x;
    const float ior = col[IOR * S];
    const float ratio = front ? 1.0f / ior : ior;
    const float cos_t = fminf(-udn, 1.0f);
    const float sin_t = sqrtf(fmaxf(__fmaf_rn(-cos_t, cos_t, 1.0f), 1e-12f));
    float r0 = __fsub_rn(1.0f, ratio) / __fadd_rn(1.0f, ratio);
    r0 = __fmul_rn(r0, r0);
    const float omc = __fsub_rn(1.0f, cos_t);
    const float omc2 = __fmul_rn(omc, omc);
    const float refl = __fmaf_rn(__fsub_rn(1.0f, r0),
                                 __fmul_rn(omc, __fmul_rn(omc2, omc2)), r0);
    if (__fmul_rn(ratio, sin_t) > 1.0f || refl > ud) {
      const float u2 = __fadd_rn(udn, udn);
      ndx = __fmaf_rn(-u2, nx, ux);
      ndy = __fmaf_rn(-u2, ny, uy);
      ndz = __fmaf_rn(-u2, nz, uz);
    } else {  // refract (vecmath.refract)
      const float rpx = __fmul_rn(ratio, __fmaf_rn(cos_t, nx, ux));
      const float rpy = __fmul_rn(ratio, __fmaf_rn(cos_t, ny, uy));
      const float rpz = __fmul_rn(ratio, __fmaf_rn(cos_t, nz, uz));
      const float rp2 =
          __fmaf_rn(rpz, rpz, __fmaf_rn(rpx, rpx, __fmul_rn(rpy, rpy)));
      const float sq = sqrtf(fmaxf(fabsf(__fsub_rn(1.0f, rp2)), 1e-12f));
      ndx = __fmaf_rn(-sq, nx, rpx);
      ndy = __fmaf_rn(-sq, ny, rpy);
      ndz = __fmaf_rn(-sq, nz, rpz);
    }
  } else {  // lambertian: normal + unit vector, degenerate -> normal
    const float4 ulm = rand4(L.seed, rid, depth, SALT_LAMBERTIAN);
    const float3 v = unit_parts(ulm.x, ulm.y);  // (r, phi, z)
    ndx = __fmaf_rn(v.x, cosf(v.y), nx);
    ndy = __fmaf_rn(v.x, sinf(v.y), ny);
    ndz = __fadd_rn(nz, v.z);
    if (fabsf(ndx) < 1e-8f && fabsf(ndy) < 1e-8f && fabsf(ndz) < 1e-8f) {
      ndx = nx;
      ndy = ny;
      ndz = nz;
    }
    y.tpr = __fmul_rn(y.tpr, tr);
    y.tpg = __fmul_rn(y.tpg, tg);
    y.tpb = __fmul_rn(y.tpb, tb);
  }
  // The scattered ray keeps the parent's shutter time.
  y.ox = px;
  y.oy = py;
  y.oz = pz;
  y.dx = ndx;
  y.dy = ndy;
  y.dz = ndz;
  y.k = k + 1;
  if (y.k == L.max_depth)
    end_lane<kEmit, kDefer>(y, L.max_depth, 0.f, 0.f, 0.f, L, rad, seg,
                            codes, recs);
}

// __launch_bounds__'s second argument (1) changes no limit, but without it
// ptxas chose fewer registers for two instantiations and spilled 4-8 bytes.
template <bool kEmit, bool kDefer, bool kShared>
__global__ void __launch_bounds__(kSphereBlock, 1)
sphere_kernel(const float* __restrict__ tab, const float4* __restrict__ rows,
              const float* __restrict__ par, Launch L,
              float* __restrict__ rad, int* __restrict__ seg,
              int* __restrict__ codes, float4* __restrict__ recs,
              unsigned* __restrict__ next) {
  constexpr int R = kSphereRays;
  constexpr unsigned kAll = 0xffffffffu;
  const int S = L.n_spheres;
  const float4* __restrict__ srow = rows;
  if constexpr (kShared) {  // the whole table, once, for the block's life
    extern __shared__ float4 sphere_rows[];
    for (int q = threadIdx.x; q < kSphereQ * S; q += blockDim.x)
      cp_async16(sphere_rows + q, rows + q);
    cp_async_commit();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    srow = sphere_rows;
  }
  const unsigned me = threadIdx.x & 31u;
  const unsigned below = (1u << me) - 1u;  // the warp's lanes before this one
  Lane y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    y[r] = Lane{-1, 0, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  bool more = true;  // the window may hold unclaimed lanes (warp-uniform)
  for (;;) {
    if (more) {  // claim lanes for the warp's empty slots: one atomic
      unsigned m[R];
      unsigned total = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = __ballot_sync(kAll, y[r].i < 0);
        total += __popc(m[r]);
      }
      if (total) {
        unsigned base = 0;
        if (me == 0) base = atomicAdd(next, total);
        base = __shfl_sync(kAll, base, 0);
        unsigned slot = base;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned id = slot + __popc(m[r] & below);
          if (y[r].i < 0 && id < (unsigned)L.n_chunk) {
            cast_primary(y[r], (int)id, par, L);
            if (L.max_depth < 1)  // no bounce: rad 0, seg 0
              end_lane<kEmit, kDefer>(y[r], 0, 0.f, 0.f, 0.f, L, rad, seg,
                                      codes, recs);
          }
          slot += __popc(m[r]);
        }
        if (slot >= (unsigned)L.n_chunk) more = false;
      }
    }
    bool live = false;
#pragma unroll
    for (int r = 0; r < R; ++r) live |= y[r].i >= 0;
    if (!__any_sync(kAll, live)) break;

    // ---- closest sphere of every slot: each row read serves them all ------
    float3 rt[R];
    float inv_a[R], best[R];
    int win[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rt[r] = ray_terms(y[r]);
      inv_a[r] = 1.0f / rt[r].x;
      best[r] = INFINITY;
      win[r] = -1;
    }
    for (int s = 0; s < S; ++s) {
      const float4 q0 = srow[kSphereQ * s + 0];
      const float4 q1 = srow[kSphereQ * s + 1];
      const float4 q2 = srow[kSphereQ * s + 2];
#pragma unroll
      for (int r = 0; r < R; ++r)
        sphere_row(y[r], rt[r], inv_a[r], q0, q1, q2, L.t_min, s, best[r],
                   win[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (y[r].i >= 0)
        sphere_bounce<kEmit, kDefer>(y[r], rt[r].x, best[r], win[r], tab, par,
                                     L, rad, seg, codes, recs);
    }
  }
}

// One sphere-only single-pass launch on the resident blocks (or, with
// `occ`, the resident blocks per SM), the packed rows in shared memory
// when kShared. Shared memory above the default 48 KB needs the attribute;
// an error there is returned.
template <bool kEmit, bool kDefer, bool kShared>
cudaError_t run_spheres(const float* tab, const float4* rows,
                        const float* par, const Launch& L, float* rad,
                        int* seg, int* codes, float4* recs, unsigned* next,
                        cudaStream_t stream, int* occ) {
  const auto kernel = sphere_kernel<kEmit, kDefer, kShared>;
  const int smem = kShared ? kSphereQ * (int)sizeof(float4) * L.n_spheres : 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kSphereBlock, smem);
  if (err != cudaSuccess) return err;
  if (occ != nullptr) {
    *occ = blocks;
    return cudaSuccess;
  }
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  constexpr long long kPerBlock = (long long)kSphereBlock * kSphereRays;
  const long long want = ((long long)L.n_chunk + kPerBlock - 1) / kPerBlock;
  const long long resident = (long long)blocks * sms;
  const int grid = (int)(want < resident ? want : resident);
  kernel<<<grid, kSphereBlock, smem, stream>>>(tab, rows, par, L, rad, seg,
                                               codes, recs, next);
  return cudaGetLastError();
}

// The sphere-only single-pass launch: the rows in shared memory when
// `resident` is 1, or (-1) when the table has at most kSphereRowLimit rows.
template <bool kEmit, bool kDefer>
cudaError_t launch_spheres(const float* tab, const float4* rows,
                           const float* par, const Launch& L, int resident,
                           float* rad, int* seg, int* codes, float4* recs,
                           unsigned* next, cudaStream_t stream, int* occ) {
  if (resident == 1 || (resident < 0 && L.n_spheres <= kSphereRowLimit))
    return run_spheres<kEmit, kDefer, true>(tab, rows, par, L, rad, seg,
                                            codes, recs, next, stream, occ);
  return run_spheres<kEmit, kDefer, false>(tab, rows, par, L, rad, seg, codes,
                                           recs, next, stream, occ);
}

// ---- The media single-pass launches (K5, K5-emit, K6a with media) -----------
//
// What held render_kernel back there (PERF.md §6, the parts compiled out one
// by one): the block walked the bounces together (__syncthreads_or), so all
// 128 lanes of a block stayed until its longest lane ended, and in a closed
// room with a light lanes end at every depth; each bounce staged the planar
// rows in cp.async tiles behind two barriers, for six rows in smokey's
// case; and each live lane read the medium's ~20 scalars from global
// memory. So, as sphere_kernel does for sphere scenes:
// - Persistent warps on the resident blocks claim lanes from a per-launch
//   counter with one warp-aggregated atomicAdd and refill dead slots (a
//   thread holds one lane slot). A lane that ends writes its outputs and
//   its zero tail at its own index.
// - The volume table, the packed sphere rows (build_sphere_rows) and the
//   packed planar rows (build_planar_test: the (n, k) test rows, then the
//   in-plane rows) are read from global memory; L1 and L2 hold them, and
//   no barrier is taken. Measured on an H100 80GB HBM3 at 700 W (PERF.md
//   §6), staging them in shared memory for the block's life was no faster
//   on smokey's 560 B (0.326 against 0.320 ms a launch) and slower on
//   book2's 202 KB (178 ms, one block an SM, against 59), and
//   render_kernel's tile walk took 0.347 and 102 ms.
// What bounds it now (PERF.md §6): the per-segment arithmetic (each
// medium's frame change, slab reciprocals, PCG4D draw and logf; the planar
// rows; the shading) and the lanes of a warp taking different branches
// (medium or surface, each medium hit or missed), not the walk or the
// tables: the probe's parts together were worth ~10% on smokey.
// With kPhase it runs the phased launches with media at one lane a ray
// (K6b at G = 1; the grouped launches keep render_kernel): a claim indexes
// the phase's lane list, a slot resumes its lane from the state in or
// casts its primary ray, runs bounces d0 .. d0 + max_depth - 1 keyed on
// the absolute depth, and on the lane's end (dead, or the phase's bounces
// spent) writes its radiance, segments, zero record tail and state at its
// own index, as render_kernel's kPhase arm does, and refills the slot. On
// book2 that is the first phase of a whole frame, ~71% of its segments
// (PERF.md §5), which render_kernel's block walk ran at ~40% lane use.
// Each lane's arithmetic and random keys are render_kernel's kVol
// instantiations', with every add and multiply those fused into an FMA
// (read from their SASS, nvdisasm with line information) written out with
// __fmaf_rn / __fmul_rn / __fadd_rn, so that every output is bitwise theirs
// and nvcc's contraction cannot move: the primary ray, the sphere and
// shading code as sphere_kernel has them (except |d|^2 = fma(dz, dz,
// fma(dx, dx, dy dy)), its dy dy shared with the medium's |d'|^2), and in
// the planar and volume tests each three-term dot as fma(a2, b2, fma(a0,
// b0, a1 b1)), the Y-rotation's four sums of products each with one
// product fused, and the discriminants as fma(h, h, -(a c)).
constexpr int kMediaBlock = 128;  // threads a block, one lane slot each

// What one media launch reads: the volume table (V x N_VCOLS floats), the
// packed sphere rows (S x 3 float4) and the packed planar rows (R plane
// rows (n, k), then R x 3 in-plane rows).
struct MediaTables {
  const float* __restrict__ vt;
  const float4* __restrict__ srows;
  const float4* __restrict__ ptest;
};

// The slot's lane has ended after `nseg` bounces with radiance (rr, rg,
// rb): its outputs and the zero tail of its codes and records; the slot is
// freed. With kPhase, `nseg` counts this launch's bounces: the lane's
// segments add those of its state in, and it writes its state out (o, d,
// throughput as of its last bounce, `alive` when the phase's bounces ran
// out first), as render_kernel's phased instantiations write theirs.
template <bool kEmit, bool kDefer, bool kPhase>
__device__ __forceinline__ void media_end(Lane& y, int nseg, float rr,
                                          float rg, float rb, const Launch& L,
                                          const Extra& X,
                                          float* __restrict__ rad,
                                          int* __restrict__ seg,
                                          int* __restrict__ codes,
                                          const Records& rec,
                                          bool alive = false) {
  const long long i = y.i;
  const int D = L.max_depth;
  rad[3 * i + 0] = rr;
  rad[3 * i + 1] = rg;
  rad[3 * i + 2] = rb;
  int total = nseg;
  if constexpr (kPhase) {
    if (X.st_in != nullptr) total += (int)X.st_in[i * N_STATE + S_SEG];
  }
  seg[i] = total;
  if constexpr (kEmit) {
    for (int k = nseg; k < D; ++k) codes[i * D + k] = 0;
  }
  if constexpr (kDefer) {
    for (int k = nseg; k < D; ++k)
      put_record(rec, i * D + k, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0);
  }
  if constexpr (kPhase) {
    float* __restrict__ so = X.st_out + i * N_STATE;
    so[S_OX] = y.ox; so[S_OY] = y.oy; so[S_OZ] = y.oz;
    so[S_DX] = y.dx; so[S_DY] = y.dy; so[S_DZ] = y.dz;
    so[S_TPR] = y.tpr; so[S_TPG] = y.tpg; so[S_TPB] = y.tpb;
    so[S_RR] = rr; so[S_RG] = rg; so[S_RB] = rb;
    so[S_TIME] = y.time;
    so[S_ALIVE] = alive ? 1.f : 0.f;
    so[S_SEG] = (float)total;
  }
  y.i = -1;
}

// One bounce of a live slot's lane: the closest sphere, planar primitive
// and medium scatter, then the miss, the isotropic scatter or the surface's
// hit record, texture, record and scatter (render_kernel's kVol branch).
// With kPhase, y.k counts this launch's bounces; the random numbers key on
// the lane's global id and the absolute depth d0 + y.k.
template <bool kEmit, bool kDefer, bool kPhase>
__device__ __forceinline__ void media_bounce(
    Lane& y, const MediaTables& T, const float* __restrict__ tab,
    const float* __restrict__ ptab, const float* __restrict__ par,
    const Launch& L, const Extra& X, float* __restrict__ rad,
    int* __restrict__ seg, int* __restrict__ codes, const Records& rec) {
  const int k = y.k;
  const int S = L.n_spheres;
  const int R = L.n_planar;
  const long long at = (long long)y.i * L.max_depth + k;
  uint32_t rid = (uint32_t)(L.lane_start + y.i);
  uint32_t depth = (uint32_t)k;
  if constexpr (kPhase) {
    if (X.gid != nullptr) rid = (uint32_t)X.gid[y.i];
    depth = (uint32_t)(X.d0 + k);
  }
  const float dy2 = __fmul_rn(y.dy, y.dy);
  const float a = __fmaf_rn(y.dz, y.dz, __fmaf_rn(y.dx, y.dx, dy2));

  // ---- closest sphere: strict < keeps the first minimum ------------------
  float best = INFINITY;
  int win = -1;
  if (S > 0) {
    const float inv_a = 1.0f / a;
    const float3 rt = make_float3(
        a, __fmaf_rn(y.oz, y.oz, __fmaf_rn(y.oy, y.oy, __fmul_rn(y.ox, y.ox))),
        __fmaf_rn(y.dz, y.oz, __fmaf_rn(y.dy, y.oy, __fmul_rn(y.dx, y.ox))));
    for (int s = 0; s < S; ++s)
      sphere_row(y, rt, inv_a, T.srows[kSphereQ * s + 0],
                 T.srows[kSphereQ * s + 1], T.srows[kSphereQ * s + 2],
                 L.t_min, s, best, win);
  }

  // ---- closest planar primitive, against the sphere winner's t ----------
  bool planar = false;       // the winner is planar primitive `win`
  float bu = 0.f, bv = 0.f;  // its in-plane / barycentric coordinates
  for (int r = 0; r < R; ++r) {
    const float4 pl = T.ptest[r];  // (nx, ny, nz, k)
    const float num = __fsub_rn(
        pl.w, __fmaf_rn(pl.z, y.oz,
                        __fmaf_rn(pl.x, y.ox, __fmul_rn(pl.y, y.oy))));
    const float den = __fmaf_rn(pl.z, y.dz,
                                __fmaf_rn(pl.x, y.dx, __fmul_rn(pl.y, y.dy)));
    if (!plane_candidate(num, den, L.t_min, best)) continue;
    const float t = num / den;
    if (t >= L.t_min && t < best) {  // NaN (a padded row) fails
      const float4* __restrict__ in = T.ptest + R + 3 * r;
      const float4 ua = in[0], ub = in[1];  // (ua, ca), (ub, cb)
      const float flag = in[2].x;
      const float hx = __fmaf_rn(t, y.dx, y.ox);
      const float hy = __fmaf_rn(t, y.dy, y.oy);
      const float hz = __fmaf_rn(t, y.dz, y.oz);
      const float u = __fadd_rn(
          __fmaf_rn(ua.z, hz, __fmaf_rn(ua.x, hx, __fmul_rn(ua.y, hy))),
          ua.w);
      const float v = __fadd_rn(
          __fmaf_rn(ub.z, hz, __fmaf_rn(ub.x, hx, __fmul_rn(ub.y, hy))),
          ub.w);
      if (u >= 0.f && v >= 0.f && v <= 1.f && __fmaf_rn(flag, v, u) <= 1.f) {
        best = t;
        win = r;
        planar = true;
        bu = u;
        bv = v;
      }
    }
  }

  // ---- closest medium scatter, against the surfaces' best (ops/volume) ---
  int vwin = -1;
  const float ray_len = sqrtf(a);
  const float ivy = 1.0f / y.dy;
  for (int v = 0; v < X.n_volumes; ++v) {
    const float* __restrict__ vp = T.vt + v * N_VCOLS;
    if (vp[V_VALID] == 0.f) continue;
    const float cth = vp[V_COS], sth = vp[V_SIN];
    const float otx = __fsub_rn(y.ox, vp[V_OFFX]);
    const float oty = __fsub_rn(y.oy, vp[V_OFFY]);
    const float otz = __fsub_rn(y.oz, vp[V_OFFZ]);
    const float oox = __fmaf_rn(cth, otx, -__fmul_rn(sth, otz));
    const float ooz = __fmaf_rn(sth, otx, __fmul_rn(cth, otz));
    const float odx = __fmaf_rn(cth, y.dx, -__fmul_rn(sth, y.dz));
    const float odz = __fmaf_rn(cth, y.dz, __fmul_rn(sth, y.dx));
    float enter, exitt;
    bool ok;
    if (vp[V_ISBOX] != 0.f) {  // slab test
      const float ivx = 1.0f / odx, ivz = 1.0f / odz;
      const float tx0 = __fmul_rn(__fsub_rn(vp[V_B0X], oox), ivx);
      const float tx1 = __fmul_rn(__fsub_rn(vp[V_B1X], oox), ivx);
      const float ty0 = __fmul_rn(__fsub_rn(vp[V_B0Y], oty), ivy);
      const float ty1 = __fmul_rn(__fsub_rn(vp[V_B1Y], oty), ivy);
      const float tz0 = __fmul_rn(__fsub_rn(vp[V_B0Z], ooz), ivz);
      const float tz1 = __fmul_rn(__fsub_rn(vp[V_B1Z], ooz), ivz);
      enter = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                      nan_min(tz0, tz1));
      exitt = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                      nan_max(tz0, tz1));
      ok = enter < exitt;
    } else {  // the sphere's roots
      const float ocx = __fsub_rn(oox, vp[V_CX]);
      const float ocy = __fsub_rn(oty, vp[V_CY]);
      const float ocz = __fsub_rn(ooz, vp[V_CZ]);
      const float ao = __fmaf_rn(odz, odz, __fmaf_rn(odx, odx, dy2));
      const float hb =
          __fmaf_rn(ocz, odz, __fmaf_rn(ocx, odx, __fmul_rn(y.dy, ocy)));
      const float ct = __fsub_rn(
          __fmaf_rn(ocz, ocz, __fmaf_rn(ocx, ocx, __fmul_rn(ocy, ocy))),
          vp[V_R2]);
      const float disc = __fmaf_rn(hb, hb, -__fmul_rn(ao, ct));
      ok = disc > 0.f;
      const float sq = sqrtf(ok ? disc : 1.0f);
      const float iao = 1.0f / ao;
      enter = __fmul_rn(__fsub_rn(-hb, sq), iao);
      exitt = __fmul_rn(__fadd_rn(-hb, sq), iao);
    }
    const float t1c = nan_max(enter, L.t_min);
    if (!(ok && t1c < exitt)) continue;
    const float tin = fmaxf(t1c, 0.f);
    const float dist_in = __fmul_rn(__fsub_rn(exitt, tin), ray_len);
    float u = rand4(L.seed, rid, depth, SALT_VOLUME + v).x;
    u = fminf(fmaxf(u, 1e-12f), 1.0f);
    const float hd = __fmul_rn(vp[V_NID], __fmul_rn(logf(u), X.log_scale));
    if (!(hd <= dist_in)) continue;
    const float tv = __fadd_rn(tin, hd / ray_len);
    if (tv < best) {
      best = tv;
      vwin = v;
    }
  }

  if (win < 0 && vwin < 0) {  // miss -> background, terminate
    const float br = par[P_BACKGROUND + 0], bg = par[P_BACKGROUND + 1],
                bb = par[P_BACKGROUND + 2];
    if constexpr (kEmit) codes[at] = 0;
    if constexpr (kDefer)
      put_record(rec, at, __fmul_rn(y.tpr, br), __fmul_rn(y.tpg, bg),
                 __fmul_rn(y.tpb, bb), 0.f, 0.f, 0.f, 0);
    media_end<kEmit, kDefer, kPhase>(y, k + 1, __fmaf_rn(y.tpr, br, 0.f),
                                     __fmaf_rn(y.tpg, bg, 0.f),
                                     __fmaf_rn(y.tpb, bb, 0.f), L, X, rad,
                                     seg, codes, rec);
    return;
  }

  // The scatter point: a medium's scatter or the surface's hit point.
  const bool medium = vwin >= 0;
  const float px = __fmaf_rn(best, y.dx, y.ox);
  const float py = __fmaf_rn(best, y.dy, y.oy);
  const float pz = __fmaf_rn(best, y.dz, y.oz);
  float nx = 0.f, ny = 0.f, nz = 0.f, tr = 1.f, tg = 1.f, tb = 1.f;
  float ux = 0.f, uy = 0.f, uz = 0.f, udn = 0.f;
  float mtype = 0.f;  // the surface's material
  bool front = true;
  const float* __restrict__ col = nullptr;
  int st = 0;
  if (medium) {  // medium scatter: isotropic over the solid albedo
    if constexpr (kEmit) codes[at] = 3 + 4 * vwin;
    if constexpr (kDefer)
      put_record(rec, at, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0);
  } else {
    if constexpr (kEmit) codes[at] = planar ? 2 + 4 * win : 1 + 4 * win;

    // ---- hit record (ops.sphere.sphere_record / the planar affine) -------
    // The winner's column, and the row stride of its table.
    col = planar ? ptab + win : tab + win;
    st = planar ? R : S;
    if (planar) {  // raw barycentric shading normal
      nx = __fmaf_rn(bv, col[NSVX * st], __fmaf_rn(bu, col[NSUX * st],
                                                   col[NS0X * st]));
      ny = __fmaf_rn(bv, col[NSVY * st], __fmaf_rn(bu, col[NSUY * st],
                                                   col[NS0Y * st]));
      nz = __fmaf_rn(bv, col[NSVZ * st], __fmaf_rn(bu, col[NSUZ * st],
                                                   col[NS0Z * st]));
    } else {
      const float w = __fsub_rn(y.time, col[T0 * S]) / col[DT * S];
      const float r = col[RADIUS * S];
      nx = __fsub_rn(px, __fmaf_rn(w, col[DCX * S], col[C0X * S])) / r;
      ny = __fsub_rn(py, __fmaf_rn(w, col[DCY * S], col[C0Y * S])) / r;
      nz = __fsub_rn(pz, __fmaf_rn(w, col[DCZ * S], col[C0Z * S])) / r;
    }
    front =
        __fmaf_rn(y.dz, nz, __fmaf_rn(y.dx, nx, __fmul_rn(y.dy, ny))) < 0.f;
    if (!front) {
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }

    // ---- texture: solid / checker / uv-debug -----------------------------
    tr = col[C1R * st];
    tg = col[C1G * st];
    tb = col[C1B * st];
    const float ttype = col[TTYPE * st];
    if (ttype == 1.0f) {
      const float sc = col[TSCALE * st];
      const float sines = __fmul_rn(
          __fmul_rn(sinf(__fmul_rn(sc, px)), sinf(__fmul_rn(sc, py))),
          sinf(__fmul_rn(sc, pz)));
      if (sines < 0.f) {
        tr = col[C2R * st];
        tg = col[C2G * st];
        tb = col[C2B * st];
      }
    }
    // (u, v, 0); the builder admits uv-debug on planar primitives only.
    if (planar && ttype == 4.0f) {
      tr = __fmaf_rn(bv, col[TUV * st], __fmaf_rn(bu, col[TUU * st],
                                                  col[TU0 * st]));
      tg = __fmaf_rn(bv, col[TVV * st], __fmaf_rn(bu, col[TVU * st],
                                                  col[TV0 * st]));
      tb = 0.f;
    }
    mtype = col[MTYPE * st];
    if constexpr (kDefer) {
      // A noise or image texel is shaded as 1.0 and recorded for the host.
      float ra = 0.f, rb = 0.f, rc = 0.f;
      int dcode = 0;
      if (ttype == 2.0f || ttype == 3.0f) {
        const int texid =
            (int)col[(planar ? (int)P_TEXID : (int)TEXID) * st];
        dcode = planar ? -(texid + 1) : texid + 1;
        if (ttype == 2.0f) {  // noise: the hit point
          ra = px;
          rb = py;
          rc = pz;
        } else if (planar) {  // planar image: its in-plane (u, v)
          ra = bu;
          rb = bv;
        } else {  // sphere image: the pre-flip outward normal
          ra = front ? nx : -nx;
          rb = front ? ny : -ny;
          rc = front ? nz : -nz;
        }
        tr = tg = tb = 1.0f;
      }
      const bool emits = mtype == 3.0f;
      put_record(rec, at, emits ? __fmul_rn(y.tpr, tr) : 0.f,
                 emits ? __fmul_rn(y.tpg, tg) : 0.f,
                 emits ? __fmul_rn(y.tpb, tb) : 0.f, ra, rb, rc, dcode);
    }
    if (mtype == 3.0f) {  // diffuse light: emit tp * tex and stop
      media_end<kEmit, kDefer, kPhase>(y, k + 1, __fmaf_rn(y.tpr, tr, 0.f),
                                       __fmaf_rn(y.tpg, tg, 0.f),
                                       __fmaf_rn(y.tpb, tb, 0.f), L, X, rad,
                                       seg, codes, rec);
      return;
    }
    const float len = sqrtf(__fadd_rn(a, 1e-20f));  // normalize(d, 1e-20)
    ux = y.dx / len;
    uy = y.dy / len;
    uz = y.dz / len;
    udn = __fmaf_rn(uz, nz, __fmaf_rn(ux, nx, __fmul_rn(uy, ny)));
  }

  // ---- scatter (materials.scatter_packed, the isotropic phase function) --
  // One draw, one unit vector and one cube root serve whichever scatter
  // the lane takes, so a warp whose lanes scatter off media and surfaces
  // runs that code once; each lane's keys and arithmetic are its own
  // branch's.
  const bool dielectric = !medium && mtype == 2.0f;
  const uint32_t salt =
      medium ? SALT_ISOTROPIC
             : (mtype == 1.0f ? SALT_METAL
                              : (dielectric ? SALT_DIELECTRIC
                                            : SALT_LAMBERTIAN));
  const float4 q = rand4(L.seed, rid, depth, salt);
  float3 b = make_float3(0.f, 0.f, 0.f);  // (r, phi, z)
  float cph = 0.f, sph = 0.f, br = 0.f;
  if (!dielectric) {
    b = unit_parts(q.x, q.y);
    cph = cosf(b.y);
    sph = sinf(b.y);
  }
  if (medium || mtype == 1.0f) br = cbrtf(q.z);
  float ndx, ndy, ndz;
  if (medium) {
    const float* __restrict__ vp = T.vt + vwin * N_VCOLS;
    ndx = __fmul_rn(__fmul_rn(b.x, cph), br);
    ndy = __fmul_rn(__fmul_rn(b.x, sph), br);
    ndz = __fmul_rn(b.z, br);
    y.tpr = __fmul_rn(y.tpr, vp[V_CR]);
    y.tpg = __fmul_rn(y.tpg, vp[V_CG]);
    y.tpb = __fmul_rn(y.tpb, vp[V_CB]);
  } else if (mtype == 1.0f) {  // metal: fuzzed mirror, absorbs when dot <= 0
    const float fuzz = col[FUZZ * st];
    const float u2 = __fadd_rn(udn, udn);
    ndx = __fmaf_rn(fuzz, __fmul_rn(__fmul_rn(b.x, cph), br),
                    __fmaf_rn(-u2, nx, ux));
    ndy = __fmaf_rn(fuzz, __fmul_rn(__fmul_rn(b.x, sph), br),
                    __fmaf_rn(-u2, ny, uy));
    ndz = __fmaf_rn(fuzz, __fmul_rn(b.z, br), __fmaf_rn(-u2, nz, uz));
    if (!(__fmaf_rn(nz, ndz, __fmaf_rn(nx, ndx, __fmul_rn(ny, ndy))) > 0.f)) {
      media_end<kEmit, kDefer, kPhase>(y, k + 1, 0.f, 0.f, 0.f, L, X, rad,
                                       seg, codes, rec);
      return;
    }
    y.tpr = __fmul_rn(y.tpr, tr);
    y.tpg = __fmul_rn(y.tpg, tg);
    y.tpb = __fmul_rn(y.tpb, tb);
  } else if (dielectric) {  // Schlick against the draw q.x
    const float ior = col[IOR * st];
    const float ratio = front ? 1.0f / ior : ior;
    const float cos_t = fminf(-udn, 1.0f);
    const float sin_t = sqrtf(fmaxf(__fmaf_rn(-cos_t, cos_t, 1.0f), 1e-12f));
    float r0 = __fsub_rn(1.0f, ratio) / __fadd_rn(1.0f, ratio);
    r0 = __fmul_rn(r0, r0);
    const float omc = __fsub_rn(1.0f, cos_t);
    const float omc2 = __fmul_rn(omc, omc);
    const float refl = __fmaf_rn(__fsub_rn(1.0f, r0),
                                 __fmul_rn(omc, __fmul_rn(omc2, omc2)), r0);
    if (__fmul_rn(ratio, sin_t) > 1.0f || refl > q.x) {
      const float u2 = __fadd_rn(udn, udn);
      ndx = __fmaf_rn(-u2, nx, ux);
      ndy = __fmaf_rn(-u2, ny, uy);
      ndz = __fmaf_rn(-u2, nz, uz);
    } else {  // refract (vecmath.refract)
      const float rpx = __fmul_rn(ratio, __fmaf_rn(cos_t, nx, ux));
      const float rpy = __fmul_rn(ratio, __fmaf_rn(cos_t, ny, uy));
      const float rpz = __fmul_rn(ratio, __fmaf_rn(cos_t, nz, uz));
      const float rp2 =
          __fmaf_rn(rpz, rpz, __fmaf_rn(rpx, rpx, __fmul_rn(rpy, rpy)));
      const float sq = sqrtf(fmaxf(fabsf(__fsub_rn(1.0f, rp2)), 1e-12f));
      ndx = __fmaf_rn(-sq, nx, rpx);
      ndy = __fmaf_rn(-sq, ny, rpy);
      ndz = __fmaf_rn(-sq, nz, rpz);
    }
  } else {  // lambertian: normal + unit vector, degenerate -> normal
    ndx = __fmaf_rn(b.x, cph, nx);
    ndy = __fmaf_rn(b.x, sph, ny);
    ndz = __fadd_rn(nz, b.z);
    if (fabsf(ndx) < 1e-8f && fabsf(ndy) < 1e-8f && fabsf(ndz) < 1e-8f) {
      ndx = nx;
      ndy = ny;
      ndz = nz;
    }
    y.tpr = __fmul_rn(y.tpr, tr);
    y.tpg = __fmul_rn(y.tpg, tg);
    y.tpb = __fmul_rn(y.tpb, tb);
  }
  // The scattered ray keeps the parent's shutter time.
  y.ox = px;
  y.oy = py;
  y.oz = pz;
  y.dx = ndx;
  y.dy = ndy;
  y.dz = ndz;
  y.k = k + 1;
  if (y.k == L.max_depth)  // alive when a phase's bounces run out
    media_end<kEmit, kDefer, kPhase>(y, L.max_depth, 0.f, 0.f, 0.f, L, X,
                                     rad, seg, codes, rec, kPhase);
}

// With kPhase (the phased launches at one lane a ray), a claim indexes the
// phase's lane list: with a state in, the slot resumes that lane from it
// (a lane that comes in dead ends at once, its state passed on), else it
// casts the lane's primary ray; the lane ends when it dies or when the
// phase's bounces run out, and writes its state at its own index.
template <bool kEmit, bool kDefer, bool kPhase>
__global__ void __launch_bounds__(kMediaBlock, 1)
media_kernel(const float* __restrict__ tab, const float* __restrict__ ptab,
             MediaTables T, const float* __restrict__ par, Launch L,
             Extra X, float* __restrict__ rad, int* __restrict__ seg,
             int* __restrict__ codes, Records rec,
             unsigned* __restrict__ next) {
  static_assert(!(kPhase && kEmit), "phases emit no codes");
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned below = (1u << (threadIdx.x & 31u)) - 1u;
  Lane y{-1, 0, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool more = true;  // the window may hold unclaimed lanes (warp-uniform)
  for (;;) {
    if (more) {  // claim lanes for the warp's empty slots: one atomic
      const unsigned m = __ballot_sync(kAll, y.i < 0);
      if (m) {
        unsigned base = 0;
        if ((threadIdx.x & 31u) == 0) base = atomicAdd(next, __popc(m));
        base = __shfl_sync(kAll, base, 0);
        const unsigned id = base + __popc(m & below);
        if (y.i < 0 && id < (unsigned)L.n_chunk) {
          if constexpr (kPhase) {
            if (X.st_in == nullptr) {
              cast_primary(y, (int)id, par, L);
            } else {  // the state the previous phase wrote
              const float* __restrict__ st =
                  X.st_in + (long long)id * N_STATE;
              y.i = (int)id;
              y.k = 0;
              y.ox = st[S_OX]; y.oy = st[S_OY]; y.oz = st[S_OZ];
              y.dx = st[S_DX]; y.dy = st[S_DY]; y.dz = st[S_DZ];
              y.tpr = st[S_TPR]; y.tpg = st[S_TPG]; y.tpb = st[S_TPB];
              y.time = st[S_TIME];
              if (!(st[S_ALIVE] > 0.f))
                media_end<kEmit, kDefer, kPhase>(y, 0, st[S_RR], st[S_RG],
                                                 st[S_RB], L, X, rad, seg,
                                                 codes, rec);
            }
            if (y.i >= 0 && L.max_depth < 1)  // no bounce: still alive
              media_end<kEmit, kDefer, kPhase>(y, 0, 0.f, 0.f, 0.f, L, X,
                                               rad, seg, codes, rec, true);
          } else {
            cast_primary(y, (int)id, par, L);
            if (L.max_depth < 1)  // no bounce: rad 0, seg 0
              media_end<kEmit, kDefer, kPhase>(y, 0, 0.f, 0.f, 0.f, L, X,
                                               rad, seg, codes, rec);
          }
        }
        if (base + __popc(m) >= (unsigned)L.n_chunk) more = false;
      }
    }
    if (!__any_sync(kAll, y.i >= 0)) {
      // Lanes that came in dead leave their slots empty: claim again.
      if constexpr (kPhase) {
        if (more) continue;
      }
      break;
    }
    if (y.i >= 0)
      media_bounce<kEmit, kDefer, kPhase>(y, T, tab, ptab, par, L, X, rad,
                                          seg, codes, rec);
  }
}

// One media launch on the resident blocks (or, with `occ`, the resident
// blocks per SM).
template <bool kEmit, bool kDefer, bool kPhase>
cudaError_t launch_media(const float* tab, const float* ptab,
                         const MediaTables& T, const float* par,
                         const Launch& L, const Extra& X, float* rad,
                         int* seg, int* codes, const Records& rec,
                         unsigned* next, cudaStream_t stream, int* occ) {
  const auto kernel = media_kernel<kEmit, kDefer, kPhase>;
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kMediaBlock, 0);
  if (err != cudaSuccess) return err;
  if (occ != nullptr) {
    *occ = blocks;
    return cudaSuccess;
  }
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = ((long long)L.n_chunk + kMediaBlock - 1) /
                         kMediaBlock;
  const long long resident = (long long)blocks * sms;
  const int grid = (int)(want < resident ? want : resident);
  kernel<<<grid, kMediaBlock, 0, stream>>>(tab, ptab, T, par, L, X, rad, seg,
                                           codes, rec, next);
  return cudaGetLastError();
}

// The instantiations megakernel_media.cu compiles: the single passes, and
// the phased launches at one lane a ray (no codes).
#define RTW_MEDIA_LAUNCHER(PREFIX, E, D, P)                                 \
  PREFIX template cudaError_t launch_media<E, D, P>(                        \
      const float*, const float*, const MediaTables&, const float*,         \
      const Launch&, const Extra&, float*, int*, int*, const Records&,      \
      unsigned*, cudaStream_t, int*);
#define RTW_MEDIA_LAUNCHERS(PREFIX)                                         \
  RTW_MEDIA_LAUNCHER(PREFIX, false, false, false)                           \
  RTW_MEDIA_LAUNCHER(PREFIX, false, true, false)                            \
  RTW_MEDIA_LAUNCHER(PREFIX, true, false, false)                            \
  RTW_MEDIA_LAUNCHER(PREFIX, true, true, false)                             \
  RTW_MEDIA_LAUNCHER(PREFIX, false, false, true)                            \
  RTW_MEDIA_LAUNCHER(PREFIX, false, true, true)

// One launch of render_kernel with the geometry flags of the scene's
// families: (kSph, !kPla), (!kSph, kPla) or both; with media (kVol) always
// both, either loop then running over the family's count, which may be 0.
// The sphere-only single pass is launch_spheres' and the single pass with
// media launch_media's, so (kSph, !kPla) and kVol are only instantiated
// phased.
template <bool kEmit, bool kDefer, bool kVol, bool kPhase>
cudaError_t launch_render(const float* tab, const float* ptab,
                          const float4* ptest, const float* par,
                          const Launch& L, const Extra& X, float* rad,
                          int* seg, int* codes, const Records& rec,
                          cudaStream_t stream, int* occ) {
  if constexpr (kVol) {
    return run_render<kEmit, true, true, kDefer, kVol, kPhase>(
        tab, ptab, ptest, par, L, X, rad, seg, codes, rec, stream, occ);
  } else {
    if (L.n_planar == 0) {
      if constexpr (kPhase)
        return run_render<kEmit, true, false, kDefer, kVol, kPhase>(
            tab, ptab, ptest, par, L, X, rad, seg, codes, rec, stream, occ);
      else
        return cudaErrorInvalidValue;  // launch_spheres' launches
    }
    if (L.n_spheres == 0)
      return run_render<kEmit, false, true, kDefer, kVol, kPhase>(
          tab, ptab, ptest, par, L, X, rad, seg, codes, rec, stream, occ);
    return run_render<kEmit, true, true, kDefer, kVol, kPhase>(
        tab, ptab, ptest, par, L, X, rad, seg, codes, rec, stream, occ);
  }
}

// The instantiations megakernel_vp.cu compiles: the phased launches (no
// codes), with media and without.
#define RTW_VP_LAUNCHER(PREFIX, E, D, V, P)                                \
  PREFIX template cudaError_t launch_render<E, D, V, P>(                   \
      const float*, const float*, const float4*, const float*,             \
      const Launch&, const Extra&, float*, int*, int*, const Records&,     \
      cudaStream_t, int*);
#define RTW_VP_LAUNCHERS(PREFIX)                                            \
  RTW_VP_LAUNCHER(PREFIX, false, false, false, true)                        \
  RTW_VP_LAUNCHER(PREFIX, false, true, false, true)                         \
  RTW_VP_LAUNCHER(PREFIX, false, false, true, true)                         \
  RTW_VP_LAUNCHER(PREFIX, false, true, true, true)

}  // namespace rtw
