// The deferred combine of image-only scenes (forward) and its vector-Jacobian
// product, one warp a lane.
//
// Replaces no TPU kernel: the JAX package's `_combine_deferred`
// (raytracer_weekend_tpu/ops/pallas/megakernel.py) is jnp code that XLA
// fuses; the port ran it as PyTorch ops and differentiated them with
// autograd. Both kernels read the records that K6a writes, one 32-byte row a
// lane and bounce: ctb (3 floats), abc (3 floats), dcode's int32 bits, 0.
// For a scene whose deferred texels are image texels only (no noise), with
// the texel f_k of record k fetched where dcode != 0 (nearest fetch at the
// spherical UV of abc for a sphere, dcode > 0; at abc's (u, v) for a planar
// texel, dcode < 0) and f_k = 1 where dcode is 0:
//
//   combine_kernel      rad = sum_k ctb_k * prod_{j<=k} f_j, continued from
//                       (rad, F) of earlier records when given (the depth
//                       phases' chain), and the factor product F after the
//                       last record;
//   combine_vjp_kernel  for the radiance cotangent g: g_k = g * prod_{j<=k}
//                       f_j for every slot (the records' contribution
//                       cotangents that K2/K7 take), and, atomically into a
//                       zeroed texel gradient, for each live record j
//                       dL/df_j = g_{j-1} * S_j (g_{-1} = g), with the suffix
//                       S_j = ctb_j + f_{j+1} * S_{j+1}. No division by a
//                       texel (a texel may be 0 in a channel), and dead
//                       records add nothing: no anchor texel collects them.
//
// Numerics: every add and multiply is written out as _rn (no FMA
// contraction), in the order of the PyTorch loop of
// ops/cuda/megakernel.py:combine_deferred, and the spherical UV and the
// fetch are PyTorch's CUDA ops': acosf and atan2f, + pi, and the division by
// a scalar as PyTorch's CUDA kernels compute it, times the scalar's float
// reciprocal. So rad and F equal that loop on the card bit for bit, g_k
// equals autograd's products, and the texel gradient differs only by the
// order of its atomic adds.
//
// What bounds it on an H100: bytes. A lane's D records are 32 D bytes (2.30
// GB for 1.44M lanes at depth 50) against ~20 operations a record and a
// 12-byte texel gather for the few live ones (0.46 a lane on the earth), so
// reading the records takes ~0.7 ms at 3.35 TB/s; the VJP also writes g_k,
// 12 D bytes a lane. The design: a warp carries a lane, 32 of its records
// at a time, one a thread, so the rows are read as whole contiguous lines
// and g_k is written so too (one thread a lane, each 32-byte row and
// 12-byte g_k write of a warp fell on 32 separate lines: the VJP took 7.3
// ms on earth.fit16's records). Only live records gather a texel, all of a
// chunk's at once. The running product and sum stay sequential, as the
// loop's: the warp walks the chunk's active records (live, or with a
// nonzero ctb) in order, each broadcast by shuffles, and skips the others,
// whose term is 0 and whose factor is 1 (the records' ctb are radiance,
// never negative, so skipping adds nothing the loop would not). The VJP's
// second walk, backward over the active records from the lane's last one
// down to its first live one, carries f_{k+1} * S_{k+1} past the inactive
// records, re-reads those chunks (mostly still in L2) and the g_{k-1} the
// warp wrote, and is skipped by lanes without a live record. Neither
// kernel stops at a lane's end: a zero record past it cannot be told from
// a mid-path bounce without the segment count, and the rows are read once
// anyway.
#include <cuda_runtime.h>

namespace rtw {
namespace combine {

constexpr int kWarps = 8;  // lanes (warps) a block
constexpr int kBlock = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;
// PyTorch's float pi, and its CUDA division by a scalar: a * (1 / (float)b).
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvTwoPi = 1.0f / 6.28318530717958647692f;
constexpr float kInvPi = 1.0f / 3.14159265358979323846f;
constexpr float kPole = 0.9999999f;

// One record of a lane, as a thread of its warp holds it: the fetched texel
// f (1 where dead) and its atlas offset in floats.
struct Slot {
  float3 ctb, f;
  long long texel;
  bool live, active;
};

__device__ __forceinline__ float3 mul3(float3 a, float3 b) {
  return make_float3(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ float3 add3(float3 a, float3 b) {
  return make_float3(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z));
}

__device__ __forceinline__ float3 load3(const float* p) {
  return make_float3(p[0], p[1], p[2]);
}

__device__ __forceinline__ float3 shfl3(float3 v, int src) {
  return make_float3(__shfl_sync(kAll, v.x, src), __shfl_sync(kAll, v.y, src),
                     __shfl_sync(kAll, v.z, src));
}

// The atlas offset (in floats) of a live record's texel: textures.py's
// nearest `_image_fetch` at sphere_uv(abc) (code > 0) or abc's (u, v).
// `tex` holds, per texture, its image, height and width.
__device__ __forceinline__ long long texel(float3 abc, int code,
                                           const int4* __restrict__ tex,
                                           int ph, int pw) {
  const int4 t = __ldg(tex + (abs(code) - 1));
  float u, v;
  if (code > 0) {
    const float y = fminf(fmaxf(-abc.y, -kPole), kPole);
    const float theta = acosf(y);
    const float phi = __fadd_rn(atan2f(-abc.z, abc.x), kPi);
    u = __fmul_rn(phi, kInvTwoPi);
    v = __fmul_rn(theta, kInvPi);
  } else {
    u = abc.x;
    v = abc.y;
  }
  const float uc = fminf(fmaxf(u, 0.0f), 1.0f);
  const float vc = __fsub_rn(1.0f, fminf(fmaxf(v, 0.0f), 1.0f));
  long long i = (long long)__fmul_rn(uc, (float)t.z);
  long long j = (long long)__fmul_rn(vc, (float)t.y);
  i = min(max(i, 0LL), (long long)(t.z - 1));
  j = min(max(j, 0LL), (long long)(t.y - 1));
  return 3 * (((long long)t.x * ph + j) * pw + i);
}

// Record k of the lane whose rows start at `row` (nothing past D): its two
// 16-byte halves, and the texel of a live one.
__device__ __forceinline__ Slot load_slot(const float4* __restrict__ row,
                                          int k, int D,
                                          const int4* __restrict__ tex,
                                          const float* __restrict__ images,
                                          int ph, int pw) {
  Slot s{make_float3(0.0f, 0.0f, 0.0f), make_float3(1.0f, 1.0f, 1.0f), 0,
         false, false};
  if (k >= D) return s;
  const float4 a = __ldg(row + 2 * k), b = __ldg(row + 2 * k + 1);
  const int code = __float_as_int(b.z);
  s.ctb = make_float3(a.x, a.y, a.z);
  s.live = code != 0;
  s.active = s.live || a.x != 0.0f || a.y != 0.0f || a.z != 0.0f;
  if (s.live) {
    s.texel = texel(make_float3(a.w, b.x, b.y), code, tex, ph, pw);
    const float* f = images + s.texel;
    s.f = make_float3(__ldg(f), __ldg(f + 1), __ldg(f + 2));
  }
  return s;
}

__global__ void __launch_bounds__(kBlock)
    combine_kernel(const float4* __restrict__ rows, int n, int D,
                   const int4* __restrict__ tex,
                   const float* __restrict__ images, int ph, int pw,
                   const float* __restrict__ init_rad,
                   const float* __restrict__ init_fac,
                   float* __restrict__ rad_out, float* __restrict__ fac_out) {
  const int me = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  // Without `init` the loop's sum starts at its first term, which is +0
  // plus that term.
  float3 rad = make_float3(0.0f, 0.0f, 0.0f);
  float3 cp = make_float3(1.0f, 1.0f, 1.0f);
  if (init_rad != nullptr) {
    rad = load3(init_rad + 3 * i);
    cp = load3(init_fac + 3 * i);
  }
  const float4* row = rows + 2 * i * D;
  for (int c = 0; c < D; c += 32) {
    const Slot s = load_slot(row, c + me, D, tex, images, ph, pw);
    for (unsigned act = __ballot_sync(kAll, s.active); act; act &= act - 1) {
      const int j = __ffs(act) - 1;
      const float3 ctb = shfl3(s.ctb, j), f = shfl3(s.f, j);
      if (__shfl_sync(kAll, s.live, j)) cp = mul3(cp, f);
      rad = add3(rad, mul3(ctb, cp));
    }
  }
  if (me == 0) {
    rad_out[3 * i] = rad.x;
    rad_out[3 * i + 1] = rad.y;
    rad_out[3 * i + 2] = rad.z;
    if (fac_out != nullptr) {
      fac_out[3 * i] = cp.x;
      fac_out[3 * i + 1] = cp.y;
      fac_out[3 * i + 2] = cp.z;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    combine_vjp_kernel(const float4* __restrict__ rows, int n, int D,
                       const int4* __restrict__ tex,
                       const float* __restrict__ images, int ph, int pw,
                       const float* __restrict__ g, float* __restrict__ gk,
                       float* __restrict__ d_images) {
  const int me = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const float3 gi = load3(g + 3 * i);
  const float4* row = rows + 2 * i * D;
  float* out = gk + 3 * i * D;
  // Pass 1: the prefix products in the loop's order and g_k = g * P_k; the
  // chunks the second walk spans.
  float3 cp = make_float3(1.0f, 1.0f, 1.0f);
  int first = D, last = -1;
  for (int c = 0; c < D; c += 32) {
    const Slot s = load_slot(row, c + me, D, tex, images, ph, pw);
    float3 mine = cp;
    const unsigned live = __ballot_sync(kAll, s.live);
    for (unsigned lv = live; lv; lv &= lv - 1) {
      const int j = __ffs(lv) - 1;
      cp = mul3(cp, shfl3(s.f, j));
      if (me >= j) mine = cp;
    }
    if (c + me < D) {
      float* o = out + 3 * (c + me);
      o[0] = __fmul_rn(gi.x, mine.x);
      o[1] = __fmul_rn(gi.y, mine.y);
      o[2] = __fmul_rn(gi.z, mine.z);
    }
    const unsigned act = __ballot_sync(kAll, s.active);
    if (live && first == D) first = c + __ffs(live) - 1;
    if (act) last = c + 31 - __clz(act);
  }
  if (d_images == nullptr || first > last) return;
  __syncwarp();  // g_{k-1} written by another thread is read below
  // Pass 2, backward over the active records: S_k = ctb_k + T_{k+1} with
  // T_k = f_k * S_k (S_k where dead), which an inactive record passes on;
  // at a live record dL/df_k = g_{k-1} * S_k.
  float3 carry = make_float3(0.0f, 0.0f, 0.0f);
  for (int c = last & ~31; c >= (first & ~31); c -= 32) {
    const Slot s = load_slot(row, c + me, D, tex, images, ph, pw);
    unsigned act = __ballot_sync(kAll, s.active && c + me >= first);
    while (act) {
      const int j = 31 - __clz(act);
      act &= ~(1u << j);
      const float3 sk = add3(shfl3(s.ctb, j), carry);
      carry = sk;
      if (__shfl_sync(kAll, s.live, j)) {
        carry = mul3(shfl3(s.f, j), sk);
        if (me == j) {
          const int k = c + j;
          const float3 gp = mul3(k ? load3(out + 3 * (k - 1)) : gi, sk);
          atomicAdd(d_images + s.texel, gp.x);
          atomicAdd(d_images + s.texel + 1, gp.y);
          atomicAdd(d_images + s.texel + 2, gp.z);
        }
      }
    }
  }
}

}  // namespace combine
}  // namespace rtw

extern "C" {

// rad (n x 3) and, with a non-null `fac`, the factor product F (n x 3) of
// the records `rows` (n x D x 8 floats) on `stream`; `init_rad` and
// `init_fac` (n x 3 each, both or neither) continue a chain. `tex` is
// (textures x 4) int32: image, height, width, 0; `images` the (I, ph, pw,
// 3) atlas. Returns cudaGetLastError() after the launch.
int rtw_combine_images(const float* rows, int n, int D, const int* tex,
                       const float* images, int ph, int pw,
                       const float* init_rad, const float* init_fac,
                       float* rad, float* fac, void* stream) {
  using namespace rtw::combine;
  if (n <= 0) return 0;
  const int grid = (int)(((long long)n + kWarps - 1) / kWarps);
  combine_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rows), n, D,
      reinterpret_cast<const int4*>(tex), images, ph, pw, init_rad, init_fac,
      rad, fac);
  return (int)cudaGetLastError();
}

// g_k (n x D x 3) for the radiance cotangent g (n x 3) of the records
// `rows` on `stream`, and, with a non-null `d_images` (zeroed, the atlas's
// shape), the texel gradient added into it. Arguments as
// rtw_combine_images'. Returns cudaGetLastError() after the launch.
int rtw_combine_images_vjp(const float* rows, int n, int D, const int* tex,
                           const float* images, int ph, int pw,
                           const float* g, float* gk, float* d_images,
                           void* stream) {
  using namespace rtw::combine;
  if (n <= 0) return 0;
  const int grid = (int)(((long long)n + kWarps - 1) / kWarps);
  combine_vjp_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rows), n, D,
      reinterpret_cast<const int4*>(tex), images, ph, pw, g, gk, d_images);
  return (int)cudaGetLastError();
}

}  // extern "C"
