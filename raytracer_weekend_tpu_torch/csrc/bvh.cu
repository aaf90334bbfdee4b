// Closest hit by a walk of the skip-link BVH: the staged path's tree kernels
// BVH-sph (moving spheres) and BVH-tri (triangles).
//
// Replaces no TPU kernel: the JAX package walks the same tree with a
// jnp `lax.while_loop` (raytracer_weekend_tpu/ops/bvh.py:43 `traverse`,
// with the leaf tests `sphere_prim_test` :97 and `triangle_prim_test`
// :124), not in Pallas. It is a kernel here because the lockstep loop in
// torch, about 30 small operations a step over the whole batch for as many
// steps as the longest walk, takes seconds a bounce on the card.
//
// The function is that of the plain version, ops/bvh.py `traverse` with its
// leaf tests, step for step, so that the kernel is held to it bit for bit:
//   * the tree is the flat DFS layout of native/bvh_builder.cpp; a ray's
//     cursor starts at node 0, a box hit moves it to the next node (and
//     tests the primitive when the node is a leaf), a box miss to skip[i];
//   * the slab test runs against (t_min, t_best): per axis (bmin - o) * inv_d
//     and (bmax - o) * inv_d with inv_d = 1 / d (IEEE: +-inf on a zero
//     component), near and far their min and max, enter = max(max(near),
//     t_min), exit = min(min(far), t_best), a hit where enter < exit. The
//     plain version's torch.minimum/maximum/amax propagate NaN (o on a
//     slab's plane with a zero component of d gives 0 * inf), and then the
//     box misses; fminf/fmaxf would drop the NaN, so any NaN of the six
//     slab times is a miss here;
//   * a leaf is taken only where its t is strictly below the best so far:
//     on an exact tie the first leaf in DFS order keeps the ray. A ray that
//     hits no leaf gets t = +inf and prim 0;
//   * the sphere leaf is the oc form of the JAX leaf test: w = (time - t0) /
//     dt, c = c0 + w dc, oc = o - c, a = |d|^2, half_b = oc.d, c_term =
//     |oc|^2 - r^2, disc = half_b^2 - a c_term, the roots (-half_b -+
//     sqrt(disc)) * (1 / a), the first in [t_min, t_best] else the second.
//     It reads K10's packed table (ops/cuda/sphere_intersect.py
//     TABLE_ROWS: c0, r^2, valid, t0, dt, dc), whose terms torch computes
//     as the plain version does (dc = c1 - c0, dt = t1 - t0, r^2 = r r);
//   * the triangle leaf is Moller-Trumbore in the JAX leaf test's scalar
//     triple form, against rows {v0, valid; ab; ac; n = ab x ac} that
//     torch computes as the plain version does (ops/bvh.py
//     `triangle_edges`): det = -d.n (0 guarded), u = ac.(ao x d) / det,
//     v = -ab.(ao x d) / det, t = ao.n / det with ao = o - v0.
// Every add, multiply and division is one rounded IEEE operation
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn: no contraction into FMAs)
// in the plain version's order; each three-term dot is (x0 + x1) + x2.
// No fast math.
//
// What bounds it on an H100: FP32 issue and the latency of the node loads.
// A ray visits some tens to hundreds of nodes (the count depends on the
// ray: phase 15 of chip_smoke.py counts them on its rays), 12 operations a
// slab test, about 30 a sphere leaf and 37 a triangle leaf; the tree (two
// float4 a node: (bmin.xyz, prim), (bmax.xyz, skip)) and the leaf rows sit
// in L2 (the cow's 11,607 nodes are 371 KB). Design: one thread a ray, the
// node rows read by __ldg as two 16-byte loads, no stack. Simple first: a
// short stack, wider nodes or rays sorted by direction are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace rtw {
namespace bvh {

constexpr int kBlock = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// The sphere leaf on row `row` of K10's table (4 float4): t and whether it
// is accepted in [t_min, t_max].
__device__ __forceinline__ bool sphere_leaf(const float4* __restrict__ rows,
                                            int row, const Ray& r, float time,
                                            float a, float inv_a, float t_min,
                                            float t_max, float* t_out) {
  const float4 q0 = __ldg(&rows[4 * row + 0]);  // c0.xyz, |c0|^2
  const float4 q1 = __ldg(&rows[4 * row + 1]);  // r^2, valid, t0, dt
  const float4 q2 = __ldg(&rows[4 * row + 2]);  // dc.xyz, c0.dc
  const float w = __fdiv_rn(__fsub_rn(time, q1.z), q1.w);
  const float ocx = __fsub_rn(r.ox, __fadd_rn(q0.x, __fmul_rn(w, q2.x)));
  const float ocy = __fsub_rn(r.oy, __fadd_rn(q0.y, __fmul_rn(w, q2.y)));
  const float ocz = __fsub_rn(r.oz, __fadd_rn(q0.z, __fmul_rn(w, q2.z)));
  const float half_b = dot3(ocx, ocy, ocz, r.dx, r.dy, r.dz);
  const float c_term = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), q1.x);
  const float disc = __fsub_rn(__fmul_rn(half_b, half_b),
                               __fmul_rn(a, c_term));
  if (!(disc > 0.0f) || q1.y == 0.0f) return false;
  const float sq = __fsqrt_rn(disc);
  const float root1 = __fmul_rn(__fsub_rn(-half_b, sq), inv_a);
  const float root2 = __fmul_rn(__fadd_rn(-half_b, sq), inv_a);
  const float root = (root1 >= t_min && root1 <= t_max) ? root1 : root2;
  *t_out = root;
  return root >= t_min && root <= t_max;
}

// The triangle leaf on row `row` of the triangle rows (4 float4).
__device__ __forceinline__ bool triangle_leaf(const float4* __restrict__ rows,
                                              int row, const Ray& r,
                                              float t_min, float t_max,
                                              float* t_out) {
  const float4 q0 = __ldg(&rows[4 * row + 0]);  // v0.xyz, valid
  const float4 ab = __ldg(&rows[4 * row + 1]);
  const float4 ac = __ldg(&rows[4 * row + 2]);
  const float4 n = __ldg(&rows[4 * row + 3]);
  const float det = -dot3(r.dx, r.dy, r.dz, n.x, n.y, n.z);
  const bool degen = det == 0.0f;
  const float inv_det = __fdiv_rn(1.0f, degen ? 1.0f : det);
  const float aox = __fsub_rn(r.ox, q0.x);
  const float aoy = __fsub_rn(r.oy, q0.y);
  const float aoz = __fsub_rn(r.oz, q0.z);
  // ao x d, each component a1 b2 - a2 b1 with both products rounded.
  const float wx = __fsub_rn(__fmul_rn(aoy, r.dz), __fmul_rn(aoz, r.dy));
  const float wy = __fsub_rn(__fmul_rn(aoz, r.dx), __fmul_rn(aox, r.dz));
  const float wz = __fsub_rn(__fmul_rn(aox, r.dy), __fmul_rn(aoy, r.dx));
  const float u = __fmul_rn(dot3(ac.x, ac.y, ac.z, wx, wy, wz), inv_det);
  const float v = __fmul_rn(-dot3(ab.x, ab.y, ab.z, wx, wy, wz), inv_det);
  const float t = __fmul_rn(dot3(aox, aoy, aoz, n.x, n.y, n.z), inv_det);
  *t_out = t;
  return t >= t_min && t <= t_max && t >= 0.0f && u >= 0.0f && v >= 0.0f &&
         __fadd_rn(u, v) <= 1.0f && !degen && q0.w != 0.0f;
}

// One thread a ray: the skip-link walk of `traverse`. `counts`, when not
// null, gets the nodes visited and the leaves tested added (a probe for the
// bound; the staged path passes null).
template <bool kSphere>
__global__ void __launch_bounds__(kBlock)
    bvh_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ time, int n,
               const float4* __restrict__ nodes, int M,
               const float4* __restrict__ rows, float t_min,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               unsigned long long* __restrict__ counts) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = o[3 * i + 0];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  const float ix = __fdiv_rn(1.0f, r.dx);
  const float iy = __fdiv_rn(1.0f, r.dy);
  const float iz = __fdiv_rn(1.0f, r.dz);
  float tm = 0.0f, a = 0.0f, inv_a = 0.0f;
  if constexpr (kSphere) {
    tm = time[i];
    a = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
    inv_a = __fdiv_rn(1.0f, a);
  }
  float best = INFINITY;
  int best_prim = 0;
  int cursor = 0;
  unsigned visited = 0, leaves = 0;
  while (cursor < M) {
    const float4 lo = __ldg(&nodes[2 * cursor]);
    const float4 hi = __ldg(&nodes[2 * cursor + 1]);
    const float t0x = __fmul_rn(__fsub_rn(lo.x, r.ox), ix);
    const float t0y = __fmul_rn(__fsub_rn(lo.y, r.oy), iy);
    const float t0z = __fmul_rn(__fsub_rn(lo.z, r.oz), iz);
    const float t1x = __fmul_rn(__fsub_rn(hi.x, r.ox), ix);
    const float t1y = __fmul_rn(__fsub_rn(hi.y, r.oy), iy);
    const float t1z = __fmul_rn(__fsub_rn(hi.z, r.oz), iz);
    const bool nan = isnan(t0x) || isnan(t0y) || isnan(t0z) ||
                     isnan(t1x) || isnan(t1y) || isnan(t1z);
    const float enter = fmaxf(
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)),
        t_min);
    const float exit = fminf(
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)),
        best);
    const bool box = !nan && enter < exit;
    const int prim = __float_as_int(lo.w);
    ++visited;
    if (box && prim >= 0) {
      ++leaves;
      float t;
      bool hit;
      if constexpr (kSphere)
        hit = sphere_leaf(rows, prim, r, tm, a, inv_a, t_min, best, &t);
      else
        hit = triangle_leaf(rows, prim, r, t_min, best, &t);
      if (hit && t < best) {
        best = t;
        best_prim = prim;
      }
    }
    cursor = box ? cursor + 1 : __float_as_int(hi.w);
  }
  t_out[i] = best;
  prim_out[i] = best_prim;
  if (counts != nullptr) {
    atomicAdd(&counts[0], (unsigned long long)visited);
    atomicAdd(&counts[1], (unsigned long long)leaves);
  }
}

template <bool kSphere>
int launch(const float* o, const float* d, const float* time, int n,
           const float* nodes, int M, const float* rows, float t_min,
           float* t_out, int* prim_out, unsigned long long* counts,
           void* stream) {
  if (n <= 0) return 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (n + kBlock - 1) / kBlock;
  bvh_kernel<kSphere><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      o, d, time, n, reinterpret_cast<const float4*>(nodes), M,
      reinterpret_cast<const float4*>(rows), t_min, t_out, prim_out, counts);
  return (int)cudaGetLastError();
}

}  // namespace bvh
}  // namespace rtw

extern "C" {

// BVH-sph: closest sphere through the tree of M nodes (M x 8 floats, prim
// and skip as int32 bits) over K10's packed (S x 16) table, for n rays on
// `stream`. With a non-null `counts` (two zeroed uint64) it adds the nodes
// visited and the leaves tested there. Returns cudaGetLastError() after the
// launch; it does not sync.
int rtw_bvh_spheres(const float* o, const float* d, const float* time,
                    int n, const float* nodes, int M, const float* rows,
                    float t_min, float* t_out, int* prim_out,
                    unsigned long long* counts, void* stream) {
  return rtw::bvh::launch<true>(o, d, time, n, nodes, M, rows, t_min, t_out,
                                prim_out, counts, stream);
}

// BVH-tri: closest triangle through the tree over the triangle rows
// (T x 16 floats: v0.xyz, valid; ab; ac; n), as rtw_bvh_spheres.
int rtw_bvh_triangles(const float* o, const float* d, int n,
                      const float* nodes, int M, const float* rows,
                      float t_min, float* t_out, int* prim_out,
                      unsigned long long* counts, void* stream) {
  return rtw::bvh::launch<false>(o, d, nullptr, n, nodes, M, rows, t_min,
                                 t_out, prim_out, counts, stream);
}

}  // extern "C"
