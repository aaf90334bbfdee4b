// The fused forward kernel's C entry and its instantiations without media
// or phases; the kernels themselves are csrc/megakernel.cuh, the phased
// instantiations are in megakernel_vp.cu and the single pass with media in
// megakernel_media.cu (each compiled by an nvcc of its own).
#include "megakernel.cuh"

namespace rtw {

RTW_VP_LAUNCHERS(extern)
RTW_MEDIA_LAUNCHERS(extern)

__global__ void rand4_kernel(const uint32_t* __restrict__ ids, int n,
                             uint32_t depth, uint32_t salt, uint32_t seed,
                             float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rand4(seed, ids[i], depth, salt);
}

__global__ void candidate_kernel(const float* __restrict__ num,
                                 const float* __restrict__ den,
                                 const float* __restrict__ best, int n,
                                 float t_min, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = plane_candidate(num[i], den[i], t_min, best[i]) ? 1 : 0;
}

template <bool kVol, bool kPhase>
cudaError_t launch_modes(const float* tab, const float* ptab,
                         const float4* ptest, const float* par,
                         const Launch& L, const Extra& X, float* rad,
                         int* seg, int* codes, const Records& rec, bool defer,
                         cudaStream_t st, int* occ) {
  if constexpr (!kPhase) {  // phases never emit codes
    if (codes && defer)
      return launch_render<true, true, kVol, kPhase>(
          tab, ptab, ptest, par, L, X, rad, seg, codes, rec, st, occ);
    if (codes)
      return launch_render<true, false, kVol, kPhase>(
          tab, ptab, ptest, par, L, X, rad, seg, codes, rec, st, occ);
  }
  if (defer)
    return launch_render<false, true, kVol, kPhase>(
        tab, ptab, ptest, par, L, X, rad, seg, nullptr, rec, st, occ);
  return launch_render<false, false, kVol, kPhase>(
      tab, ptab, ptest, par, L, X, rad, seg, nullptr, rec, st, occ);
}

// The persistent kernels' operands (sphere_kernel, media_kernel): the
// packed sphere rows (n_spheres x 3 float4), for sphere_kernel 1/0 to keep
// them in shared memory or not (-1: by kSphereRowLimit), the launch's lane
// counter (zeroed; null for a launch on render_kernel) and, for
// sphere_kernel, the records as one (n_chunk x max_depth) array of 32-byte
// rows, or null.
struct SphereOps {
  const float4* rows;
  int resident;
  unsigned* next;
  float4* recs;
};

cudaError_t dispatch(const float* tab, const float* ptab, const float4* ptest,
                     const float* par, const Launch& L, const Extra& X,
                     float* rad, int* seg, int* codes, const Records& rec,
                     const SphereOps& P, bool defer, bool vol, bool phase,
                     bool refill, cudaStream_t st, int* occ) {
  if (!vol && !phase && L.n_planar == 0) {
    if (codes && defer)
      return launch_spheres<true, true>(tab, P.rows, par, L, P.resident, rad,
                                        seg, codes, P.recs, P.next, st, occ);
    if (codes)
      return launch_spheres<true, false>(tab, P.rows, par, L, P.resident,
                                         rad, seg, codes, P.recs, P.next, st,
                                         occ);
    if (defer)
      return launch_spheres<false, true>(tab, P.rows, par, L, P.resident,
                                         rad, seg, codes, P.recs, P.next, st,
                                         occ);
    return launch_spheres<false, false>(tab, P.rows, par, L, P.resident, rad,
                                        seg, codes, P.recs, P.next, st, occ);
  }
  // A phased launch with media at one lane a ray that the caller sends to
  // media_kernel (`refill`) refills dead lanes there; the others stay on
  // render_kernel.
  if (vol && (!phase || refill)) {
    const MediaTables T{X.vtab, P.rows, ptest};
    if (phase) {  // phases emit no codes
      if (defer)
        return launch_media<false, true, true>(tab, ptab, T, par, L, X, rad,
                                               seg, codes, rec, P.next, st,
                                               occ);
      return launch_media<false, false, true>(tab, ptab, T, par, L, X, rad,
                                              seg, codes, rec, P.next, st,
                                              occ);
    }
    if (codes && defer)
      return launch_media<true, true, false>(tab, ptab, T, par, L, X, rad,
                                             seg, codes, rec, P.next, st,
                                             occ);
    if (codes)
      return launch_media<true, false, false>(tab, ptab, T, par, L, X, rad,
                                              seg, codes, rec, P.next, st,
                                              occ);
    if (defer)
      return launch_media<false, true, false>(tab, ptab, T, par, L, X, rad,
                                              seg, codes, rec, P.next, st,
                                              occ);
    return launch_media<false, false, false>(tab, ptab, T, par, L, X, rad,
                                             seg, codes, rec, P.next, st,
                                             occ);
  }
  if (vol)
    return launch_modes<true, true>(tab, ptab, ptest, par, L, X, rad, seg,
                                    codes, rec, defer, st, occ);
  if (phase)
    return launch_modes<false, true>(tab, ptab, ptest, par, L, X, rad, seg,
                                     codes, rec, defer, st, occ);
  return launch_modes<false, false>(tab, ptab, ptest, par, L, X, rad, seg,
                                    codes, rec, defer, st, occ);
}

}  // namespace rtw

extern "C" {

// Renders lanes [lane_start, lane_start + n_chunk) on `stream`: sphere
// table `tab` (N_ROWS x n_spheres), planar table `ptab` (N_PROWS x
// n_planar) with its packed test rows `ptest` (n_planar float4 (n, k), then
// n_planar x 3 float4 (ua, ca), (ub, cb), (flag, 0, 0, 0); 16-byte
// aligned), and volume table `vtab` (n_volumes x N_VCOLS), any count 0 (and
// its tables unused) but not both surface counts. `log10` selects the
// reference's log10 scatter distance. With a non-null `codes` (n_chunk x
// max_depth int32) it also writes the winner codes. With non-null `ctb`,
// `abc` (n_chunk x max_depth x 3 f32) and `dcode` (n_chunk x max_depth
// int32) it defers noise and image texels and writes their records. With a
// non-null `st_out` (n_chunk x 15 f32) it runs bounces d0 .. d0 +
// max_depth - 1 with `group` lanes per ray (1, 2, 4, 8, 16 or 32) and
// writes each lane's state; with `st_in` and `gid` (n_chunk int32 global
// lane ids) as well, it starts from that state instead of the primary rays
// (no codes in either case); without `st_out`, `group` must be 1.
// A sphere-only single pass (no planar rows, media or `st_out`) is
// sphere_kernel's: it reads the packed rows `srows` (n_spheres x 12 f32,
// 16-byte aligned) and claims lanes from `next` (one zeroed uint32), and it
// defers into `recs` (n_chunk x max_depth x 8 f32: ctb, abc.x; abc.y,
// abc.z, dcode's bits, 0) in place of ctb, abc and dcode; `resident` 1 or 0
// keeps the rows in shared memory or not, -1 leaves it to the row count.
// A single pass with media (no `st_out`) is media_kernel's: it reads
// `srows` too (when n_spheres > 0), claims lanes from `next` and defers
// into ctb, abc and dcode; so is a phased launch with media at `group` 1
// given `refill` 1 (with 0, render_kernel's; `refill` is 0 in every other
// launch); `resident` is -1 there and in every other launch.
// Returns the launch's CUDA error (0 on success); it does not sync.
int rtw_render_fused(const float* tab, int n_spheres, const float* ptab,
                     const float* ptest, int n_planar, const float* vtab,
                     int n_volumes, const float* par, long long lane_start,
                     int n_chunk, int width, int height, int spp,
                     int max_depth, int d0, int group, int refill,
                     float t_min,
                     unsigned int seed, int log10, float* rad, int* seg,
                     int* codes, float* ctb, float* abc, int* dcode,
                     const float* st_in, const int* gid, float* st_out,
                     const float* srows, int resident, unsigned int* next,
                     float* recs, void* stream) {
  if (n_chunk <= 0) return 0;
  if (n_spheres <= 0 && n_planar <= 0) return (int)cudaErrorInvalidValue;
  if (n_planar > 0 && (ptest == nullptr || ((uintptr_t)ptest & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const bool vol = n_volumes > 0;
  const bool phase = st_out != nullptr;
  const bool spheres = n_planar == 0 && !vol && !phase;
  if (spheres && (srows == nullptr || ((uintptr_t)srows & 15) != 0 ||
                  next == nullptr || resident < -1 || resident > 1 ||
                  ctb != nullptr || ((uintptr_t)recs & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (refill != 0 && (refill != 1 || !vol || !phase || group != 1))
    return (int)cudaErrorInvalidValue;
  const bool media = vol && (!phase || refill);
  if (media && (next == nullptr || recs != nullptr ||
                (n_spheres > 0 && (srows == nullptr ||
                                   ((uintptr_t)srows & 15) != 0))))
    return (int)cudaErrorInvalidValue;
  if (!spheres && resident != -1) return (int)cudaErrorInvalidValue;
  const bool defer = spheres ? recs != nullptr : ctb != nullptr;
  if (!spheres && defer && (abc == nullptr || dcode == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vol && vtab == nullptr) return (int)cudaErrorInvalidValue;
  if (phase && (codes != nullptr || (st_in == nullptr) != (gid == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!phase && (st_in != nullptr || d0 != 0 || group != 1))
    return (int)cudaErrorInvalidValue;
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 ||
      (long long)n_chunk * group >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  rtw::Launch L{lane_start, n_chunk, n_spheres, n_planar, width, height,
                spp, max_depth, t_min, seed};
  const rtw::Extra X{vtab, n_volumes,
                     log10 ? 0.43429448190325176f : 1.0f,
                     st_in, gid, st_out, d0, group};
  const rtw::Records rec{ctb, abc, dcode};
  const rtw::SphereOps P{reinterpret_cast<const float4*>(srows), resident,
                         next, reinterpret_cast<float4*>(recs)};
  return (int)rtw::dispatch(tab, ptab,
                            reinterpret_cast<const float4*>(ptest), par, L,
                            X, rad, seg, codes, rec, P, defer, vol, phase,
                            refill != 0, (cudaStream_t)stream, nullptr);
}

// Resident blocks per SM (into *blocks) of the launch without codes that
// the scene's families select (`defer` for a deferring scene, `phase` for
// a phased one), at its shared memory: for a sphere-only single pass, that
// of n_spheres packed rows when they fit kSphereRowLimit; for a media
// single pass, media_kernel's (no shared memory); for a phased launch,
// render_kernel's, whose resident threads set each phase's lanes a ray.
int rtw_render_occupancy(int n_spheres, int n_planar, int n_volumes,
                         int defer, int phase, int* blocks) {
  rtw::Launch L{};
  L.n_spheres = n_spheres;
  L.n_planar = n_planar;
  rtw::Extra X{};
  X.n_volumes = n_volumes;
  X.group = 1;
  const rtw::Records rec{};
  const rtw::SphereOps P{nullptr, -1, nullptr, nullptr};
  return (int)rtw::dispatch(nullptr, nullptr, nullptr, nullptr, L, X,
                            nullptr, nullptr, nullptr, rec, P, defer != 0,
                            n_volumes > 0, phase != 0, false, nullptr,
                            blocks);
}

// The planar prefilter plane_candidate on n (num, den, best) triples at
// t_min -> out (n int32, 1 = passes): a probe for its superset property,
// not on the render path.
int rtw_plane_candidate(const float* num, const float* den,
                        const float* best, int n, float t_min, int* out,
                        void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  rtw::candidate_kernel<<<(n + block - 1) / block, block, 0,
                          (cudaStream_t)stream>>>(num, den, best, n, t_min,
                                                  out);
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
