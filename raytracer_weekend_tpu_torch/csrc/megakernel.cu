// The fused forward kernel's C entry and its instantiations without media
// or phases; the kernel itself is csrc/megakernel.cuh, the media and phased
// instantiations are in megakernel_vp.cu (compiled by a second nvcc).
#include "megakernel.cuh"

namespace rtw {

RTW_VP_LAUNCHERS(extern)

__global__ void rand4_kernel(const uint32_t* __restrict__ ids, int n,
                             uint32_t depth, uint32_t salt, uint32_t seed,
                             float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rand4(seed, ids[i], depth, salt);
}

template <bool kVol, bool kPhase>
void launch_modes(const float* tab, const float* ptab, const float* par,
                  const Launch& L, const Extra& X, float* rad, int* seg,
                  int* codes, const Records& rec, bool defer,
                  cudaStream_t st) {
  if constexpr (!kPhase) {  // phases never emit codes
    if (codes && defer) {
      launch_render<true, true, kVol, kPhase>(tab, ptab, par, L, X, rad, seg,
                                              codes, rec, st);
      return;
    }
    if (codes) {
      launch_render<true, false, kVol, kPhase>(tab, ptab, par, L, X, rad,
                                               seg, codes, rec, st);
      return;
    }
  }
  if (defer) {
    launch_render<false, true, kVol, kPhase>(tab, ptab, par, L, X, rad, seg,
                                             nullptr, rec, st);
  } else {
    launch_render<false, false, kVol, kPhase>(tab, ptab, par, L, X, rad, seg,
                                              nullptr, rec, st);
  }
}

}  // namespace rtw

extern "C" {

// Renders lanes [lane_start, lane_start + n_chunk) on `stream`: sphere
// table `tab` (N_ROWS x n_spheres), planar table `ptab` (N_PROWS x
// n_planar) and volume table `vtab` (n_volumes x N_VCOLS), any count 0
// (and its table unused) but not both surface counts. `log10` selects the
// reference's log10 scatter distance. With a non-null `codes` (n_chunk x
// max_depth int32) it also writes the winner codes. With non-null `ctb`,
// `abc` (n_chunk x max_depth x 3 f32) and `dcode` (n_chunk x max_depth
// int32) it defers noise and image texels and writes their records. With a
// non-null `st_out` (n_chunk x 15 f32) it runs bounces d0 .. d0 +
// max_depth - 1 and writes each lane's state; with `st_in` and `gid`
// (n_chunk int32 global lane ids) as well, it starts from that state instead
// of the primary rays (no codes in either case). Returns cudaGetLastError()
// after the launch (0 on success); it does not sync.
int rtw_render_fused(const float* tab, int n_spheres, const float* ptab,
                     int n_planar, const float* vtab, int n_volumes,
                     const float* par, long long lane_start, int n_chunk,
                     int width, int height, int spp, int max_depth, int d0,
                     float t_min, unsigned int seed, int log10, float* rad,
                     int* seg, int* codes, float* ctb, float* abc,
                     int* dcode, const float* st_in, const int* gid,
                     float* st_out, void* stream) {
  if (n_chunk <= 0) return 0;
  if (n_spheres <= 0 && n_planar <= 0) return (int)cudaErrorInvalidValue;
  const bool defer = ctb != nullptr;
  if (defer && (abc == nullptr || dcode == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vol = n_volumes > 0;
  const bool phase = st_out != nullptr;
  if (vol && vtab == nullptr) return (int)cudaErrorInvalidValue;
  if (phase && (codes != nullptr || (st_in == nullptr) != (gid == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!phase && (st_in != nullptr || d0 != 0))
    return (int)cudaErrorInvalidValue;
  rtw::Launch L{lane_start, n_chunk, n_spheres, n_planar, width, height,
                spp, max_depth, t_min, seed};
  const rtw::Extra X{vtab, n_volumes,
                     log10 ? 0.43429448190325176f : 1.0f,
                     st_in, gid, st_out, d0};
  const rtw::Records rec{ctb, abc, dcode};
  const cudaStream_t st = (cudaStream_t)stream;
  if (vol && phase) {
    rtw::launch_modes<true, true>(tab, ptab, par, L, X, rad, seg, codes, rec,
                                  defer, st);
  } else if (vol) {
    rtw::launch_modes<true, false>(tab, ptab, par, L, X, rad, seg, codes,
                                   rec, defer, st);
  } else if (phase) {
    rtw::launch_modes<false, true>(tab, ptab, par, L, X, rad, seg, codes,
                                   rec, defer, st);
  } else {
    rtw::launch_modes<false, false>(tab, ptab, par, L, X, rad, seg, codes,
                                    rec, defer, st);
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
