// The fused forward kernel's launches on media_kernel (K5, K5-emit, K6a's
// records on media scenes, and K6b's phased launches with media at one lane
// a ray), compiled apart from megakernel.cu and megakernel_vp.cu so that
// the three build in parallel; the kernel is csrc/megakernel.cuh.
#include "megakernel.cuh"

namespace rtw {

RTW_MEDIA_LAUNCHERS()

}  // namespace rtw
