// The fused forward kernel's single-pass media launches (media_kernel: K5,
// K5-emit, and K6a's records on media scenes), compiled apart from
// megakernel.cu and megakernel_vp.cu so that the three build in parallel;
// the kernel is csrc/megakernel.cuh.
#include "megakernel.cuh"

namespace rtw {

RTW_MEDIA_LAUNCHERS()

}  // namespace rtw
