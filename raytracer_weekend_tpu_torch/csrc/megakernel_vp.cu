// render_kernel's phased instantiations (K6b, with media and without),
// compiled apart from megakernel.cu and megakernel_media.cu so that the
// three build in parallel; the kernel is csrc/megakernel.cuh.
#include "megakernel.cuh"

namespace rtw {

RTW_VP_LAUNCHERS()

}  // namespace rtw
