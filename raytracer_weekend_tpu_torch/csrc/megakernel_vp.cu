// The fused forward kernel's instantiations with media (K5) and with phase
// I/O (K6b), compiled apart from megakernel.cu so that the two build in
// parallel; the kernel is csrc/megakernel.cuh.
#include "megakernel.cuh"

namespace rtw {

RTW_VP_LAUNCHERS()

}  // namespace rtw
