// K2 bwd's bf16 kernels with head dim 64.
#include "flash_bwd_wgmma.cuh"

namespace k2bwd {
template cudaError_t launch_bwd<64>(const BwdArgs&, cudaStream_t);
}  // namespace k2bwd
