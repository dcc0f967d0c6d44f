// K2 bwd's bf16 kernels with head dim 120, on d = 128's layout (k2::padded_dim).
#include "flash_bwd_wgmma.cuh"

namespace k2bwd {
template cudaError_t launch_bwd<120>(const BwdArgs&, cudaStream_t);
}  // namespace k2bwd
