// K1's bf16 tiles with BM = 128: two consumer warpgroups.
#include "matmul_wgmma.cuh"

namespace k1 {
template cudaError_t launch_wgmma<128, 64>(const WgmmaArgs&, cudaStream_t);
template cudaError_t launch_wgmma<128, 128>(const WgmmaArgs&, cudaStream_t);
template cudaError_t launch_wgmma<128, 256>(const WgmmaArgs&, cudaStream_t);
}  // namespace k1
