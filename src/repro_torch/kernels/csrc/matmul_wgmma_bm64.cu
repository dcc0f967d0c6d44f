// K1's bf16 tiles with BM = 64: one consumer warpgroup.
#include "matmul_wgmma.cuh"

namespace k1 {
template cudaError_t launch_wgmma<64, 64>(const WgmmaArgs&, cudaStream_t);
template cudaError_t launch_wgmma<64, 128>(const WgmmaArgs&, cudaStream_t);
template cudaError_t launch_wgmma<64, 256>(const WgmmaArgs&, cudaStream_t);
}  // namespace k1
