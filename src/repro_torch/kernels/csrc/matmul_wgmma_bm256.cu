// K1's bf16 tiles with BM = 256 and 512: four consumer warpgroups.
#include "matmul_wgmma.cuh"

namespace k1 {
template cudaError_t launch_wgmma<256, 64>(const WgmmaArgs&, cudaStream_t);
template cudaError_t launch_wgmma<256, 128>(const WgmmaArgs&, cudaStream_t);
template cudaError_t launch_wgmma<512, 64>(const WgmmaArgs&, cudaStream_t);
}  // namespace k1
