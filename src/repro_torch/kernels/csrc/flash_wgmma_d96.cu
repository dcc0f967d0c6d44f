// K2's bf16 tiles with head dim 96, on d = 128's layout (padded_dim).
#include "flash_wgmma.cuh"

namespace k2 {
#define K2_INSTANTIATE(BQ_, BK_, D_) \
  template cudaError_t launch_flash<BQ_, BK_, D_>(const FlashArgs&, cudaStream_t);
K2_TILES_D96(K2_INSTANTIATE)
#undef K2_INSTANTIATE
}  // namespace k2
