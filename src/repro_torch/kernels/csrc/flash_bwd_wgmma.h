// K2 bwd's bf16 path: host-side declarations shared by the C entry point
// (flash_attention_bwd.cu) and the files that compile the kernels
// (flash_bwd_wgmma_d*.cu, one per head dim so that nvcc builds them in
// parallel).  The kernels themselves are in flash_bwd_wgmma.cuh.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.h"

namespace k2bwd {

// rows of every tile: the keys a dK/dV block owns and the query tiles it
// streams, the query rows a dQ block owns and the key tiles it streams
constexpr int kTile = 64;
// the streamed tiles go through a ring of two stages
constexpr int kStages = 2;
// the resident pair's full barrier, and a full and an empty barrier per
// stage (8 bytes each)
constexpr int kBarrierBytes = 8 + 16 * kStages;
// up to 1024 bytes of padding to align the tiles to a swizzle atom
constexpr int kAlignPad = 1024;
// the dK/dV kernel stages each streamed query tile's lse (log2 domain) and
// delta, kTile fp32 values each, beside the ring
constexpr int kRowBytes = kStages * 2 * kTile * 4;

struct BwdArgs {
  const void* q;      // [B, T, H, D] bf16
  const void* k;      // [B, S, KV, D] bf16
  const void* v;      // [B, S, KV, D] bf16
  const void* dout;   // [B, T, H, D] bf16
  const float* lse;   // [B, H, T] row log-sum-exp of the forward (natural log)
  const float* delta; // [B, H, T] rowsum(dO * O), from the pre-pass
  void* dq;           // [B, T, H, D] bf16, contiguous
  void* dk;           // [B, S, KV, D] bf16, contiguous
  void* dv;
  int B, T, S, H, KV;
  // strides in elements of (row, head, batch); d is contiguous, each stride
  // is a multiple of 8 and each base 16-byte aligned (TMA)
  int64_t sq[3], sk[3], sv[3], sg[3];
  float scale;
  int window, n_meta, causal;
};

// the dynamic shared memory of a launch of either kernel at head dim d: two
// resident tiles, a ring of two stages of two tiles (at the padded head dim
// of K2's forward, k2::padded_dim: d = 96 and 120 run on d = 128's layout),
// the barriers, the alignment padding, and for the dK/dV kernel the staged
// lse and delta
inline int dkdv_smem_bytes(int d) {
  return kAlignPad + (2 + 2 * kStages) * kTile * k2::padded_dim(d) * 2 + kBarrierBytes +
         kRowBytes;
}
inline int dq_smem_bytes(int d) {
  return kAlignPad + (2 + 2 * kStages) * kTile * k2::padded_dim(d) * 2 + kBarrierBytes;
}

// launches the dK/dV and the dQ kernel (delta must be written before);
// instantiated in flash_bwd_wgmma_d*.cu
template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream);

}  // namespace k2bwd
