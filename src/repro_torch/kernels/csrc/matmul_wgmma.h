// K1's bf16 path: host-side declarations shared by the C entry point
// (matmul_blocked.cu) and the files that compile the kernel
// (matmul_wgmma_bm*.cu, one per group of tiles so that nvcc builds them in
// parallel).  The kernel itself is in matmul_wgmma.cuh.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k1 {

// Hopper's opt-in shared memory per block (227 KB)
constexpr int kSmemLimit = 232448;
// the ring: at most kMaxStages stages of one BM x bk A tile and one bk x BN
// B tile, a full and an empty mbarrier (8 bytes each) per stage, and up to
// 1024 bytes of padding to align the first stage to a 1024-byte swizzle atom
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 16;
constexpr int kAlignPad = 1024;
// bf16 values in one 128-byte swizzled row: the K extent of a TMA box of A
// and the N extent of a TMA box of B, and the unit bk comes in
constexpr int kBoxK = 64;
// a TMA box spans at most 256 elements in each dimension
constexpr int kBoxRows = 256;
// M tiles in a group of the block order (see matmul_wgmma.cuh)
constexpr int kGroupM = 8;

// every compiled (BM, BN): BM a multiple of 64 split over at most four
// consumer warpgroups, BN <= 256 (one wgmma), and at most 128 fp32
// accumulators a consumer thread (64 with four consumer warpgroups).  The
// same list is matmul_blocked.py's WGMMA_TILES.
#define K1_WGMMA_TILES(X)                                                    \
  X(64, 64) X(64, 128) X(64, 256)                                            \
  X(128, 64) X(128, 128) X(128, 256)                                         \
  X(256, 64) X(256, 128) X(512, 64)

struct WgmmaArgs {
  const void* a;   // [M, K] bf16, row-major, K % 8 == 0, 16-byte aligned
  const void* b;   // [K, ldb] bf16, row-major, ldb % 8 == 0, ldb >= N
  void* c;         // [M, N] bf16, row-major
  int M, N, K, ldb;
  int bk;          // K depth of one stage, a multiple of kBoxK
};

inline int stage_bytes(int bm, int bn, int bk) { return (bm + bn) * bk * 2; }

// the stages that fit the shared memory, capped at kMaxStages
inline int ring_stages(int bm, int bn, int bk) {
  const int s = (kSmemLimit - kAlignPad) / (stage_bytes(bm, bn, bk) + kBarrierBytes);
  return s < kMaxStages ? s : kMaxStages;
}

inline int ring_bytes(int bm, int bn, int bk, int stages) {
  return stages * (stage_bytes(bm, bn, bk) + kBarrierBytes) + kAlignPad;
}

// a 2-D bf16 tensor map over a row-major [outer, inner] array with 128-byte
// swizzle and zero fill out of bounds (defined in matmul_blocked.cu)
cudaError_t encode_tensor_map(CUtensorMap* map, const void* base, uint64_t inner,
                              uint64_t outer, uint32_t box_inner, uint32_t box_outer);

// launches the tile; instantiated in matmul_wgmma_bm*.cu
template <int BM, int BN>
cudaError_t launch_wgmma(const WgmmaArgs& p, cudaStream_t stream);

}  // namespace k1
