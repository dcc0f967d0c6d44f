// K2's bf16 path: host-side declarations shared by the C entry point
// (flash_attention.cu) and the files that compile the kernel
// (flash_wgmma_d*.cu, one per head dim so that nvcc builds them in
// parallel).  The kernel itself is in flash_wgmma.cuh.  K2 bwd's bf16
// kernels (flash_bwd_wgmma.cuh) take encode_map from here too.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace k2 {

// Hopper's opt-in shared memory per block (227 KB)
constexpr int kSmemLimit = 232448;
// K and V tiles go through a ring of two stages
constexpr int kStages = 2;
// Q's full barrier, and a full and an empty barrier per stage (8 bytes each)
constexpr int kBarrierBytes = 8 + 16 * kStages;
// up to 1024 bytes of padding to align Q and the ring to a swizzle atom
constexpr int kAlignPad = 1024;

// the head dim a tile is laid out at: d itself up to 64, else 128.  d = 96
// and d = 120 run on d = 128's layout (two 64-wide TMA boxes, the 128-byte
// swizzle): the tensor maps keep the real d, so TMA zero-fills the columns
// past it, which add nothing to Q K^T and give zero columns of O that the
// store skips.  120 is no multiple of 16 (the bf16 k-step), so it needs the
// padding; at 96 it costs 4/3 of the products (an exact-width layout is
// ROADMAP work).
constexpr int padded_dim(int d) { return d <= 64 ? d : 128; }

// every compiled (BQ, BK, D): BQ / 64 consumer warpgroups (one or two), BK a
// multiple of 64 up to 256 (one wgmma for S), D a head dim of HEAD_DIMS, and
// at most 160 fp32 accumulators a consumer thread (BK / 2 of S,
// padded_dim(D) / 2 of O) with one consumer warpgroup, 128 with two: ptxas
// fits the whole kernel under its launch bound, 255 registers a thread at
// 256 threads but 168 at 384 (setmaxnreg moves registers only at run time),
// and (128, 256, 64) spilled there.  The same list is flash_attention.py's
// WGMMA_TILES.
#define K2_TILES_D32(X) \
  X(64, 64, 32) X(64, 128, 32) X(64, 256, 32) X(128, 64, 32) X(128, 128, 32)
#define K2_TILES_D64(X) \
  X(64, 64, 64) X(64, 128, 64) X(64, 256, 64) X(128, 64, 64) X(128, 128, 64)
#define K2_TILES_D96(X) X(64, 64, 96) X(64, 128, 96) X(128, 64, 96) X(128, 128, 96)
#define K2_TILES_D120(X) X(64, 64, 120) X(64, 128, 120) X(128, 64, 120) X(128, 128, 120)
#define K2_TILES_D128(X) X(64, 64, 128) X(64, 128, 128) X(128, 64, 128) X(128, 128, 128)
#define K2_TILES(X) \
  K2_TILES_D32(X) K2_TILES_D64(X) K2_TILES_D96(X) K2_TILES_D120(X) K2_TILES_D128(X)

struct FlashArgs {
  const void* q;     // [B, T, H, D] bf16
  const void* k;     // [B, S, KV, D] bf16
  const void* v;     // [B, S, KV, D] bf16
  void* o;           // [B, T, H, D] bf16
  int B, T, S, H, KV;
  // strides in elements of (row, head, batch); d is contiguous.  For q, k
  // and v (TMA) each is a multiple of 8 and each base is 16-byte aligned.
  int64_t sq[3], sk[3], sv[3], so[3];
  float scale;
  int window, n_meta, causal;
  float* lse;        // [B, H, T] fp32 row log-sum-exp (natural log), or null
};

// the dynamic shared memory of a launch: Q, the ring of K and V tiles (at
// the padded head dim), the barriers and the alignment padding
inline int smem_bytes(int bq, int bk, int d) {
  const int dp = padded_dim(d);
  return kAlignPad + bq * dp * 2 + kStages * 2 * bk * dp * 2 + kBarrierBytes;
}

// a rank-4 bf16 tensor map over (d, rows, heads, batch) with the given
// element strides of the last three, boxes of box_d x box_rows x 1 x 1, the
// 128-byte swizzle where a box row is 128 bytes and the 64-byte one where it
// is 64, and zero fill out of bounds (rows past the end, and at d = 96 and
// 120 the columns past d of the second box).  Inline, so that K2 and K2 bwd (two
// libraries) compile the one definition.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
                              int batch, const int64_t (&strides)[3], int box_d,
                              int box_rows) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[0]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[2]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_d * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        bytes, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// launches the tile; instantiated in flash_wgmma_d*.cu
template <int BQ, int BK, int D>
cudaError_t launch_flash(const FlashArgs& p, cudaStream_t stream);

}  // namespace k2
