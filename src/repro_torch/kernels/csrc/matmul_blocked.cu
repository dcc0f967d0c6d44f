// Blocked matrix product for Hopper (sm_90a): the C entry point of K1, and
// its fp32 path on CUDA cores.
//
// Replaces src/repro/kernels/matmul_blocked.py::_kernel (launched by
// matmul_blocked), the Pallas TPU kernel.  Same function: C[M,N] = A[M,K] B[K,N]
// with the products summed in an fp32 accumulator and the result cast to A's
// dtype once, after the last K step.  The entry point dispatches by dtype:
// bf16 runs the tensor-core kernel of matmul_wgmma.cuh (wgmma fed by a
// TMA / mbarrier ring); fp32 runs the CUDA-core kernel below, because the
// reference computes fp32 products exactly and TF32 on the tensor cores
// would miss the fp32 tolerance.  Neither is a fallback for the other.
//
// The tile is the quantity the kernel tuner (core/kerneltune.py) chooses, so
// it changes the launch.  fp32: the kernel is a template over the output tile
// (BM, BN), and the reduction tile bk is a run-time argument that sizes the
// dynamic shared memory holding one A tile (BM x bk) and one B tile
// (bk x BN).  Every power of two 16..512 for BM and BN is instantiated where
// BM * BN <= 32768 (the register rule in matmul_blocked.py); the wrapper
// picks the smallest instantiation that covers the requested block.
//
// fp32 design: one block of 256 threads per (BM x BN) output tile.  The TPU
// grid's sequential K axis becomes a loop inside the block.  Threads form a
// 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i (i < BM/16) and columns
// tx + 16 j (j < BN/16) of the tile, so its BM*BN/256 fp32 accumulators live
// in registers.  A and B tiles are staged in shared memory row-major, with
// ragged M, N and K edges filled with zeros here (no padded copies).  Each
// thread sums its outputs over k in order 0..K-1 with fmaf, so every tile
// gives bit-identical results, in IEEE fp32 throughout (no TF32).
// __launch_bounds__(256, 1) lets nvcc give a thread up to 255 registers:
// without the 1, two tiles ((16, 512) and (256, 64)) spilled at 64 and 128
// registers.  Bound: fp32 FMAs on CUDA cores, 67 TFLOP/s on the data sheet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "matmul_wgmma.h"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int TG = 16;             // threads along each side of the 16 x 16 grid
constexpr int SMEM_DEFAULT = 48 * 1024;

struct Params {
  const float* a;
  const float* b;
  float* c;
  int M, N, K, bk;
};

template <int BM, int BN>
__global__ void __launch_bounds__(NT, 1) matmul_blocked_kernel(Params p) {
  constexpr int TM = BM / TG;      // rows per thread
  constexpr int TN = BN / TG;      // columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [BM][bk]
  float* Bs = As + BM * p.bk;                      // [bk][BN]

  const float* A = p.a;
  const float* B = p.b;
  float* C = p.c;
  const int tid = threadIdx.x;
  const int tx = tid % TG, ty = tid / TG;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bk = p.bk;

  // element e of the A tile sits at (e / bk, e % bk); e grows by NT a step,
  // so the row and column advance by fixed amounts and need no division
  const int a_dr = NT / bk, a_dc = NT % bk;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.K; k0 += bk) {
    // A tile: BM x bk, row-major, zeros past M and K
    int r = tid / bk, c = tid % bk;
    for (int e = tid; e < BM * bk; e += NT) {
      const int gm = m0 + r, gk = k0 + c;
      As[e] = (gm < p.M && gk < p.K) ? A[(int64_t)gm * p.K + gk] : 0.0f;
      r += a_dr;
      c += a_dc;
      if (c >= bk) { c -= bk; ++r; }
    }
    // B tile: bk x BN, row-major, zeros past K and N
    for (int e = tid; e < bk * BN; e += NT) {
      const int rr = e / BN, cc = e % BN;
      const int gk = k0 + rr, gn = n0 + cc;
      Bs[e] = (gk < p.K && gn < p.N) ? B[(int64_t)gk * p.N + gn] : 0.0f;
    }
    __syncthreads();

    const int kend = min(bk, p.K - k0);
#pragma unroll 2
    for (int kk = 0; kk < kend; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[(ty + TG * i) * bk + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * BN + tx + TG * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TG * i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TG * j;
      if (gn < p.N) C[(int64_t)gm * p.N + gn] = acc[i][j];
    }
  }
}

template <int BM, int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(BM + BN) * p.bk * sizeof(float);
  auto kernel = matmul_blocked_kernel<BM, BN>;
  if (smem > SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// every (BM, BN) pair of powers of two 16..512 with BM * BN <= 32768
#define MM_TILES(X)                                                          \
  X(16, 16) X(16, 32) X(16, 64) X(16, 128) X(16, 256) X(16, 512)             \
  X(32, 16) X(32, 32) X(32, 64) X(32, 128) X(32, 256) X(32, 512)             \
  X(64, 16) X(64, 32) X(64, 64) X(64, 128) X(64, 256) X(64, 512)             \
  X(128, 16) X(128, 32) X(128, 64) X(128, 128) X(128, 256)                   \
  X(256, 16) X(256, 32) X(256, 64) X(256, 128)                               \
  X(512, 16) X(512, 32) X(512, 64)

cudaError_t dispatch_fp32(int bm, int bn, const Params& p, cudaStream_t stream) {
#define MM_CASE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return launch<BM_, BN_>(p, stream);
  MM_TILES(MM_CASE)
#undef MM_CASE
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_bf16(int bm, int bn, const k1::WgmmaArgs& p, cudaStream_t stream) {
#define MM_CASE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return k1::launch_wgmma<BM_, BN_>(p, stream);
  K1_WGMMA_TILES(MM_CASE)
#undef MM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

namespace k1 {

cudaError_t encode_tensor_map(CUtensorMap* map, const void* base, uint64_t inner,
                              uint64_t outer, uint32_t box_inner, uint32_t box_outer) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};          // bytes between rows
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                        dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace k1

extern "C" {

// the compiled (BM, BN) tiles of a dtype (0 fp32, 1 bf16); fills out[2 i],
// out[2 i + 1] up to cap tiles and returns their number
int matmul_blocked_tiles(int dtype, int* out, int cap) {
  int n = 0;
#define MM_LIST(BM_, BN_)          \
  if (n < cap) {                   \
    out[2 * n] = BM_;              \
    out[2 * n + 1] = BN_;          \
  }                                \
  ++n;
  if (dtype == 0) { MM_TILES(MM_LIST) }
  if (dtype == 1) { K1_WGMMA_TILES(MM_LIST) }
#undef MM_LIST
  return n;
}

// the dynamic shared memory a launch of (bm, bn, bk) requests, or -1 where
// it cannot launch (bf16: fewer than two stages fit, or bk not a multiple of 64)
int matmul_blocked_smem(int dtype, int bm, int bn, int bk) {
  if (dtype == 0) return (bm + bn) * bk * (int)sizeof(float);
  if (bk < k1::kBoxK || bk % k1::kBoxK) return -1;
  const int stages = k1::ring_stages(bm, bn, bk);
  return stages < 2 ? -1 : k1::ring_bytes(bm, bn, bk, stages);
}

const char* matmul_blocked_error(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 fp32, 1 bf16.  a [M,K], b [K,ldb], c [M,N], all contiguous
// row-major; ldb == N for fp32, ldb >= N and ldb, K multiples of 8 for bf16.
// Returns a cudaError_t code (0 on success); an uncompiled (bm, bn) gives
// cudaErrorInvalidValue.
int matmul_blocked(int dtype, int bm, int bn, int bk, const void* a, const void* b,
                   void* c, int M, int N, int K, int ldb, void* stream) {
  if (bk < 1 || M < 1 || N < 1 || K < 1 || ldb < N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ldb != N) return (int)cudaErrorInvalidValue;
    Params p{static_cast<const float*>(a), static_cast<const float*>(b),
             static_cast<float*>(c), M, N, K, bk};
    return (int)dispatch_fp32(bm, bn, p, s);
  }
  if (dtype == 1) {
    if (K % 8 || ldb % 8) return (int)cudaErrorInvalidValue;
    k1::WgmmaArgs p{a, b, c, M, N, K, ldb, bk};
    return (int)dispatch_bf16(bm, bn, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
