// Blocked matrix product for Hopper (sm_90a), CUDA C++ on CUDA cores.
//
// Replaces src/repro/kernels/matmul_blocked.py::_kernel (launched by
// matmul_blocked), the Pallas TPU kernel.  Same function: C[M,N] = A[M,K] B[K,N]
// with the products summed in an fp32 accumulator and the result cast to A's
// dtype once, after the last K step.  fp32 and bf16 inputs.
//
// The tile is the quantity the kernel tuner (core/kerneltune.py) chooses, so
// it changes the launch: the kernel is a template over the output tile
// (BM, BN), and the reduction tile bk is a run-time argument that sizes the
// dynamic shared memory holding one A tile (BM x bk) and one B tile
// (bk x BN).  Every power of two 16..512 for BM and BN is instantiated where
// BM * BN <= 32768 (the register rule in matmul_blocked.py); the wrapper
// picks the smallest instantiation that covers the requested block.
//
// Design: one block of 256 threads per (BM x BN) output tile.  The TPU grid's
// sequential K axis becomes a loop inside the block.  Threads form a 16 x 16
// grid; thread (ty, tx) owns rows ty + 16 i (i < BM/16) and columns
// tx + 16 j (j < BN/16) of the tile, so its BM*BN/256 fp32 accumulators live
// in registers.  A and B tiles are staged in shared memory in their own
// dtype, row-major, with ragged M, N and K edges filled with zeros here (no
// padded copies).  Each thread sums its outputs over k in order 0..K-1 with
// fmaf, so every tile gives bit-identical results.  The fp32 path is IEEE
// fp32 throughout (no TF32).  __launch_bounds__(256, 1) lets nvcc give a
// thread up to 255 registers: without the 1, two fp32 tiles ((16, 512) and
// (256, 64)) spilled at 64 and 128 registers.
//
// Bound: at the Yi-6B ffn_up shape (M 4096, K 4096, N 11008, bf16) the
// function moves 214 MB (0.064 ms at 3.35 TB/s) and does 369.4 GFLOP
// (0.373 ms at 989 TFLOP/s bf16 on the tensor cores), so operations bound
// it.  This first version runs its products as fp32 FMAs on CUDA cores,
// whose 67 TFLOP/s data-sheet peak alone puts a floor of 5.5 ms under that
// work; its times are in PERF.md (chip_smoke.py).  mma.sync / wgmma on bf16
// tiles, TMA loads and a pipelined K loop are the later steps toward the
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int TG = 16;             // threads along each side of the 16 x 16 grid
constexpr int SMEM_DEFAULT = 48 * 1024;

struct Params {
  const void* a;
  const void* b;
  void* c;
  int M, N, K, bk;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(NT, 1) matmul_blocked_kernel(Params p) {
  constexpr int TM = BM / TG;      // rows per thread
  constexpr int TN = BN / TG;      // columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);          // [BM][bk]
  T* Bs = As + BM * p.bk;                          // [bk][BN]

  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  T* C = static_cast<T*>(p.c);
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
      As[e] = (gm < p.M && gk < p.K) ? A[(int64_t)gm * p.K + gk] : zero<T>();
      r += a_dr;
      c += a_dc;
      if (c >= bk) { c -= bk; ++r; }
    }
    // B tile: bk x BN, row-major, zeros past K and N
    for (int e = tid; e < bk * BN; e += NT) {
      const int rr = e / BN, cc = e % BN;
      const int gk = k0 + rr, gn = n0 + cc;
      Bs[e] = (gk < p.K && gn < p.N) ? B[(int64_t)gk * p.N + gn] : zero<T>();
    }
    __syncthreads();

    const int kend = min(bk, p.K - k0);
#pragma unroll 2
    for (int kk = 0; kk < kend; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = to_f(As[(ty + TG * i) * bk + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = to_f(Bs[kk * BN + tx + TG * j]);
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
      if (gn < p.N) store(&C[(int64_t)gm * p.N + gn], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(BM + BN) * p.bk * sizeof(T);
  auto kernel = matmul_blocked_kernel<T, BM, BN>;
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

template <typename T>
cudaError_t dispatch(int bm, int bn, const Params& p, cudaStream_t stream) {
#define MM_CASE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return launch<T, BM_, BN_>(p, stream);
  MM_TILES(MM_CASE)
#undef MM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// number of instantiated (BM, BN) tiles; fills out[2 i], out[2 i + 1]
int matmul_blocked_tiles(int* out, int cap) {
  int n = 0;
#define MM_LIST(BM_, BN_)          \
  if (n < cap) {                   \
    out[2 * n] = BM_;              \
    out[2 * n + 1] = BN_;          \
  }                                \
  ++n;
  MM_TILES(MM_LIST)
#undef MM_LIST
  return n;
}

// dtype: 0 fp32, 1 bf16.  a [M,K], b [K,N], c [M,N], all contiguous row-major.
// Returns a cudaError_t code (0 on success); an uninstantiated (bm, bn) gives
// cudaErrorInvalidValue.
int matmul_blocked(int dtype, int bm, int bn, int bk, const void* a,
                   const void* b, void* c, int M, int N, int K, void* stream) {
  if (bk < 1 || M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  Params p{a, b, c, M, N, K, bk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(bm, bn, p, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(bm, bn, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
