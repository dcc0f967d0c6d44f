// K1's bf16 path for Hopper (sm_90a): a tensor-core GEMM, wgmma fed by a
// TMA / mbarrier ring.
//
// Replaces src/repro/kernels/matmul_blocked.py::_kernel (launched by
// matmul_blocked), the Pallas TPU kernel, for bf16 inputs: C[M,N] =
// A[M,K] B[K,N] with A and B row-major, the products summed in fp32 and the
// result cast to bf16 once.  bf16 products are exact in fp32, so wgmma with
// an fp32 accumulator computes the reference's function; only the order of
// the sum differs.  fp32 inputs keep the CUDA-core kernel in
// matmul_blocked.cu.
//
// Bound: at Yi-6B's ffn_up shape (M 4096, K 4096, N 11008) the function
// does 369.4 GFLOP (0.373 ms at 989 TFLOP/s on the bf16 tensor cores) and
// moves 214 MB (0.064 ms at 3.35 TB/s), so operations bound it; only wgmma
// reaches that rate, and only if loads never stall it.
//
// Design, one block per BM x BN output tile (no persistent scheduling, no
// clusters, no split-K):
// - W = min(BM / 64, 4) consumer warpgroups each own BM / W rows (one or two
//   m64 slabs) of the tile and keep their fp32 accumulators in registers;
//   one producer warpgroup, of which one thread issues the loads.
// - A ring of S stages in shared memory, each one BM x bk tile of A and one
//   bk x BN tile of B, with a full and an empty mbarrier per stage.  The
//   producer waits for a stage to be empty, arms its full barrier with the
//   stage's byte count and issues cp.async.bulk.tensor (TMA) loads into it;
//   the consumers wait for it to be full, run wgmma on it and release the
//   stage before, once the wgmma group that read it has retired, so one
//   group stays in flight (with a ring of two, a stage that is late makes
//   a warpgroup retire and release the one before at once, a choice its
//   128 threads make together).  S is as many stages
//   as fit 227 KB, at most 8.
// - 128-byte swizzle: a TMA box is 64 bf16 (128 bytes) wide.  A is K-major:
//   a stage holds bk / 64 column chunks of [BM][64].  B [K,N] is row-major,
//   so it arrives N-major: bk x 64 boxes form BN / 64 chunks of [bk][64],
//   and wgmma reads it transposed (imm-trans-b = 1) instead of through a
//   transposing copy.  Descriptors: A's stride between 8-row groups is 1024
//   bytes, and a k16 step moves 32 bytes along the swizzled row; B's stride
//   between 8-deep K groups is 1024 bytes and between 64-wide N chunks
//   bk * 128 bytes, and a k16 step moves 2048 bytes.
// - Ragged edges: TMA fills loads past M, N or K with zeros, so the K tail
//   adds nothing; the epilogue masks its stores on M and N.  TMA needs
//   16-byte row strides, so the wrapper pads K or N to a multiple of 8 when
//   they are not (with zeros, which add nothing either).
// - Blocks run in groups of 8 M tiles, N tiles outer within a group, so the
//   blocks in flight reuse A and B through L2.
// - Every output is summed in one accumulator chain through the k16 steps
//   in order 0..K-1 in every tile, so all tiles and all bk agree bit for
//   bit.
// - setmaxnreg moves registers from the producer to the consumers: 40 / 232
//   with two consumer warpgroups, 24 / 112 with four.
//
// A wait that never completes (a fault in the ring) traps after ~2^34
// cycles instead of hanging the card.  The mbarrier, TMA, descriptor and
// wgmma helpers are hopper.cuh's, shared with K2.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"
#include "matmul_wgmma.h"

namespace k1 {

using namespace hopper;

template <int BM, int BN>
struct Shape {
  static constexpr int kW = BM / 64 < 4 ? BM / 64 : 4;      // consumer warpgroups
  static constexpr int kSlabs = BM / 64 / kW;               // m64 slabs per warpgroup
  static constexpr int kThreads = (kW + 1) * 128;
  static constexpr int kAcc = BN / 2;                       // accumulators per slab
  // setmaxnreg moves registers inside the block's own allocation: the
  // consumers may take no more than the producer gives up.  Two consumer
  // warpgroups launch at 168 (65536 / 384): 128 x (168 - 40) = 256 x
  // (232 - 168).  Four launch at 96 (65536 / 640): 128 x (96 - 24) covers
  // 512 x (112 - 96).
  static constexpr int kProducerRegs = kW == 4 ? 24 : 40;
  static constexpr int kConsumerRegs = kW == 4 ? 112 : 232;
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BN <= 256, "tile");
  static_assert(kSlabs * kAcc <= (kW == 4 ? 64 : 128), "accumulators per thread");
};

template <int BM, int BN>
__global__ void __launch_bounds__(Shape<BM, BN>::kThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, __nv_bfloat16* __restrict__ c,
                        int M, int N, int K, int bk, int stages) {
  using S = Shape<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_bytes = BM * bk * 2;
  const uint32_t stage_bytes = (BM + BN) * bk * 2;
  const uint32_t bars = base + stages * stage_bytes;     // full[stages], empty[stages]
  const int warpgroup = threadIdx.x / 128;
  const int ktiles = (K + bk - 1) / bk;
  // grouped order: consecutive blocks walk the N tiles of kGroupM M tiles
  // (M fastest), so the blocks in flight share a few A panels and a band of
  // B in L2 instead of every A panel and one B panel
  const int grid_m = (M + BM - 1) / BM, grid_n = (N + BN - 1) / BN;
  const int group = blockIdx.x / (kGroupM * grid_n), first_m = group * kGroupM;
  const int rows = min(grid_m - first_m, kGroupM);
  const int in_group = blockIdx.x % (kGroupM * grid_n);
  const int m0 = (first_m + in_group % rows) * BM, n0 = in_group / rows * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);                          // the producer's arrive
      mbar_init(bars + 8 * (stages + s), S::kW);           // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == S::kW) {
    // producer: one thread keeps the ring full
    if constexpr (S::kW > 1) setmaxnreg_dec<S::kProducerRegs>();
    if (threadIdx.x == S::kW * 128) {
      constexpr int a_box = BM < kBoxRows ? BM : kBoxRows;
      for (int kt = 0, s = 0, phase = 0; kt < ktiles; ++kt) {
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (stages + s), phase ^ 1);
        mbar_expect_tx(full, stage_bytes);
        const uint32_t sa = base + s * stage_bytes, sb = sa + a_bytes;
        const int k0 = kt * bk;
        for (int kc = 0; kc < bk / kBoxK; ++kc) {
#pragma unroll
          for (int h = 0; h < BM; h += a_box)               // A chunk kc: [BM][64]
            tma_load(sa + (kc * BM + h) * 128, &map_a, full, k0 + kc * kBoxK, m0 + h);
#pragma unroll
          for (int nc = 0; nc < BN / kBoxK; ++nc)           // B chunk nc: [bk][64]
            tma_load(sb + (nc * bk + kc * kBoxK) * 128, &map_b, full, n0 + nc * kBoxK,
                     k0 + kc * kBoxK);
        }
        if (++s == stages) { s = 0; phase ^= 1; }
      }
    }
  } else {
    // consumers: warpgroup w owns rows [w * BM / W, (w + 1) * BM / W)
    if constexpr (S::kW > 1) setmaxnreg_inc<S::kConsumerRegs>();
    float acc[S::kSlabs][S::kAcc];
#pragma unroll
    for (int r = 0; r < S::kSlabs; ++r) {
#pragma unroll
      for (int i = 0; i < S::kAcc; ++i) acc[r][i] = 0.0f;
      fence_operands(acc[r]);
    }
    const uint32_t row0 = warpgroup * S::kSlabs * 64 * 128;   // byte offset in a chunk of A
    const bool releaser = threadIdx.x % 128 == 0;
    int prev = 0;
    for (int kt = 0, s = 0, phase = 0; kt < ktiles; ++kt) {
      const uint32_t full = bars + 8 * s;
      // The stage before is released once its wgmma group retires, after
      // this stage's group is issued, so that one group stays in flight.
      // With a ring of two that leaves the producer no stage to fill ahead:
      // there, if this stage has not arrived yet, retire and release the one
      // before now, so that it is refilled during the wait.  wgmma.wait_group
      // must be run by the whole warpgroup alike, so the choice is one for
      // the warpgroup: the stage counts as arrived only if all 128 threads
      // saw it arrive (named barrier 1 + warpgroup; 0 is __syncthreads').
      bool released = kt == 0;
      if (!released && stages == 2 &&
          !warpgroup_all(mbar_test(full, phase), 1 + warpgroup)) {
        wgmma_wait<0>();
        if (releaser) mbar_arrive(bars + 8 * (stages + prev));
        released = true;
      }
      mbar_wait(full, phase);
      __syncwarp();                            // wgmma's .aligned wants the warp converged
      const uint32_t sa = base + s * stage_bytes, sb = sa + a_bytes;
      wgmma_fence();
      for (int kc = 0; kc < bk / kBoxK; ++kc) {
#pragma unroll
        for (int k4 = 0; k4 < kBoxK / 16; ++k4) {
          const uint64_t db =
              sw128_desc(sb + kc * kBoxK * 128 + k4 * 16 * 128, bk * 128, 1024);
#pragma unroll
          for (int r = 0; r < S::kSlabs; ++r) {
            const uint64_t da =
                sw128_desc(sa + kc * BM * 128 + row0 + r * 64 * 128 + k4 * 32, 16, 1024);
            wgmma_ss<1>(acc[r], da, db, 1);
          }
        }
      }
      wgmma_commit();
      if (!released) {
        wgmma_wait<1>();                       // the group of the stage before has retired
        if (releaser) mbar_arrive(bars + 8 * (stages + prev));
      }
      prev = s;
      if (++s == stages) { s = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < S::kSlabs; ++r) fence_operands(acc[r]);

    // accumulator layout of m64nNk16: thread (warp w, lane l) holds rows
    // 16 w + l / 4 and that + 8, columns 8 j + 2 (l % 4) and that + 1
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int col0 = n0 + 2 * (lane % 4);
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int r = 0; r < S::kSlabs; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + (warpgroup * S::kSlabs + r) * 64 + warp * 16 + lane / 4 +
                        half * 8;
        if (row >= M) continue;
        __nv_bfloat16* out = c + static_cast<int64_t>(row) * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = col0 + 8 * j;
          const float x0 = acc[r][4 * j + 2 * half], x1 = acc[r][4 * j + 2 * half + 1];
          if (pairs && col < N) {
            *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < N) out[col] = __float2bfloat16(x0);
            if (col + 1 < N) out[col + 1] = __float2bfloat16(x1);
          }
        }
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch_wgmma(const WgmmaArgs& p, cudaStream_t stream) {
  if (p.bk < kBoxK || p.bk % kBoxK != 0) return cudaErrorInvalidValue;
  const int stages = ring_stages(BM, BN, p.bk);
  if (stages < 2) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = encode_tensor_map(&map_a, p.a, p.K, p.M, kBoxK,
                                      BM < kBoxRows ? BM : kBoxRows);
  if (err != cudaSuccess) return err;
  err = encode_tensor_map(&map_b, p.b, p.ldb, p.K, kBoxK, kBoxK);
  if (err != cudaSuccess) return err;
  const int smem = ring_bytes(BM, BN, p.bk, stages);
  auto kernel = matmul_wgmma_kernel<BM, BN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.M + BM - 1) / BM * ((p.N + BN - 1) / BN);
  kernel<<<blocks, Shape<BM, BN>::kThreads, smem, stream>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(p.c), p.M, p.N, p.K, p.bk, stages);
  return cudaGetLastError();
}

}  // namespace k1
