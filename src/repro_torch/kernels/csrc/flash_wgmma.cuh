// K2's bf16 path for Hopper (sm_90a): the flash-attention forward on the
// tensor cores, wgmma fed by a TMA / mbarrier ring.
//
// Replaces src/repro/kernels/flash_attention.py::_kernel (launched by _fwd),
// the Pallas TPU kernel, for bf16 inputs.  Same function: softmax(q k^T *
// scale) v with an online softmax whose running max m, denominator l and
// accumulator acc stay in fp32; a causal mask right-aligned by S - T; an
// optional sliding window whose first n_meta keys stay visible; key tiles
// that every row masks are skipped; the finite -1e30 fill; output
// acc / max(l, 1e-30).  GQA maps query head h to kv head h / (H / KV).
// fp32 inputs keep the CUDA-core kernel of flash_attention.cu.
//
// Bound: at the serving shape (q [8,512,32,128], k/v [8,512,4,128], bf16,
// causal) the function moves 75.5 MB (q and o 33.5 MB each, k and v 4.2 MB
// each: 22.5 us at 3.35 TB/s) and does 17.2 GFLOP over the live causal
// pairs (17.4 us at 989 TFLOP/s), so bytes bound it, at an intensity of 228
// flop/byte against the card's ~295.  The design reads each q row and
// writes each o row once, reads k and v once per q tile (from L2 for the
// heads of one kv group), and never writes scores or probabilities to
// device memory.
//
// Design, one block per (q tile of BQ rows, head, batch), the heaviest
// causal q tiles launched first:
// - BQ / 64 consumer warpgroups, each owning 64 query rows, and one
//   producer warpgroup of which one thread issues the loads.  setmaxnreg
//   moves registers to the consumers where there are two (40 / 232, as K1),
//   but ptxas still holds the whole kernel to its launch bound, 168 a
//   thread at 384 threads: the tile rule counts accumulators against that.
// - Q is loaded once by TMA, K-major (d contiguous).  K and V tiles of BK
//   keys go through a ring of two stages, a full and an empty mbarrier per
//   stage, as matmul_wgmma.cuh runs its ring.  The producer skips the tiles
//   the block's rows all mask (past the causal diagonal, or out of every
//   row's window and past the meta prefix); neither costs a load.
// - S = Q K^T: wgmma SS, m64n{BK}k16, K the B operand and K-major
//   (imm-trans-b = 0), so its descriptor is that of Q: 8-row groups 8 rows
//   of the swizzled row apart, a k16 step 32 bytes along the row.
// - The masks and the online softmax run on S in registers: a row of the
//   m64nN accumulator lies across the 4 threads of a quad (two shuffles
//   for its max; the sum is kept per thread and added up at the end);
//   scale * log2(e) is folded into one multiply before exp2f; element masks
//   run only on tiles that a mask cuts (diagonal, ragged S, window edge).
//   A warpgroup skips a tile its own 64 rows all mask, so each row's
//   arithmetic is the same whatever BQ is: results are bit-identical
//   across BQ at a fixed BK.
// - O += P V: wgmma RS, P from registers as packed bf16 pairs.  The fp32
//   accumulator of m64nN holds (row g, columns 8j + 2c, +1) in d[4j], d[4j+1]
//   and (row g + 8, same columns) in d[4j+2], d[4j+3], which is the A
//   fragment of m64nNk16 (a0: g, 2c; a1: g + 8, 2c; a2: g, 8 + 2c; a3:
//   g + 8, 8 + 2c): the k16 step j takes d[8j .. 8j+7] in order.  V is the B
//   operand and N-major (d contiguous), K1's B stage: imm-trans-b = 1, the
//   leading offset steps 64-wide d chunks (BK * 128 bytes), the stride
//   8-key groups.
// - The O accumulator stays in registers, rescaled by alpha after each
//   wgmma.wait_group; the epilogue divides by l, converts to bf16 and
//   stores rows below T to global memory; where lse is asked for, it
//   writes (m + log2 l) * ln 2 of each row, the natural-log log-sum-exp
//   that the backward reads.
// - Swizzle: a TMA box row is at most 128 bytes (64 bf16): d = 128 is two
//   boxes per tile, d = 64 one; d = 32 is a 64-byte row, loaded with the
//   64-byte swizzle and read through descriptors of that layout.  TMA
//   zero-fills rows past T or S; the masks still drop keys past S.
// - d = 96 and d = 120 run on d = 128's layout (padded_dim, flash_wgmma.h):
//   the tensor maps keep the real d, so TMA zero-fills the second box's
//   columns past d (each box still counts whole against its mbarrier, as a
//   ragged row's does); the zero columns add nothing to S, O's columns past
//   d stay zero and the store writes only those below d.  The products cost
//   128/d of the real ones (4/3 at 96, 16/15 at 120); the bound counts the
//   real d.
//
// What holds it back, left for later: the two consumer warpgroups do not
// take turns (no ping-pong), the softmax of one tile does not overlap the
// QK^T of the next (each wgmma group is waited for at once), blocks are not
// persistent, and o is stored from registers rather than by TMA.
//
// A wait that never completes (a fault in the ring) traps after ~2^34
// cycles instead of hanging the card.

#pragma once

#include <cuda_bf16.h>

#include "flash_wgmma.h"
#include "hopper.cuh"

namespace k2 {

using namespace hopper;

constexpr float kNeg = -1e30f;                 // finite fill: (-inf) - (-inf) would be NaN
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// D is the real head dim (tensor maps, the store); kD the width the tiles,
// the products and the O accumulator are laid out at (padded_dim)
template <int BQ, int BK, int D>
struct Shape {
  static constexpr int kW = BQ / 64;                    // consumer warpgroups
  static constexpr int kThreads = (kW + 1) * 128;
  static constexpr int kD = padded_dim(D);
  static constexpr int kRow = (kD < 64 ? kD : 64) * 2;  // bytes of a swizzled row: 128 or 64
  static constexpr int kBoxD = kRow / 2;                // d values in a TMA box row
  static constexpr int kChunks = kD / kBoxD;            // boxes across d
  static constexpr int kSteps = kRow / 32;              // k16 steps in a swizzled row
  static constexpr uint64_t kLayout = kRow == 128 ? 1 : 2;
  static constexpr int kQBytes = BQ * kD * 2;           // whole boxes, zero fill included
  static constexpr int kTileBytes = BK * kD * 2;        // one K or one V tile
  static constexpr int kSAcc = BK / 2, kOAcc = kD / 2;  // accumulators a consumer thread holds
  // Two consumer warpgroups launch at 168 registers (65536 / 384); the
  // producer gives back 128 x (168 - 40) = the consumers' 256 x (232 - 168).
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BK % 64 == 0 && BK <= 256, "one wgmma for S");
  static_assert(D == 32 || D == 64 || D == 96 || D == 120 || D == 128, "head dim");
  static_assert(D % 8 == 0, "the store writes whole 8-column groups");
  static_assert(kSAcc + kOAcc <= (kW == 1 ? 160 : 128), "accumulators per thread");
};

struct Params {
  __nv_bfloat16* o;
  int T, S, H, KV;
  int64_t sot, soh, sob;
  float scale2;                                  // scale * log2(e)
  int window, n_meta, causal;
  float* lse;                                    // [B, H, T], or null
};

// whether every (row, key) pair of rows at key positions [pa, pb] and keys
// [k0, k0 + bk) is masked (the tile can be skipped); P is Params here and
// k2bwd::Params in K2 bwd (flash_bwd_wgmma.cuh), which skips the same tiles
template <class P>
__device__ __forceinline__ bool tile_dead(int pa, int pb, int k0, int bk, const P& p) {
  if (pb < pa) return true;                                   // no rows below T
  if (p.causal && k0 > pb) return true;                       // past the diagonal
  return p.window > 0 && k0 >= p.n_meta && pa - (k0 + bk - 1) >= p.window;
}

// whether some pair of the tile may be masked (it needs element masks)
template <class P>
__device__ __forceinline__ bool tile_cut(int pa, int pb, int k0, int bk, const P& p) {
  const int k1 = k0 + bk - 1;
  return k1 >= p.S || (p.causal && k1 > pa) ||
         (p.window > 0 && k1 >= p.n_meta && pb - k0 >= p.window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(Shape<BQ, BK, D>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const Params p) {
  using Sh = Shape<BQ, BK, D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                                // Q: kChunks x [BQ][kBoxD]
  const uint32_t ring = base + Sh::kQBytes;                // stage s: K, then V, kChunks x [BK][kBoxD]
  const uint32_t bars = ring + kStages * 2 * Sh::kTileBytes;
  const uint32_t q_full = bars;                            // then full[kStages], empty[kStages]
  const int iq = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = iq * BQ;
  const int off = p.S - p.T;                               // right alignment of queries to keys
  const int warpgroup = threadIdx.x / 128;
  // the block's rows below T, as key positions, and the key tiles they reach
  const int block_pa = q0 + off, block_pb = min(q0 + BQ, p.T) - 1 + off;
  int n_tiles = (p.S + BK - 1) / BK;
  if (p.causal) n_tiles = block_pb < 0 ? 0 : min(n_tiles, block_pb / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);                      // the producer's arrive
      mbar_init(bars + 8 + 8 * (kStages + s), Sh::kW);     // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == Sh::kW) {
    // producer: one thread loads Q, then keeps the ring full
    if constexpr (Sh::kW > 1) setmaxnreg_dec<Sh::kProducerRegs>();
    if (threadIdx.x == Sh::kW * 128) {
      mbar_expect_tx(q_full, Sh::kQBytes);
#pragma unroll
      for (int c = 0; c < Sh::kChunks; ++c)
        tma_load_4d(sq + c * BQ * Sh::kRow, &map_q, q_full, c * Sh::kBoxD, q0, h, b);
      for (int kt = 0, s = 0, phase = 0; kt < n_tiles; ++kt) {
        if (tile_dead(block_pa, block_pb, kt * BK, BK, p)) continue;
        const uint32_t full = bars + 8 + 8 * s;
        mbar_wait(bars + 8 + 8 * (kStages + s), phase ^ 1);
        mbar_expect_tx(full, 2 * Sh::kTileBytes);
        const uint32_t sk = ring + s * 2 * Sh::kTileBytes, sv = sk + Sh::kTileBytes;
#pragma unroll
        for (int c = 0; c < Sh::kChunks; ++c) {
          tma_load_4d(sk + c * BK * Sh::kRow, &map_k, full, c * Sh::kBoxD, kt * BK, kvh, b);
          tma_load_4d(sv + c * BK * Sh::kRow, &map_v, full, c * Sh::kBoxD, kt * BK, kvh, b);
        }
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows [q0 + 64 w, q0 + 64 w + 64)
  if constexpr (Sh::kW > 1) setmaxnreg_inc<Sh::kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int wq0 = q0 + 64 * warpgroup;
  const int pa = wq0 + off, pb = min(wq0 + 64, p.T) - 1 + off;
  // accumulator layout of m64nN: thread (warp, lane) holds rows
  // 16 warp + lane / 4 and that + 8, columns 8 j + 2 (lane % 4) and that + 1
  const int row0 = wq0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t qa = sq + warpgroup * 64 * Sh::kRow;
  float o[Sh::kOAcc];
#pragma unroll
  for (int i = 0; i < Sh::kOAcc; ++i) o[i] = 0.0f;
  fence_operands(o);
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};          // l: this thread's share of the row sum

  mbar_wait(q_full, 0);
  for (int kt = 0, s = 0, phase = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    if (tile_dead(block_pa, block_pb, k0, BK, p)) continue;
    mbar_wait(bars + 8 + 8 * s, phase);
    __syncwarp();                                  // wgmma's .aligned wants the warp converged
    if (!tile_dead(pa, pb, k0, BK, p)) {           // the same choice in all 128 threads
      const uint32_t sk = ring + s * 2 * Sh::kTileBytes, sv = sk + Sh::kTileBytes;
      float sacc[Sh::kSAcc];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Sh::kD / 16; ++kk) {
        const uint32_t at = (kk / Sh::kSteps) * Sh::kRow * 1u, step = (kk % Sh::kSteps) * 32;
        const uint64_t da = smem_desc(qa + at * BQ + step, 16, 8 * Sh::kRow, Sh::kLayout);
        const uint64_t db = smem_desc(sk + at * BK + step, 16, 8 * Sh::kRow, Sh::kLayout);
        wgmma_ss<0>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sacc);

      // masks and the online softmax, in the log2 domain
      const bool cut = tile_cut(pa, pb, k0, BK, p);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sacc[4 * j + 2 * hf + e] * p.scale2;
            if (cut) {
              const int kpos = k0 + 8 * j + col0 + e, qpos = row0 + 8 * hf + off;
              bool ok = kpos < p.S;
              if (p.causal) ok = ok && kpos <= qpos;
              if (p.window > 0) ok = ok && (qpos - kpos < p.window || kpos < p.n_meta);
              x = ok ? x : kNeg;
            }
            sacc[4 * j + 2 * hf + e] = x;
            mx[hf] = fmaxf(mx[hf], x);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m[hf], mx[hf]);
        alpha[hf] = exp2f(m[hf] - m_new);
        m[hf] = m_new;
        l[hf] *= alpha[hf];
      }
      // P as the A fragments of the k16 steps over this tile's keys
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hf = i % 2;
          const float p0 = exp2f(sacc[8 * j + 2 * i] - m[hf]);
          const float p1 = exp2f(sacc[8 * j + 2 * i + 1] - m[hf]);
          l[hf] += p0 + p1;
          pf[j][i] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int j = 0; j < Sh::kD / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i / 2];
      }

      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint64_t dv =
            smem_desc(sv + j * 16 * Sh::kRow, BK * Sh::kRow, 8 * Sh::kRow, Sh::kLayout);
        wgmma_rs<1>(o, pf[j], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
    }
    if (tid == 0) mbar_arrive(bars + 8 + 8 * (kStages + s));   // the stage is free
    if (++s == kStages) { s = 0; phase ^= 1; }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int row = row0 + 8 * hf;
    if (row >= p.T) continue;
    // the row's log-sum-exp, from the log2 domain to natural log once
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.T + row] = (m[hf] + log2f(l[hf])) * kLn2;
    const float inv = 1.0f / fmaxf(l[hf], 1e-30f);
    __nv_bfloat16* out = p.o + b * p.sob + row * p.sot + h * p.soh;
    // the columns below the real d only: past it O holds the padding's zeros
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    }
  }
}

template <int BQ, int BK, int D>
cudaError_t launch_flash(const FlashArgs& a, cudaStream_t stream) {
  using Sh = Shape<BQ, BK, D>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = encode_map(&map_q, a.q, D, a.T, a.H, a.B, a.sq, Sh::kBoxD, BQ);
  if (err != cudaSuccess) return err;
  err = encode_map(&map_k, a.k, D, a.S, a.KV, a.B, a.sk, Sh::kBoxD, BK);
  if (err != cudaSuccess) return err;
  err = encode_map(&map_v, a.v, D, a.S, a.KV, a.B, a.sv, Sh::kBoxD, BK);
  if (err != cudaSuccess) return err;
  const Params p{static_cast<__nv_bfloat16*>(a.o), a.T, a.S, a.H, a.KV, a.so[0], a.so[1],
                 a.so[2], a.scale * kLog2e, a.window, a.n_meta, a.causal, a.lse};
  const int smem = smem_bytes(BQ, BK, D);
  auto kernel = flash_wgmma_kernel<BQ, BK, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, Sh::kThreads, smem, stream>>>(map_q, map_k, map_v, p);
  return cudaGetLastError();
}

}  // namespace k2
