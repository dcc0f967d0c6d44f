// K2 bwd's bf16 path for Hopper (sm_90a): the flash-attention gradient on
// the tensor cores, every product a wgmma fed by TMA.
//
// Stands for the backward of src/repro/kernels/flash_attention.py's
// custom_vjp (_vjp_bwd, jax.vjp through the oracle; the JAX package has no
// Pallas kernel for it), for bf16 inputs.  Same function as the CUDA-core
// kernels of flash_attention_bwd.cu, which fp32 inputs keep: dq, dk and dv
// for K2's masks (causal right-aligned by S - T, a sliding window whose
// first n_meta keys stay visible, ragged T and S), GQA summed over the
// group's query heads, and the oracle's gradient for a row that sees no key
// (dv += dO / S to every key).  No atomics: two launches agree bit for bit.
//
// Bound: at Yi-6B's train_4k flash case as training calls it (q
// [1,4096,32,128], k and v [1,4096,4,128], causal) the gradient needs 343.7
// GFLOP over the live pairs (5 products: S, dP, dV, dK, dQ; 0.3475 ms at
// 989 TFLOP/s) against 151.5 MB (0.045 ms at 3.35 TB/s): operations bound
// it, and only wgmma reaches that rate.  This design recomputes S and dP in
// its dQ pass, 7 products where the bound counts 5, so the best it can
// reach is about 5/7 of the bound; removing that recompute through a
// reduction that stays deterministic is later work.
//
// Design: the pre-pass delta = rowsum(dO * O) (flash_attention_bwd.cu),
// then two kernels of 160 threads, one consumer warpgroup (warps 0-3) and
// one producer warp (warp 4) whose lane 0 issues the TMA loads.  Every tile
// is 64 rows of d bf16 values (kTile); a two-stage ring with a full and an
// empty mbarrier per stage, as flash_wgmma.cuh runs its ring; the tiles
// that tile_dead kills are never loaded, and producer and consumers skip
// exactly the same tiles, so the ring's phases never drift apart.
// - dkdv_wgmma_kernel: one block per (kv head, key tile, batch), the lowest
//   key tiles (the heaviest under causality) first.  K and V are loaded
//   once; (Q, dO) pairs stream through the ring for every query head of the
//   group and every q tile that can see the key tile.  The consumer
//   warpgroup owns the 64 keys:
//     S^T = K Q^T and dP^T = V dO^T: wgmma SS, K (V) the K-major A operand
//       like Q in the forward, Q (dO) the K-major B (imm-trans-b = 0) like K;
//     P^T = exp2(S^T * scale * log2 e - lse * log2 e), dS^T = P^T (dP^T -
//       delta), element masks only on cut tiles;
//     dV += P^T dO and dK += dS^T Q: wgmma RS, P^T and dS^T packed to bf16
//       from their accumulators (the m64nN accumulator is the m64nNk16 A
//       fragment, flash_wgmma.cuh), dO and Q the N-major B (imm-trans-b = 1)
//       like V in the forward.  The same swizzled Q and dO tiles serve as
//       K-major and as N-major B operands, through two descriptors.
//   The epilogue adds the blind-row term, scales dK once and stores bf16.
// - dq_wgmma_kernel: one block per (head, q tile, batch), the highest q
//   tiles (the heaviest under causality) first: the forward's kernel with a
//   second resident operand.  Q and dO are loaded once; K and V stream
//   through the ring.  S = Q K^T and dP = dO V^T (SS, K and V K-major B);
//   dS packed to bf16; dQ += dS K (RS, K the N-major B); dQ scaled once.
//
// Where the design had to take care:
// - Registers, not shared memory, set occupancy.  ptxas holds a kernel to
//   its launch bound whatever setmaxnreg asks, so a block is one consumer
//   warpgroup and a producer warp (160 threads, no setmaxnreg).  A dK/dV
//   thread holds dK and dV (d / 2 fp32 each: 128 at d = 128) and S^T and
//   dP^T (32 each): one block an SM, under 255 registers.  A dQ thread
//   holds dQ (d / 2), S and dP (32 each): 128 at d = 128, so the dQ kernel
//   asks for two blocks an SM (at most 204 registers a thread).
// - Shared memory: bf16 tiles take 6 x 64 x d x 2 bytes (96 KB at d = 128)
//   in either kernel, plus barriers, alignment padding and, in the dK/dV
//   kernel, the staged lse and delta (dkdv_smem_bytes, dq_smem_bytes): two
//   dQ blocks fit an SM's 227 KB.
// - Masked pairs are selected to 0 before the bf16 pack, never taken from
//   exp of a fill.  TMA zero-fills rows past T and keys past S, but their
//   lse and delta are not meaningful (read as 0 here), so the t < T and
//   key < S selections stay; a row that sees no key (causal, T > S) has an
//   lse of -inf or a fill, which the causal selection drops.
// - In S^T the queries are columns: a dK/dV thread needs lse and delta of
//   queries 8j + 2 (lane % 4) and that + 1.  The producer warp stages each
//   streamed q tile's lse (times log2 e) and delta in shared memory beside
//   the ring, before it arms the stage's full barrier, so the consumers
//   read them as float2 pairs.
// - TMA needs each base 16-byte aligned and each stride a multiple of 8
//   elements: the wrapper passes q, k, v and dO through tma_operand (dO
//   comes from autograd in any layout).  The tensor maps come from the one
//   inline encode_map of flash_wgmma.h, which K2 compiles too.
// - d = 96 and d = 120 run on d = 128's layout, as the forward does
//   (Shape::kD): the tensor maps keep the real d, TMA zero-fills the
//   columns past it, the padded columns of S^T, dP^T, S and dP add nothing,
//   and those of dK, dV and dQ stay zero and are not stored.  Registers and
//   shared memory are d = 128's (224 registers a dK/dV thread).  The
//   delta pre-pass reads O and dO at the real d.
// - The tile is fixed per head dim (64 x d for every tile), not tuned; the
//   library reports each kernel's shared memory per launch
//   (flash_attention_bwd_smem) and the Python rule must agree.
// - bf16 P and dS add rounding that the CUDA-core kernel did not have (it
//   kept them in fp32); dS is computed from fp32 P and dP, and every
//   product accumulates in fp32.
//
// What holds it back, left for later: one consumer warpgroup a block, whose
// masks and exponentials do not overlap its wgmma (no second warpgroup or
// ping-pong); the recompute of S and dP in the dQ pass; outputs stored from
// registers rather than by TMA.
//
// A wait that never completes (a fault in the ring) traps after ~2^34
// cycles instead of hanging the card.

#pragma once

#include <cuda_bf16.h>

#include "flash_bwd_wgmma.h"
#include "flash_wgmma.cuh"

namespace k2bwd {

using namespace hopper;
using k2::encode_map;
using k2::kLog2e;
using k2::pack_bf16;
using k2::tile_cut;
using k2::tile_dead;

constexpr int kConsumerWarps = 4;                 // one consumer warpgroup
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // and one producer warp

// D is the real head dim (tensor maps, the stores, the blind-row term); kD
// the width the tiles, products and accumulators are laid out at
// (k2::padded_dim: d = 96 and 120 on d = 128's layout, TMA zero-filling the
// columns past d, as in the forward)
template <int D>
struct Shape {
  static constexpr int kD = k2::padded_dim(D);
  static constexpr int kRow = (kD < 64 ? kD : 64) * 2;  // bytes of a swizzled row: 128 or 64
  static constexpr int kBoxD = kRow / 2;                // d values in a TMA box row
  static constexpr int kChunks = kD / kBoxD;            // boxes across d
  static constexpr int kSteps = kRow / 32;              // k16 steps in a swizzled row
  static constexpr uint64_t kLayout = kRow == 128 ? 1 : 2;
  static constexpr int kTileBytes = kTile * kD * 2;     // whole boxes, zero fill included
  static constexpr int kAcc = kD / 2;                   // accumulators of a 64 x d product
  static_assert(D == 32 || D == 64 || D == 96 || D == 120 || D == 128, "head dim");
  static_assert(D % 8 == 0, "the stores write whole 8-column groups");
};

struct Params {
  const float* lse;
  const float* delta;
  const __nv_bfloat16* dout;                     // for the blind-row term
  int64_t sgt, sgh, sgb;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int T, S, H, KV;
  float scale, scale2;                           // scale, scale * log2(e)
  int window, n_meta, causal;
};

// one 64 x d tile of each stage or resident pair, kChunks boxes of [64][kBoxD]
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row, int head, int b) {
  using Sh = Shape<D>;
#pragma unroll
  for (int c = 0; c < Sh::kChunks; ++c)
    tma_load_4d(dst + c * kTile * Sh::kRow, map, bar, c * Sh::kBoxD, row, head, b);
}

// acc[64 x 64] = A B^T over d, A and B two K-major tiles (imm-trans-b = 0)
template <int D>
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a, uint32_t b) {
  using Sh = Shape<D>;
#pragma unroll
  for (int kk = 0; kk < Sh::kD / 16; ++kk) {
    const uint32_t at = (kk / Sh::kSteps) * Sh::kRow * kTile + (kk % Sh::kSteps) * 32;
    wgmma_ss<0>(acc, smem_desc(a + at, 16, 8 * Sh::kRow, Sh::kLayout),
                smem_desc(b + at, 16, 8 * Sh::kRow, Sh::kLayout), kk > 0);
  }
}

// acc[64 x d] += A[64 x 64] B[64 x d], A from registers as four k16
// fragments, B a tile read N-major (imm-trans-b = 1): the leading offset
// steps 64-wide d chunks, the stride 8-row groups
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[Shape<D>::kAcc],
                                           const uint32_t (&a)[4][4], uint32_t b) {
  using Sh = Shape<D>;
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j)
    wgmma_rs<1>(acc, a[j],
                smem_desc(b + j * 16 * Sh::kRow, kTile * Sh::kRow, 8 * Sh::kRow, Sh::kLayout), 1);
}

// the A fragments of the four k16 steps of a 64 x 64 accumulator, as bf16
__device__ __forceinline__ void pack_fragments(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[j][i] = pack_bf16(x[8 * j + 2 * i], x[8 * j + 2 * i + 1]);
}

// whether the query at t (key position qpos) sees the key at kpos
__device__ __forceinline__ bool visible(int t, int qpos, int kpos, const Params& p) {
  bool ok = t < p.T && kpos < p.S;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && (qpos - kpos < p.window || kpos < p.n_meta);
  return ok;
}

__device__ __forceinline__ void init_barriers(uint32_t bars) {
  mbar_init(bars, 1);                                     // the resident pair
  for (int s = 0; s < kStages; ++s) {
    mbar_init(bars + 8 + 8 * s, 1);                       // the producer's arrive
    mbar_init(bars + 8 + 8 * (kStages + s), kConsumerWarps);   // one per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_g, const Params p) {
  using Sh = Shape<D>;
  constexpr int TB = Sh::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + TB;               // resident K and V
  const uint32_t ring = base + 2 * TB;                    // stage s: Q, then dO
  const uint32_t bars = ring + kStages * 2 * TB;          // resident, full[], empty[]
  // stage s's lse * log2(e) and delta of its 64 queries, after the barriers
  float* rows = reinterpret_cast<float*>(smem_raw + (bars + kBarrierBytes - smem_u32(smem_raw)));
  const int kvh = blockIdx.x, b = blockIdx.z;
  const int group = p.H / p.KV, k0 = blockIdx.y * kTile, off = p.S - p.T;
  const int n_qt = (p.T + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer warp: lane 0 loads K and V, then every lane stages lse and
    // delta of each live q tile and lane 0 loads its Q and dO
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * TB);
      load_tile<D>(sk, &map_k, bars, k0, kvh, b);
      load_tile<D>(sv, &map_v, bars, k0, kvh, b);
    }
    for (int g = 0, s = 0, phase = 0; g < group; ++g) {
      const int h = kvh * group + g;
      const int64_t row_base = (static_cast<int64_t>(b) * p.H + h) * p.T;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * kTile;
        if (tile_dead(q0 + off, min(q0 + kTile, p.T) - 1 + off, k0, kTile, p)) continue;
        const uint32_t full = bars + 8 + 8 * s;
        mbar_wait(bars + 8 + 8 * (kStages + s), phase ^ 1);
        float* ls = rows + s * 2 * kTile;
        for (int i = lane; i < kTile; i += 32) {
          const int t = q0 + i;
          ls[i] = t < p.T ? p.lse[row_base + t] * kLog2e : 0.0f;
          ls[kTile + i] = t < p.T ? p.delta[row_base + t] : 0.0f;
        }
        __syncwarp();                    // the stores before lane 0's arrive (release)
        if (lane == 0) {
          mbar_expect_tx(full, 2 * TB);
          const uint32_t sq = ring + s * 2 * TB;
          load_tile<D>(sq, &map_q, full, q0, h, b);
          load_tile<D>(sq + TB, &map_g, full, q0, h, b);
        }
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // the consumer warpgroup: accumulator layout of m64nN, thread (warp,
  // lane) holds keys 16 warp + lane / 4 and that + 8, columns 8 j + 2
  // (lane % 4) and that + 1
  const int rk = k0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float dk[Sh::kAcc], dv[Sh::kAcc];
#pragma unroll
  for (int i = 0; i < Sh::kAcc; ++i) dk[i] = dv[i] = 0.0f;
  fence_operands(dk);
  fence_operands(dv);

  mbar_wait(bars, 0);
  for (int g = 0, s = 0, phase = 0; g < group; ++g) {
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      const int pa = q0 + off, pb = min(q0 + kTile, p.T) - 1 + off;
      if (tile_dead(pa, pb, k0, kTile, p)) continue;
      mbar_wait(bars + 8 + 8 * s, phase);
      __syncwarp();                                  // wgmma's .aligned wants the warp converged
      const uint32_t sq = ring + s * 2 * TB, sg = sq + TB;
      float st[32], dpt[32];                         // S^T, dP^T: keys x queries
      wgmma_fence();
      product_ss<D>(st, sk, sq);
      product_ss<D>(dpt, sv, sg);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);

      const float* ls = rows + s * 2 * kTile;
      const bool cut = q0 + kTile > p.T || tile_cut(pa, pb, k0, kTile, p);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lse2 = *reinterpret_cast<const float2*>(ls + 8 * j + col0);
        const float2 dl = *reinterpret_cast<const float2*>(ls + kTile + 8 * j + col0);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hf + e;
            float pr = exp2f(fmaf(st[i], p.scale2, -(e ? lse2.y : lse2.x)));
            float ds = pr * (dpt[i] - (e ? dl.y : dl.x));
            if (cut) {
              const int t = q0 + 8 * j + col0 + e;
              const bool ok = visible(t, t + off, rk + 8 * hf, p);
              pr = ok ? pr : 0.0f;
              ds = ok ? ds : 0.0f;
            }
            st[i] = pr;
            dpt[i] = ds;
          }
        }
      }
      uint32_t pf[4][4], sf[4][4];
      pack_fragments(st, pf);
      pack_fragments(dpt, sf);
      wgmma_fence();
      product_rs<D>(dv, pf, sg);
      product_rs<D>(dk, sf, sq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv);
      fence_operands(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 + 8 * (kStages + s));   // the stage is free
      if (++s == kStages) { s = 0; phase ^= 1; }
    }
  }

  // rows that see no key (causal, T > S) give every key dO / S, summed in
  // a fixed order over the group's heads and the rows t < T - S (columns
  // below the real d: dO has no others)
  if (p.causal && off < 0) {
    const int blind = min(-off, p.T);
    const float inv_s = 1.0f / static_cast<float>(p.S);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float u = 0.0f;
        for (int g = 0; g < group; ++g)
          for (int t = 0; t < blind; ++t)
            u += __bfloat162float(p.dout[b * p.sgb + t * p.sgt + (kvh * group + g) * p.sgh +
                                         8 * j + col0 + e]);
        dv[4 * j + e] = fmaf(u, inv_s, dv[4 * j + e]);
        dv[4 * j + 2 + e] = fmaf(u, inv_s, dv[4 * j + 2 + e]);
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = rk + 8 * hf;
    if (key >= p.S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * p.S + key) * p.KV + kvh) * D + col0;
    // the columns below the real d only: past it dK and dV hold the padding's zeros
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + row + 8 * j) =
          __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + row + 8 * j) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_g, const Params p) {
  using Sh = Shape<D>;
  constexpr int TB = Sh::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sg = base + TB;               // resident Q and dO
  const uint32_t ring = base + 2 * TB;                    // stage s: K, then V
  const uint32_t bars = ring + kStages * 2 * TB;          // resident, full[], empty[]
  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile, off = p.S - p.T;
  const int pa = q0 + off, pb = min(q0 + kTile, p.T) - 1 + off;
  int n_tiles = (p.S + kTile - 1) / kTile;
  if (p.causal) n_tiles = pb < 0 ? 0 : min(n_tiles, pb / kTile + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) init_barriers(bars);
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: lane 0 loads Q and dO, then keeps the ring full of K and V
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * TB);
      load_tile<D>(sq, &map_q, bars, q0, h, b);
      load_tile<D>(sg, &map_g, bars, q0, h, b);
      for (int kt = 0, s = 0, phase = 0; kt < n_tiles; ++kt) {
        if (tile_dead(pa, pb, kt * kTile, kTile, p)) continue;
        const uint32_t full = bars + 8 + 8 * s;
        mbar_wait(bars + 8 + 8 * (kStages + s), phase ^ 1);
        mbar_expect_tx(full, 2 * TB);
        const uint32_t sk = ring + s * 2 * TB;
        load_tile<D>(sk, &map_k, full, kt * kTile, kvh, b);
        load_tile<D>(sk + TB, &map_v, full, kt * kTile, kvh, b);
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // the consumer warpgroup: thread (warp, lane) holds query rows
  // q0 + 16 warp + lane / 4 and that + 8, key columns 8 j + 2 (lane % 4)
  // and that + 1
  const int row0 = q0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = row0 + 8 * hf;
    const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.T + t;
    lse2[hf] = t < p.T ? p.lse[at] * kLog2e : 0.0f;
    dl[hf] = t < p.T ? p.delta[at] : 0.0f;
  }
  float dq[Sh::kAcc];
#pragma unroll
  for (int i = 0; i < Sh::kAcc; ++i) dq[i] = 0.0f;
  fence_operands(dq);

  mbar_wait(bars, 0);
  for (int kt = 0, s = 0, phase = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    if (tile_dead(pa, pb, k0, kTile, p)) continue;
    mbar_wait(bars + 8 + 8 * s, phase);
    __syncwarp();                                    // wgmma's .aligned wants the warp converged
    const uint32_t sk = ring + s * 2 * TB, sv = sk + TB;
    float st[32], dp[32];                            // S, dP: queries x keys
    wgmma_fence();
    product_ss<D>(st, sq, sk);
    product_ss<D>(dp, sg, sv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dp);

    const bool cut = q0 + kTile > p.T || tile_cut(pa, pb, k0, kTile, p);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          const float pr = exp2f(fmaf(st[i], p.scale2, -lse2[hf]));
          float ds = pr * (dp[i] - dl[hf]);
          if (cut) {
            const int t = row0 + 8 * hf;
            ds = visible(t, t + off, k0 + 8 * j + col0 + e, p) ? ds : 0.0f;
          }
          dp[i] = ds;
        }
      }
    }
    uint32_t sf[4][4];
    pack_fragments(dp, sf);
    wgmma_fence();
    product_rs<D>(dq, sf, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 + 8 * (kStages + s));   // the stage is free
    if (++s == kStages) { s = 0; phase ^= 1; }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = row0 + 8 * hf;
    if (t >= p.T) continue;
    const int64_t row = ((static_cast<int64_t>(b) * p.T + t) * p.H + h) * D + col0;
    // the columns below the real d only
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(p.dq + row + 8 * j) =
          __floats2bfloat162_rn(dq[i] * p.scale, dq[i + 1] * p.scale);
    }
  }
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using Sh = Shape<D>;
  CUtensorMap map_q, map_k, map_v, map_g;
  cudaError_t err = encode_map(&map_q, a.q, D, a.T, a.H, a.B, a.sq, Sh::kBoxD, kTile);
  if (err != cudaSuccess) return err;
  err = encode_map(&map_k, a.k, D, a.S, a.KV, a.B, a.sk, Sh::kBoxD, kTile);
  if (err != cudaSuccess) return err;
  err = encode_map(&map_v, a.v, D, a.S, a.KV, a.B, a.sv, Sh::kBoxD, kTile);
  if (err != cudaSuccess) return err;
  err = encode_map(&map_g, a.dout, D, a.T, a.H, a.B, a.sg, Sh::kBoxD, kTile);
  if (err != cudaSuccess) return err;
  const Params p{a.lse, a.delta, static_cast<const __nv_bfloat16*>(a.dout),
                 a.sg[0], a.sg[1], a.sg[2],
                 static_cast<__nv_bfloat16*>(a.dq), static_cast<__nv_bfloat16*>(a.dk),
                 static_cast<__nv_bfloat16*>(a.dv), a.T, a.S, a.H, a.KV,
                 a.scale, a.scale * kLog2e, a.window, a.n_meta, a.causal};
  // above 48 KB, dynamic shared memory needs the opt-in (idempotent, cheap)
  const int smem_kv = dkdv_smem_bytes(D);
  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(a.KV, (a.S + kTile - 1) / kTile, a.B);
  dkdv_wgmma_kernel<D><<<grid_kv, kThreads, smem_kv, stream>>>(map_q, map_k, map_v, map_g, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem_q = dq_smem_bytes(D);
  err = cudaFuncSetAttribute(dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(a.H, (a.T + kTile - 1) / kTile, a.B);
  dq_wgmma_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(map_q, map_k, map_v, map_g, p);
  return cudaGetLastError();
}

}  // namespace k2bwd
