// Flash-attention backward for Hopper (sm_90a): the C entry point of K2
// bwd, the gradient of K2, and its fp32 path on CUDA cores.
//
// Stands for the backward of src/repro/kernels/flash_attention.py's
// custom_vjp (_vjp_bwd), which recomputes the vector-Jacobian product
// through the jnp oracle (_ref_expand); the JAX package has no Pallas
// kernel for it.  Same function: given q [B,T,H,d], k and v [B,S,KV,d]
// (KV divides H), the forward's output o, its row log-sum-exp lse [B,H,T]
// (natural log of the scaled scores, fp32) and the output's gradient dO,
// it returns dq, dk and dv in the input dtype, for every mask K2 takes: a
// causal mask right-aligned by S - T, a sliding window whose first n_meta
// keys stay visible, and ragged T and S edges masked here.  With GQA, dk
// and dv sum over the H / KV query heads of a group.  A query row that
// sees no key at all (causal with T > S: rows t < T - S) takes the plain
// version's gradient, as _vjp_bwd does: the oracle's softmax over masked
// fills is uniform, so such a row gives dO / S to every key's dv and
// nothing to dq or dk.  (K2's forward, like the JAX package's Pallas
// kernel, writes such a row as a mean over the tiles its q tile visits
// or as zeros, not as the oracle's mean over every key: its gradient here
// is the oracle's, not that of the forward's output for those rows.)
//
// The C entry point dispatches by dtype, as flash_attention.cu does for the
// forward: bf16 runs the delta pre-pass below, then the tensor-core kernels
// of flash_bwd_wgmma.cuh (every product a wgmma fed by TMA); fp32 runs the
// CUDA-core kernels below, because the reference computes fp32 products
// exactly and TF32 on the tensor cores would miss the fp32 tolerance.
// Neither is a fallback for the other.
//
// Bound: at Yi-6B's train_4k flash case as training calls it (q
// [1,4096,32,128], k and v [1,4096,4,128] bf16, causal) the gradient needs
// 2.5 times the forward's products, 343.7 GFLOP over the live causal pairs
// (0.3475 ms at 989 TFLOP/s), against 151.5 MB of q, k, v, o, dO and lse
// read and dq, dk, dv written (0.045 ms at 3.35 TB/s): operations bound it.
// The fp32 path does them in fp32 FMAs on CUDA cores (67 TFLOP/s on the
// data sheet) and recomputes S and dP in both passes (7 products where the
// bound counts 5): a kernel that is right and deterministic first.
//
// fp32 design, three launches on the caller's stream, no atomics, so two
// runs agree bit for bit (the bf16 path keeps the first and replaces the
// other two):
// 1. delta_kernel: delta = rowsum(dO * O) in fp32, one warp per row.
// 2. dkdv_kernel: one block per (k tile of 32 keys, kv head, batch).  The K
//    and V tiles stay in shared memory; the block loops over the group's
//    query heads and over the q tiles of 64 rows that can see the k tile
//    (tiles that causality or the window mask whole are skipped), and
//    recomputes S = Q K^T, P = exp(S * scale - lse), dP = dO V^T and
//    dS = P * (dP - delta), accumulating dV += P^T dO and dK += dS^T Q in
//    registers; dK is scaled once at the end.
// 3. dq_kernel: one block per (q tile of 64 rows, head, batch), the heaviest
//    causal tiles first.  Q and dO stay in shared memory; the block loops
//    over the k tiles its rows can see, recomputes dS as above and
//    accumulates dQ += dS K in registers, scaled once at the end.
// Both kernels are declared one block an SM (__launch_bounds__(128, 1)):
// their tiles take 34-117 KB of shared memory, and without it ptxas held
// them to the register tiers of more blocks an SM (96, 128, 168) and
// spilled (the fp32 d = 32 and d = 64 dQ kernels).
// Tiles are staged in shared memory as fp32 with a padding column (no bank
// conflicts); a thread owns 4 x 4 elements of S and dP, and d / 8 columns
// of the accumulators (8 threads across d, which splits every compiled d)
// for 2 keys (dK, dV) or 4 rows (dQ): 64 fp32 accumulators a thread at
// d = 128 in both kernels.  The delta pre-pass runs at the real d in both
// dtypes.  The masked fill of K2's forward
// (-1e30) is not needed here: a masked pair gets P = 0 by selection, never
// by exp of a difference of fills, so a fully masked tile gives no NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_wgmma.h"

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 32;            // keys per tile
constexpr int NT = 128;           // threads per block
constexpr int AX = 8;             // S, dP: threads across the keys of a tile
constexpr int AY = NT / AX;       // 16 row groups
constexpr int AR = BQ / AY;       // 4 rows a thread
constexpr int AC = BK / AX;       // 4 keys a thread
constexpr int KX = 8;             // dK, dV: threads across d
constexpr int KY = NT / KX;       // 16 key groups
constexpr int KR = BK / KY;       // 2 keys a thread
constexpr int QX = 8;             // dQ: threads across d
constexpr int QY = NT / QX;       // 16 row groups
constexpr int QR = BQ / QY;       // 4 rows a thread

struct View {
  const void* p;
  int64_t sb, st, sh;             // (batch, row, head) strides in elements; d is contiguous
};

struct Params {
  View q, k, v, o, dout;
  const float* lse;               // [B, H, T]
  float* delta;                   // [B, H, T] scratch
  void* dq;                       // [B, T, H, d] contiguous
  void* dk;                       // [B, S, KV, d] contiguous
  void* dv;
  int B, T, S, H, KV;
  float scale;
  int window, n_meta, causal;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <typename T>
__device__ __forceinline__ const T* row_ptr(const View& x, int b, int t, int h) {
  return static_cast<const T*>(x.p) + b * x.sb + t * x.st + h * x.sh;
}

// whether every (row, key) pair of rows at key positions [pa, pb] and keys
// [k0, k0 + BK) is masked: K2's forward skips the same tiles
__device__ __forceinline__ bool tile_dead(int pa, int pb, int k0, const Params& p) {
  if (pb < pa) return true;                                   // no rows below T
  if (p.causal && k0 > pb) return true;                       // past the diagonal
  return p.window > 0 && k0 >= p.n_meta && pa - (k0 + BK - 1) >= p.window;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

// rows [r0, r0 + ROWS) of head h of x into dst [ROWS][D + 1] as fp32, zeros past limit
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const View& x, int b, int r0, int h,
                                          int limit) {
  const T* base = row_ptr<T>(x, b, 0, h);
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, c = e % D, t = r0 + r;
    dst[r * (D + 1) + c] = t < limit ? to_f(base[t * x.st + c]) : 0.f;
  }
}

// lse and delta of rows [q0, q0 + BQ) of head h, zeros past T
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const Params& p, int b,
                                          int h, int q0) {
  const int64_t base = (static_cast<int64_t>(b) * p.H + h) * p.T;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const int t = q0 + i;
    lse_s[i] = t < p.T ? p.lse[base + t] : 0.f;
    delta_s[i] = t < p.T ? p.delta[base + t] : 0.f;
  }
}

// P and dS of rows [q0, q0 + BQ) against keys [k0, k0 + BK) into Ps and dSs
// ([BQ][BK + 1]); P only where Ps is given
template <int D>
__device__ __forceinline__ void probs(const float* Qs, const float* dOs, const float* Ks,
                                      const float* Vs, const float* lse_s, const float* delta_s,
                                      float* Ps, float* dSs, int q0, int k0, const Params& p) {
  const int tx = threadIdx.x % AX, ty = threadIdx.x / AX;
  float s[AR][AC], dp[AR][AC];
#pragma unroll
  for (int r = 0; r < AR; ++r)
#pragma unroll
    for (int c = 0; c < AC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float qv[AR], gv[AR], kv[AC], vv[AC];
#pragma unroll
    for (int r = 0; r < AR; ++r) {
      qv[r] = Qs[(ty * AR + r) * (D + 1) + kk];
      gv[r] = dOs[(ty * AR + r) * (D + 1) + kk];
    }
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      kv[c] = Ks[(tx + AX * c) * (D + 1) + kk];
      vv[c] = Vs[(tx + AX * c) * (D + 1) + kk];
    }
#pragma unroll
    for (int r = 0; r < AR; ++r)
#pragma unroll
      for (int c = 0; c < AC; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(gv[r], vv[c], dp[r][c]);
      }
  }
  const int off = p.S - p.T;               // right alignment of queries to keys
#pragma unroll
  for (int r = 0; r < AR; ++r) {
    const int i = ty * AR + r, t = q0 + i, qpos = t + off;
#pragma unroll
    for (int c = 0; c < AC; ++c) {
      const int j = tx + AX * c, kpos = k0 + j;
      bool ok = t < p.T && kpos < p.S;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && (qpos - kpos < p.window || kpos < p.n_meta);
      const float pr = ok ? expf(s[r][c] * p.scale - lse_s[i]) : 0.f;
      if (Ps != nullptr) Ps[i * (BK + 1) + j] = pr;
      // selected, not 0 * (dP - delta): a blind row's delta may not be finite
      dSs[i * (BK + 1) + j] = ok ? pr * (dp[r][c] - delta_s[i]) : 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(Params p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;   // (b, h, t)
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(p.B) * p.H * p.T) return;    // whole warps leave together
  const int t = static_cast<int>(row % p.T), h = static_cast<int>((row / p.T) % p.H);
  const int b = static_cast<int>(row / (static_cast<int64_t>(p.T) * p.H));
  const T* o = row_ptr<T>(p.o, b, t, h);
  const T* g = row_ptr<T>(p.dout, b, t, h);
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) p.delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) dkdv_kernel(Params p) {
  constexpr int DC = D / KX;               // accumulator columns a thread
  static_assert(D % KX == 0, "the threads across d split it evenly");
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KV, k0 = kt * BK, off = p.S - p.T;
  extern __shared__ float smem[];
  float* Ks = smem;                        // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);           // [BK][D+1]
  float* Qs = Vs + BK * (D + 1);           // [BQ][D+1]
  float* dOs = Qs + BQ * (D + 1);          // [BQ][D+1]
  float* Ps = dOs + BQ * (D + 1);          // [BQ][BK+1]
  float* dSs = Ps + BQ * (BK + 1);         // [BQ][BK+1]
  float* lse_s = dSs + BQ * (BK + 1);      // [BQ]
  float* delta_s = lse_s + BQ;             // [BQ]

  load_tile<T, D, BK>(Ks, p.k, b, k0, kvh, p.S);
  load_tile<T, D, BK>(Vs, p.v, b, k0, kvh, p.S);

  const int kx = threadIdx.x % KX, ky = threadIdx.x / KX;
  float dk[KR][DC], dv[KR][DC];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = dv[r][c] = 0.f;

  const int n_qt = (p.T + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (tile_dead(q0 + off, min(q0 + BQ, p.T) - 1 + off, k0, p)) continue;   // block-uniform
      __syncthreads();                     // the previous q tile is consumed
      load_tile<T, D, BQ>(Qs, p.q, b, q0, h, p.T);
      load_tile<T, D, BQ>(dOs, p.dout, b, q0, h, p.T);
      load_rows(lse_s, delta_s, p, b, h, q0);
      __syncthreads();
      probs<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, p);
      __syncthreads();                     // P and dS are complete
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pv[KR], sv[KR], gv[DC], qv[DC];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          pv[r] = Ps[i * (BK + 1) + ky * KR + r];
          sv[r] = dSs[i * (BK + 1) + ky * KR + r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gv[c] = dOs[i * (D + 1) + kx + KX * c];
          qv[c] = Qs[i * (D + 1) + kx + KX * c];
        }
#pragma unroll
        for (int r = 0; r < KR; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[r][c] = fmaf(pv[r], gv[c], dv[r][c]);
            dk[r][c] = fmaf(sv[r], qv[c], dk[r][c]);
          }
      }
    }
  }

  // rows that see no key (causal, T > S) give every key dO / S, summed in
  // a fixed order over the group's heads and the rows t < T - S
  if (p.causal && off < 0) {
    const int blind = min(-off, p.T);
    float u[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) u[c] = 0.f;
    for (int g = 0; g < group; ++g)
      for (int t = 0; t < blind; ++t) {
        const T* row = row_ptr<T>(p.dout, b, t, kvh * group + g);
#pragma unroll
        for (int c = 0; c < DC; ++c) u[c] += to_f(row[kx + KX * c]);
      }
    const float inv_s = 1.f / static_cast<float>(p.S);
#pragma unroll
    for (int r = 0; r < KR; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) dv[r][c] = fmaf(u[c], inv_s, dv[r][c]);
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int key = k0 + ky * KR + r;
    if (key >= p.S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * p.S + key) * p.KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(&dk_out[row + kx + KX * c], dk[r][c] * p.scale);
      store(&dv_out[row + kx + KX * c], dv[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) dq_kernel(Params p) {
  constexpr int DC = D / QX;               // accumulator columns a thread
  static_assert(D % QX == 0, "the threads across d split it evenly");
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV), q0 = qt * BQ, off = p.S - p.T;
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D+1]
  float* dOs = Qs + BQ * (D + 1);          // [BQ][D+1]
  float* Ks = dOs + BQ * (D + 1);          // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);           // [BK][D+1]
  float* dSs = Vs + BK * (D + 1);          // [BQ][BK+1]
  float* lse_s = dSs + BQ * (BK + 1);      // [BQ]
  float* delta_s = lse_s + BQ;             // [BQ]

  load_tile<T, D, BQ>(Qs, p.q, b, q0, h, p.T);
  load_tile<T, D, BQ>(dOs, p.dout, b, q0, h, p.T);
  load_rows(lse_s, delta_s, p, b, h, q0);

  const int qx = threadIdx.x % QX, qy = threadIdx.x / QX;
  float dq[QR][DC];
#pragma unroll
  for (int r = 0; r < QR; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[r][c] = 0.f;

  const int pa = q0 + off, pb = min(q0 + BQ, p.T) - 1 + off;
  int k_end = (p.S + BK - 1) / BK;
  if (p.causal) k_end = pb < 0 ? 0 : min(k_end, pb / BK + 1);
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * BK;
    if (tile_dead(pa, pb, k0, p)) continue;                  // block-uniform
    __syncthreads();                       // the previous k tile is consumed
    load_tile<T, D, BK>(Ks, p.k, b, k0, kvh, p.S);
    load_tile<T, D, BK>(Vs, p.v, b, k0, kvh, p.S);
    __syncthreads();
    probs<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0, p);
    __syncthreads();                       // dS is complete
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[QR], kv[DC];
#pragma unroll
      for (int r = 0; r < QR; ++r) sv[r] = dSs[(qy * QR + r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * (D + 1) + qx + QX * c];
#pragma unroll
      for (int r = 0; r < QR; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[r][c] = fmaf(sv[r], kv[c], dq[r][c]);
    }
  }

  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    const int t = q0 + qy * QR + r;
    if (t >= p.T) continue;
    const int64_t row = ((static_cast<int64_t>(b) * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(&dq_out[row + qx + QX * c], dq[r][c] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch_delta(const Params& p, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.T;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, D>(p, stream);
  if (err != cudaSuccess) return err;
  // above 48 KB, dynamic shared memory needs the opt-in (idempotent, cheap)
  constexpr int smem_kv = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(dkdv_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<float, D><<<dim3((p.S + BK - 1) / BK, p.KV, p.B), NT, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem_q = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(dq_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<float, D><<<dim3((p.T + BQ - 1) / BQ, p.H, p.B), NT, smem_q, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, const k2bwd::BwdArgs& a, cudaStream_t stream) {
  const cudaError_t err = launch_delta<__nv_bfloat16, D>(p, stream);
  return err != cudaSuccess ? err : k2bwd::launch_bwd<D>(a, stream);
}

cudaError_t dispatch(int dtype, int d, const Params& p, const k2bwd::BwdArgs& a,
                     cudaStream_t stream) {
  if (dtype == 0) {
    switch (d) {
      case 32: return launch_fp32<32>(p, stream);
      case 64: return launch_fp32<64>(p, stream);
      case 96: return launch_fp32<96>(p, stream);
      case 120: return launch_fp32<120>(p, stream);
      case 128: return launch_fp32<128>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_bf16<32>(p, a, stream);
      case 64: return launch_bf16<64>(p, a, stream);
      case 96: return launch_bf16<96>(p, a, stream);
      case 120: return launch_bf16<120>(p, a, stream);
      case 128: return launch_bf16<128>(p, a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <int D>
int smem_fp32(int kernel) {
  return (kernel == 0 ? dkdv_smem_floats<D>() : dq_smem_floats<D>()) *
         static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" {

const char* flash_attention_bwd_error(int err) { return cudaGetErrorString((cudaError_t)err); }

// the dynamic shared memory a launch of kernel 0 (dK/dV) or 1 (dQ) requests
// at head dim d for a dtype (0 fp32, 1 bf16), or -1 where none is compiled
int flash_attention_bwd_smem(int dtype, int d, int kernel) {
  if (kernel != 0 && kernel != 1) return -1;
  if (dtype == 1 && (d == 32 || d == 64 || d == 96 || d == 120 || d == 128))
    return kernel == 0 ? k2bwd::dkdv_smem_bytes(d) : k2bwd::dq_smem_bytes(d);
  if (dtype != 0) return -1;
  switch (d) {
    case 32: return smem_fp32<32>(kernel);
    case 64: return smem_fp32<64>(kernel);
    case 96: return smem_fp32<96>(kernel);
    case 120: return smem_fp32<120>(kernel);
    case 128: return smem_fp32<128>(kernel);
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk and dv.
// q, o and dout are [B,T,H,d], k and v [B,S,KV,d], read through (batch,
// row, head) strides in elements with d contiguous; for bf16 those of q,
// k, v and dout are multiples of 8 and their bases 16-byte aligned (TMA).
// dq, dk and dv are written contiguous.  lse and delta are [B,H,T] fp32,
// delta scratch.  Returns the cudaError_t of the launches (0 on success); a
// head dim that is not compiled gives cudaErrorInvalidValue.
int flash_attention_bwd(
    int dtype, int d, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
    int B, int T, int S, int H, int KV,
    int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb, int64_t skt, int64_t skh,
    int64_t svb, int64_t svt, int64_t svh, int64_t sob, int64_t sot, int64_t soh,
    int64_t sgb, int64_t sgt, int64_t sgh,
    float scale, int window, int n_meta, int causal, void* stream) {
  const Params p{{q, sqb, sqt, sqh}, {k, skb, skt, skh}, {v, svb, svt, svh},
                 {o, sob, sot, soh}, {dout, sgb, sgt, sgh},
                 lse, delta, dq, dk, dv, B, T, S, H, KV, scale, window, n_meta, causal};
  const k2bwd::BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, B, T, S, H, KV,
                         {sqt, sqh, sqb}, {skt, skh, skb}, {svt, svh, svb}, {sgt, sgh, sgb},
                         scale, window, n_meta, causal};
  return dispatch(dtype, d, p, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
