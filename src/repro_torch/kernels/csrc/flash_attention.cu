// Flash-attention forward for Hopper (sm_90a): the C entry point of K2, and
// its fp32 path on CUDA cores.
//
// Replaces src/repro/kernels/flash_attention.py::_kernel (launched by _fwd),
// the Pallas TPU kernel.  Same function: softmax(q k^T * scale) v with an
// online softmax whose running max m, denominator l and accumulator acc stay
// in fp32; a causal mask right-aligned by S - T; an optional sliding window
// whose first n_meta keys stay visible; fully masked key tiles skipped; the
// finite -1e30 fill; output acc / max(l, 1e-30).  GQA maps query head h to
// kv head h / (H / KV).  The entry point dispatches by dtype: bf16 runs the
// tensor-core kernel of flash_wgmma.cuh (wgmma fed by a TMA / mbarrier
// ring) at the (BQ, BK) tile the caller names; fp32 runs the CUDA-core
// kernel below, whose tile is fixed, because the reference computes fp32
// products exactly and TF32 on the tensor cores would miss the fp32
// tolerance.  Neither is a fallback for the other.
//
// With a non-null lse ([B,H,T] fp32) both paths also write each row's
// log-sum-exp of the scaled scores, in natural log, for the backward
// (flash_attention_bwd.cu); with a null one the output is what it was.
//
// fp32 layout: q and o are [B,T,H,d], k and v [B,S,KV,d], read through
// strides (the last dim must be contiguous), so no transposed or padded
// copies are made.  Ragged T and S edges are masked here.
//
// fp32 design: one block of 128 threads per (q tile of 64 rows, head,
// batch).  The TPU grid's sequential k axis becomes a loop inside the block;
// it stops after the last tile a causal row can see and skips tiles the
// window kills.  Q, K, V and P tiles of 64 x 32 are staged in shared memory
// as fp32; each thread owns 4 rows x 4 score columns and 4 rows x d/8
// accumulator columns in registers (every head dim, 96 and 120 included,
// is a multiple of the 8 threads across a row).  The products run in fp32
// FMAs on CUDA cores (67 TFLOP/s on the data sheet), and 2-byte or 4-byte
// elements are loaded one at a time: a kernel for correctness, not for speed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.h"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per tile
constexpr int NT = 128;           // threads per block
constexpr int TX = 8;             // threads across a row
constexpr int TY = NT / TX;       // 16 row groups
constexpr int RPT = BQ / TY;      // 4 rows per thread
constexpr int CPT = BK / TX;      // 4 score columns per thread
constexpr float NEG = -1e30f;     // finite fill: (-inf) - (-inf) would be NaN

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Tq, S, H, KVH;
  int64_t sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  float scale;
  int window, n_meta, causal;
  float* lse;                              // [B, H, T] row log-sum-exp, or null
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  constexpr int DPT = D / TX;     // accumulator columns per thread
  static_assert(D % TX == 0, "the threads of a row split d evenly");
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;
  T* o = static_cast<T*>(p.o) + b * p.sob + h * p.soh;

  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][D+1] (padded: no bank conflicts)
  float* Ks = Qs + BQ * (D + 1);           // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);           // [BK][D]
  float* Ps = Vs + BK * D;                 // [BQ][BK+1]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int q0 = iq * BQ;
  const int off = p.S - p.Tq;              // right alignment of queries to keys
  const int q_start = q0 + off;            // key position of the tile's first row

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, t = q0 + r;
    Qs[r * (D + 1) + c] = t < p.Tq ? to_f(q[t * p.sqt + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = (p.S + BK - 1) / BK;
  int k_end = n_tiles;
  if (p.causal) {
    const int q_last = min(q0 + BQ, p.Tq) - 1 + off;   // last row's key position
    k_end = q_last < 0 ? 0 : min(n_tiles, q_last / BK + 1);
  }

  for (int kt = 0; kt < k_end; ++kt) {
    const int k_start = kt * BK;
    if (p.window > 0) {                    // the whole tile is out of every row's window
      const bool alive = (q_start - (k_start + BK - 1)) < p.window;
      if (!alive && k_start >= p.n_meta) continue;
    }
    __syncthreads();                       // the previous tile is consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D, s = k_start + r;
      const bool ok = s < p.S;
      Ks[r * (D + 1) + c] = ok ? to_f(k[s * p.skt + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f(v[s * p.svt + c]) : 0.f;
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = Qs[(ty * RPT + r) * (D + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[(tx + TX * c) * (D + 1) + kk];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qpos = q_start + ty * RPT + r;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kpos = k_start + tx + TX * c;
        bool ok = kpos < p.S;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && ((qpos - kpos) < p.window || kpos < p.n_meta);
        sc[r][c] = ok ? sc[r][c] * p.scale : NEG;
        mx = fmaxf(mx, sc[r][c]);
      }
      // the TX threads of a row are adjacent lanes of one warp
#pragma unroll
      for (int w = 1; w < TX; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float pr = expf(sc[r][c] - m_new);
        sum += pr;
        Ps[(ty * RPT + r) * (BK + 1) + tx + TX * c] = pr;
      }
#pragma unroll
      for (int w = 1; w < TX; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[r][i] *= alpha;
    }
    __syncthreads();                       // P is complete

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pv[r] = Ps[(ty * RPT + r) * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const float vv = Vs[j * D + tx + TX * i];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r][i] = fmaf(pv[r], vv, acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = q0 + ty * RPT + r;
    if (t >= p.Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(&o[t * p.sot + tx + TX * i], acc[r][i] * inv);
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Tq + t] = m[r] + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  // above 48 KB, dynamic shared memory needs the opt-in (idempotent, cheap)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 120: return launch<T, 120>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(int bq, int bk, int d, const k2::FlashArgs& p, cudaStream_t stream) {
#define K2_CASE(BQ_, BK_, D_) \
  if (bq == BQ_ && bk == BK_ && d == D_) return k2::launch_flash<BQ_, BK_, D_>(p, stream);
  K2_TILES(K2_CASE)
#undef K2_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// the compiled (BQ, BK, d) tiles of a dtype (0 fp32, 1 bf16); fills
// out[3 i .. 3 i + 2] up to cap tiles and returns their number
int flash_attention_tiles(int dtype, int* out, int cap) {
  int n = 0;
#define K2_LIST(BQ_, BK_, D_)   \
  if (n < cap) {                \
    out[3 * n] = BQ_;           \
    out[3 * n + 1] = BK_;       \
    out[3 * n + 2] = D_;        \
  }                             \
  ++n;
  if (dtype == 0) {
    K2_LIST(BQ, BK, 32) K2_LIST(BQ, BK, 64) K2_LIST(BQ, BK, 96) K2_LIST(BQ, BK, 120)
    K2_LIST(BQ, BK, 128)
  }
  if (dtype == 1) { K2_TILES(K2_LIST) }
#undef K2_LIST
  return n;
}

// the dynamic shared memory a launch of the compiled tile (bq, bk, d)
// requests, or -1 where no such tile is compiled
int flash_attention_smem(int dtype, int bq, int bk, int d) {
  if (dtype == 0) {
    if (bq != BQ || bk != BK) return -1;
    switch (d) {
      case 32: return smem_floats<32>() * static_cast<int>(sizeof(float));
      case 64: return smem_floats<64>() * static_cast<int>(sizeof(float));
      case 96: return smem_floats<96>() * static_cast<int>(sizeof(float));
      case 120: return smem_floats<120>() * static_cast<int>(sizeof(float));
      case 128: return smem_floats<128>() * static_cast<int>(sizeof(float));
      default: return -1;
    }
  }
#define K2_SMEM(BQ_, BK_, D_) \
  if (bq == BQ_ && bk == BK_ && d == D_) return k2::smem_bytes(BQ_, BK_, D_);
  if (dtype == 1) { K2_TILES(K2_SMEM) }
#undef K2_SMEM
  return -1;
}

const char* flash_attention_error(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 = float32, 1 = bfloat16; (bq, bk) the compiled tile to launch
// (fp32: its one tile, 64 x 32).  Strides are in elements; for bf16 those
// of q, k and v are multiples of 8 and their bases 16-byte aligned (TMA).
// Returns the cudaError_t of the launch (0 on success); an uncompiled tile
// gives cudaErrorInvalidValue.  lse: [B,H,T] fp32 for the rows'
// log-sum-exp, or null.
int flash_attention_fwd(
    int dtype, int bq, int bk, int d, const void* q, const void* k, const void* v, void* o,
    int B, int Tq, int S, int H, int KVH,
    int64_t sqb, int64_t sqt, int64_t sqh,
    int64_t skb, int64_t skt, int64_t skh,
    int64_t svb, int64_t svt, int64_t svh,
    int64_t sob, int64_t sot, int64_t soh,
    float scale, int window, int n_meta, int causal, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const k2::FlashArgs p{q, k, v, o, B, Tq, S, H, KVH,
                          {sqt, sqh, sqb}, {skt, skh, skb}, {svt, svh, svb}, {sot, soh, sob},
                          scale, window, n_meta, causal, lse};
    return dispatch_bf16(bq, bk, d, p, s);
  }
  if (dtype != 0 || bq != BQ || bk != BK) return cudaErrorInvalidValue;
  Params p{q, k, v, o, B, Tq, S, H, KVH,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           scale, window, n_meta, causal, lse};
  return launch_dtype<float>(d, p, s);
}

}  // extern "C"
