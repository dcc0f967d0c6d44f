"""Flash-attention forward (K2): the hand-written CUDA kernels, their plain
version and the rule of which tiles they can run.

``flash_attention_cuda`` launches K2 (the port of
``repro/kernels/flash_attention.py::_kernel``) on CUDA tensors.  Its C entry
point (``csrc/flash_attention.cu``) dispatches by dtype: bf16 runs the
tensor-core kernel of ``csrc/flash_wgmma.cuh`` (``wgmma`` fed by a TMA /
``mbarrier`` ring), fp32 the CUDA-core kernel of ``flash_attention.cu``.
``flash_attention_plain`` computes the same function in plain torch, as the
JAX package's ``_ref_expand`` does: kv heads repeated so that query head h
reads kv head ``h // (H/KV)``, then the oracle.

The ``(block_q, block_k)`` tile is what the kernel tuner
(``core/kerneltune.py``) chooses.  Each block is clamped to its length, and
``plan`` picks the compiled tile that runs it; ``fits`` is the feasibility
rule that replaces the TPU kernel's ``vmem_bytes``.  A tile it refuses
raises ``ValueError`` and is never swapped for another.  The rule depends
on the dtype, and every function takes it as ``dtype_bytes``: 4 is fp32,
any other size the bf16 kernel.

* bf16, ``wgmma``: ``block_q`` runs on the smallest of 64 and 128 (one or
  two consumer warpgroups of 64 query rows) that covers it, ``block_k`` on
  the smallest of 64, 128 and 256 (the keys of one ``wgmma`` for S); a
  consumer thread holds ``bk / 2`` fp32 accumulators of S and ``d / 2`` of
  O, at most 160 with one consumer warpgroup and 128 with two, so
  ``bk = 256`` runs at ``bq = 64`` and ``d <= 64`` only.  The launch's
  shared memory is one Q tile, a ring of two stages of one K and one V
  tile, the barriers and the alignment padding, against 227 KB.  d = 96
  and d = 120 run on d = 128's layout (``padded_dim``): their accumulators
  and shared memory are d = 128's, and so are their tiles.
* fp32, CUDA cores: the kernel has one tile, 64 x 32, which runs every
  request; the blocks are checked and clamped but choose nothing.

The gradient is K2 bwd, a library of its own whose C entry point
(``csrc/flash_attention_bwd.cu``) dispatches by dtype: bf16 runs the
tensor-core kernels of ``csrc/flash_bwd_wgmma.cuh`` (every product a
``wgmma`` fed by TMA, 64-row tiles at every head dim), fp32 the CUDA-core
kernels of ``flash_attention_bwd.cu``.  ``flash_attention_bwd_cuda``
launches it on CUDA tensors from the forward's output and row
log-sum-exp, which the forward writes when asked (``return_lse``).
``flash_attention_bwd_plain`` is its plain version, the gradient of
``flash_attention_plain`` by ``torch.autograd``, recomputed, as the JAX
package's ``_vjp_bwd`` recomputes through its oracle.
``FlashAttention`` is the ``torch.autograd.Function`` that joins the two
(the JAX package's ``custom_vjp``); ``ops.flash_attention`` takes it when
an input needs a gradient.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_blocked import SMEM_LIMIT_BYTES
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 96, 120, 128)
LIBRARY = _build.Library("flash_attention", ("flash_attention.cu", *(
    f"flash_wgmma_d{d}.cu" for d in HEAD_DIMS)))
LIBRARY_BWD = _build.Library("flash_attention_bwd", ("flash_attention_bwd.cu", *(
    f"flash_bwd_wgmma_d{d}.cu" for d in HEAD_DIMS)))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bf16, the wgmma kernel (csrc/flash_wgmma.cuh): a consumer warpgroup owns
# 64 query rows; one or two of them (a third would leave a thread 128
# registers, too few for 64 O and 64 S accumulators at d = 128).  S of a
# k tile is one wgmma, at most 256 wide.  ptxas fits the whole kernel under
# its launch bound, 255 registers a thread with one consumer warpgroup and
# 168 with two (setmaxnreg moves registers only at run time): the
# accumulators may take 160 and 128 of them (the chip's build: (128, 256)
# at d = 64 spilled 292 bytes at 168, (64, 256) used 248 without a spill).
WGMMA_M = 64
BQ_SIDES = (64, 128)
BK_SIDES = (64, 128, 256)
MAX_ACC_PER_THREAD = {1: 160, 2: 128}      # by consumer warpgroups
STAGES = 2                  # the K/V ring
BARRIER_BYTES = 8 + 16 * STAGES     # Q's full barrier; a full and an empty one per stage
ALIGN_PAD = 1024            # aligning Q and the ring to a 1024-byte swizzle atom
TMA_ALIGN = 8               # bf16 values in 16 bytes: TMA's stride unit

# fp32, the CUDA-core kernel (csrc/flash_attention.cu): one tile
FP32_TILE = (64, 32)

# K2 bwd: its two kernels, dK/dV and dQ, by the index its C entry point
# takes.  bf16 (csrc/flash_bwd_wgmma.h): every tile 64 rows of d, two
# resident and a ring of two stages of two, and the dK/dV kernel stages
# each streamed q tile's lse and delta (fp32) beside the ring.  fp32
# (csrc/flash_attention_bwd.cu): (64 query rows, 32 keys), fp32 tiles with
# a padding column.
BWD_KERNELS = ("dkdv", "dq")
BWD_TILE = 64
BWD_FP32_TILE = (64, 32)


def _fp32(dtype_bytes) -> bool:
    return dtype_bytes == 4


def padded_dim(d):
    """The head dim the bf16 kernels lay a tile out at (``padded_dim`` of
    csrc/flash_wgmma.h): d itself up to 64, else 128.  d = 96 and 120 run on
    d = 128's layout, TMA zero-filling the columns past d, so their
    accumulators and shared memory are d = 128's.  Broadcasts."""
    return np.where(np.asarray(d) <= 64, d, 128)


def _compiled(bq, bk, d, dtype_bytes):
    """Whether the tile (bq, bk) at head dim d is compiled (broadcasts)."""
    bq, bk = np.asarray(bq, np.float64), np.asarray(bk, np.float64)
    dims = np.isin(np.asarray(d), HEAD_DIMS)
    if _fp32(dtype_bytes):
        return (bq == FP32_TILE[0]) & (bk == FP32_TILE[1]) & dims
    limit = np.where(bq > WGMMA_M, MAX_ACC_PER_THREAD[2], MAX_ACC_PER_THREAD[1])
    return np.isin(bq, BQ_SIDES) & np.isin(bk, BK_SIDES) & dims \
        & (bk / 2 + padded_dim(d) / 2 <= limit)


# every compiled (BQ, BK, d) by dtype_bytes: the lists csrc/flash_wgmma.h
# and csrc/flash_attention.cu instantiate
WGMMA_TILES = tuple((bq, bk, d) for d in HEAD_DIMS for bq in BQ_SIDES
                    for bk in BK_SIDES if _compiled(bq, bk, d, 2))
INSTANTIATED = {2: WGMMA_TILES, 4: tuple((*FP32_TILE, d) for d in HEAD_DIMS)}

# kernel launches since the last reset, of the forward and of the backward;
# a run sets them to 0 and reads them back to show that its attention went
# through the kernels
launches = 0
bwd_launches = 0


def launch_tile(bq, bk, dtype_bytes: int = 2):
    """The compiled ``(BQ, BK)`` that runs blocks ``(bq, bk)``: for bf16 each
    side the smallest power of two >= its block, at least 64; for fp32 the
    one tile.  Broadcasts over numpy arrays."""
    if _fp32(dtype_bytes):
        sides = [np.full(np.shape(x), float(s)) for s, x in zip(FP32_TILE, (bq, bk))]
    else:
        sides = [np.maximum(float(WGMMA_M), 2.0 ** np.ceil(np.log2(
            np.maximum(np.asarray(x, np.float64), 1.0)))) for x in (bq, bk)]
    return tuple(x if x.ndim else float(x) for x in sides)


def smem_bytes(bq, bk, d, dtype_bytes: int = 2):
    """Dynamic shared memory of a launch of the compiled tile (bq, bk) at
    head dim d.  bf16: Q, two stages of one K and one V tile (at the padded
    head dim), the barriers and the alignment padding.  fp32: the Q, K, V
    and P tiles in fp32 with their padding columns.  Broadcasts over numpy
    arrays."""
    bq, bk, d = np.asarray(bq), np.asarray(bk), np.asarray(d)
    if _fp32(dtype_bytes):
        return (bq * (d + 1) + bk * (d + 1) + bk * d + bq * (bk + 1)) * 4
    dp = padded_dim(d)
    return ALIGN_PAD + bq * dp * 2 + STAGES * 2 * bk * dp * 2 + BARRIER_BYTES


def bwd_smem_bytes(d, kernel: str, dtype_bytes: int = 2):
    """Dynamic shared memory of a launch of K2 bwd's ``kernel`` ("dkdv" or
    "dq") at head dim d; broadcasts over d.  bf16: ``ALIGN_PAD + (2 + 2 *
    STAGES) * 64 * padded_dim(d) * 2 + BARRIER_BYTES``, plus ``STAGES * 2 *
    64 * 4`` bytes of staged lse and delta in the dK/dV kernel."""
    d = np.asarray(d)
    if _fp32(dtype_bytes):
        bq, bk = BWD_FP32_TILE
        tiles = 2 * bk * (d + 1) + 2 * bq * (d + 1) + 2 * bq
        return (tiles + (2 if kernel == "dkdv" else 1) * bq * (bk + 1)) * 4
    smem = ALIGN_PAD + (2 + 2 * STAGES) * BWD_TILE * padded_dim(d) * 2 + BARRIER_BYTES
    return smem + (STAGES * 2 * BWD_TILE * 4 if kernel == "dkdv" else 0)


def fits(bq, bk, d, dtype_bytes: int = 2):
    """The feasibility rule, broadcast over block arrays: the covering tile
    is compiled at head dim d and its launch's shared memory fits."""
    sq, sk = launch_tile(bq, bk, dtype_bytes)
    ok = _compiled(sq, sk, d, dtype_bytes) \
        & (np.asarray(bq, np.float64) >= 1) & (np.asarray(bk, np.float64) >= 1) \
        & (smem_bytes(sq, sk, d, dtype_bytes) <= SMEM_LIMIT_BYTES)
    return ok if np.ndim(ok) else bool(ok)


@functools.lru_cache(maxsize=4096)
def plan(t: int, s: int, d: int, *, block_q: int = 128, block_k: int = 128,
         causal: bool = True, dtype_bytes: int = 2) -> tuple[int, int]:
    """The tile a request launches.  The blocks keep the JAX wrapper's
    contract: each is clamped to ``min(block, T|S)``, and non-causal
    attention whose keys do not fill the last block raises.  Then the
    covering compiled tile; ``ValueError`` on a tile the rule refuses."""
    bq, bk = min(block_q, t), min(block_k, s)
    if min(block_q, block_k) < 1:
        raise ValueError(f"blocks must be positive, got ({block_q}, {block_k})")
    if s % bk and not causal:
        raise ValueError("non-causal attention with keys that do not fill the "
                         f"last block (S={s}, block_k={bk}) needs a length mask")
    if not fits(bq, bk, d, dtype_bytes):
        sq, sk = (int(x) for x in launch_tile(bq, bk, dtype_bytes))
        raise ValueError(
            f"tile ({bq}, {bk}) is not feasible for flash attention at head "
            f"dim {d}: compiled tile ({sq}, {sk}) needs block_q <= "
            f"{max(BQ_SIDES)}, block_k <= {max(BK_SIDES)}, head dim in "
            f"{HEAD_DIMS}, at most {MAX_ACC_PER_THREAD[1]} accumulators a "
            f"consumer thread (bk/2 + d/2; {MAX_ACC_PER_THREAD[2]} at block_q "
            f"128) and "
            f"{int(smem_bytes(sq, sk, d, dtype_bytes))} bytes of shared memory "
            f"against {SMEM_LIMIT_BYTES}")
    return tuple(int(x) for x in launch_tile(bq, bk, dtype_bytes))


def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([i32] * 4 + [ptr] * 4 + [i32] * 5 + [i64] * 12
                       + [ctypes.c_float, i32, i32, i32, ptr, ptr])
        fn.restype = i32
        lib.flash_attention_tiles.argtypes = [i32, ctypes.POINTER(i32), i32]
        lib.flash_attention_tiles.restype = i32
        lib.flash_attention_smem.argtypes = [i32] * 4
        lib.flash_attention_smem.restype = i32
        lib.flash_attention_error.argtypes = [i32]
        lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def compiled_tiles(dtype_bytes: int = 2) -> list[tuple[int, int, int]]:
    """The (BQ, BK, d) tiles the built library compiles for a dtype (loads it)."""
    buf = (ctypes.c_int * (3 * 64))()
    n = _lib().flash_attention_tiles(0 if _fp32(dtype_bytes) else 1, buf, 64)
    return [tuple(buf[3 * i:3 * i + 3]) for i in range(min(n, 64))]


def launch_smem(bq: int, bk: int, d: int, dtype_bytes: int = 2) -> int:
    """The shared memory the built library requests for a launch of the
    compiled tile (bq, bk) at head dim d, -1 where none is compiled (loads it)."""
    return _lib().flash_attention_smem(0 if _fp32(dtype_bytes) else 1, bq, bk, d)


def _check(q, k, v, device_type: str = "cuda"):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != device_type:
            raise ValueError(f"the {device_type} route needs {device_type} tensors; "
                             f"{name} is on {x.device}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} has dtype {x.dtype}; the kernel takes "
                             f"{sorted(str(d) for d in _DTYPE_CODES)}")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match [B,T,H,d] / [B,S,KV,d]")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if h % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide query heads {h}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")


def _strides(x) -> list[int]:
    """(batch, row, head) strides in elements; a dimension of size 1 gets the
    contiguous layout's stride, since its one index never multiplies it."""
    b, r, h, d = x.shape
    dense = (r * h * d, h * d, d)
    return [x.stride(i) if x.shape[i] > 1 else dense[i] for i in range(3)]


def tma_operand(x):
    """A bf16 operand as TMA takes it: d contiguous, the other strides
    multiples of 8 elements (16 bytes) and the base 16-byte aligned.  A
    tensor that breaks this is copied into a fresh contiguous one; the
    kernel is the same either way."""
    ok = x.stride(-1) == 1 and x.data_ptr() % 16 == 0 \
        and all(st % TMA_ALIGN == 0 for st in _strides(x))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def flash_attention_cuda(q, k, v, *, scale: float, window: int = 0,
                         n_meta: int = 0, causal: bool = True,
                         block_q: int = 128, block_k: int = 128,
                         return_lse: bool = False):
    """Launch the CUDA kernel at the tile ``plan`` picks for the blocks.
    q: [B,T,H,d]; k, v: [B,S,KV,d].  The last dim must be contiguous
    (else it is copied); bf16 operands go through ``tma_operand``.  With
    ``return_lse`` it returns ``(o, lse)``, lse the rows' log-sum-exp of
    the scaled scores, [B,H,T] fp32 (for a row that sees no key, a
    fill-sized negative number or -inf, which K2 bwd does not read)."""
    global launches
    _check(q, k, v)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.full((b, h, t), float("-inf"), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0 or s == 0:
        return (o.zero_(), lse) if return_lse else o.zero_()
    bq, bk = plan(t, s, d, block_q=block_q, block_k=block_k, causal=causal,
                  dtype_bytes=q.element_size())
    if q.dtype == torch.bfloat16:
        q, k, v = (tma_operand(x) for x in (q, k, v))
    else:
        q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        _DTYPE_CODES[q.dtype], bq, bk, d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), b, t, s, h, kvh,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        float(scale), int(window), int(n_meta), int(bool(causal)),
        lse.data_ptr() if return_lse else None, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch ({bq}, {bk}, d={d}) failed: "
                           f"cudaError {err} ({lib.flash_attention_error(err).decode()})")
    launches += 1
    return (o, lse) if return_lse else o


def flash_attention_plain(q, k, v, *, scale: float, window: int = 0,
                          n_meta: int = 0, causal: bool = True,
                          **_blocks) -> torch.Tensor:
    """The same function in plain torch (the JAX package's ``_ref_expand``);
    blocks do not change it."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return flash_attention_ref(q, k, v, window=window, n_meta=n_meta,
                               scale=scale, causal=causal)


# ---------------------------------------------------------------- shape rule

# Where the shape rules report the work they stand for, when set (the
# dry-run's per-rank trace): called as hook(kernel name, flops, bytes moved,
# inputs, outputs) on each call.
shape_rule_hook = None


def live_pairs(t: int, s: int, *, window: int = 0, n_meta: int = 0,
               causal: bool = True) -> int:
    """The (query, key) pairs K2 computes for one (batch, head): under the
    causal mask, row r sees the keys up to its own (right-aligned for
    T < S), a window keeps the ``window`` latest of them and the ``n_meta``
    first beside them; without the mask every pair."""
    if not causal:
        return t * s
    hi = np.maximum(0, np.arange(t, dtype=np.int64) + s - t + 1)
    lo = np.maximum(0, hi - window) if window else np.zeros_like(hi)
    return int((hi - lo + np.minimum(n_meta, lo)).sum())


def _report(name, flops, inputs, outputs):
    if shape_rule_hook is not None:
        moved = sum(x.numel() * x.element_size() for x in (*inputs, *outputs))
        shape_rule_hook(name, flops, moved, inputs, outputs)


def flash_attention_shape(q, k, v, *, scale: float, window: int = 0,
                          n_meta: int = 0, causal: bool = True,
                          block_q: int = 128, block_k: int = 128,
                          return_lse: bool = False):
    """K2's shape rule, for tensors on the meta device (the dry-run prices a
    step with nothing allocated): ``o`` (and under ``return_lse`` the fp32
    row log-sum-exp ``[B,H,T]``) in the kernel's shapes and dtypes, with
    the operands prepared as ``flash_attention_cuda`` prepares them, so it
    allocates what a launch does and never the plain version's ``[B,H,T,S]``
    fp32 scores.  Its work is ``4 d`` operations a live pair (``live_pairs``)
    a (batch, head), as ``PERF.md``'s bound counts it."""
    _check(q, k, v, "meta")
    b, t, h, d = q.shape
    if q.dtype == torch.bfloat16:
        q, k, v = (tma_operand(x) for x in (q, k, v))
    else:
        q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if return_lse else None
    flops = 4 * d * b * h * live_pairs(t, k.shape[1], window=window, n_meta=n_meta,
                                       causal=causal)
    _report("flash_attention_fwd", flops, (q, k, v), (o,) if lse is None else (o, lse))
    return (o, lse) if return_lse else o


def flash_attention_bwd_shape(q, k, v, o, do, lse, *, scale: float, window: int = 0,
                              n_meta: int = 0, causal: bool = True, **_blocks):
    """K2 bwd's shape rule on the meta device: ``(dq, dk, dv)`` in the
    kernels' shapes and dtypes, beside the fp32 ``delta`` ``[B,H,T]`` the
    pre-pass writes and the operand copies a launch makes; its work is 2.5
    times the forward's (the recomputed scores and P, dV, dP, dS, dQ, dK)."""
    _check(q, k, v, "meta")
    b, t, h, d = q.shape
    q, k, v, o, do = _bwd_operands(q, k, v, o, do)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    flops = 10 * d * b * h * live_pairs(t, k.shape[1], window=window, n_meta=n_meta,
                                        causal=causal)
    _report("flash_attention_bwd", flops, (q, k, v, o, do, lse), (delta, dq, dk, dv))
    return dq, dk, dv


# ---------------------------------------------------------------- backward

def _bwd_lib():
    lib = _build.load(LIBRARY_BWD)
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([i32, i32] + [ptr] * 10 + [i32] * 5 + [i64] * 15
                       + [ctypes.c_float, i32, i32, i32, ptr])
        fn.restype = i32
        lib.flash_attention_bwd_smem.argtypes = [i32] * 3
        lib.flash_attention_bwd_smem.restype = i32
        lib.flash_attention_bwd_error.argtypes = [i32]
        lib.flash_attention_bwd_error.restype = ctypes.c_char_p
    return lib


def bwd_launch_smem(d: int, kernel: str, dtype_bytes: int = 2) -> int:
    """The shared memory the built library requests for a launch of K2
    bwd's ``kernel`` at head dim d, -1 where none is compiled (loads it)."""
    return _bwd_lib().flash_attention_bwd_smem(0 if _fp32(dtype_bytes) else 1, d,
                                               BWD_KERNELS.index(kernel))


def _bwd_operands(q, k, v, o, do):
    """q, k, v, o and do as K2 bwd reads them: d contiguous (else copied),
    and for bf16 q, k, v and do through ``tma_operand``; o is read by the
    delta pre-pass through its strides."""
    if q.dtype == torch.bfloat16:
        q, k, v, do = (tma_operand(x) for x in (q, k, v, do))
    return tuple(x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v, o, do))


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, scale: float,
                             window: int = 0, n_meta: int = 0,
                             causal: bool = True, **_blocks):
    """Launch K2 bwd: ``(dq, dk, dv)`` of K2 for the output gradient ``do``,
    from the forward's ``o`` and ``lse`` ([B,H,T] fp32).  Shapes and dtypes
    as the forward's; operands as ``_bwd_operands`` makes them.  The tile is
    the kernel's own, so blocks do not change it."""
    global bwd_launches
    _check(q, k, v)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if tuple(x.shape) != (b, t, h, d) or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be [B,H,T] = {(b, h, t)} float32 on {q.device}, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    # the kernels write every row of dq, dk and dv
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kvh, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if q.numel() == 0 or s == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v, o, do = _bwd_operands(q, k, v, o, do)
    lse = lse.contiguous()
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, s, h, kvh,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), *_strides(do),
        float(scale), int(window), int(n_meta), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch (d={d}) failed: cudaError "
                           f"{err} ({lib.flash_attention_bwd_error(err).decode()})")
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, do, *, scale: float, window: int = 0,
                              n_meta: int = 0, causal: bool = True, **_blocks):
    """The same gradient in plain torch: ``flash_attention_plain`` recomputed
    and differentiated by autograd (the JAX package's ``_vjp_bwd``); ``o``
    is not needed."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = flash_attention_plain(q, k, v, scale=scale, window=window,
                                    n_meta=n_meta, causal=causal)
        return torch.autograd.grad(out, (q, k, v), do)


class FlashAttention(torch.autograd.Function):
    """K2 with its gradient (the JAX package's ``custom_vjp``).  On CUDA
    tensors the forward launches K2 and keeps its log-sum-exp, and the
    backward launches K2 bwd; on CPU tensors both take the plain versions,
    on meta tensors the shape rules."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, n_meta, causal, block_q, block_k):
        ctx.kw = dict(scale=scale, window=window, n_meta=n_meta, causal=causal)
        if q.is_cuda or q.is_meta:
            run = flash_attention_cuda if q.is_cuda else flash_attention_shape
            o, lse = run(q, k, v, block_q=block_q, block_k=block_k, return_lse=True,
                         **ctx.kw)
        else:
            o, lse = flash_attention_plain(q, k, v, **ctx.kw), None
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.is_cuda or q.is_meta:
            run = flash_attention_bwd_cuda if q.is_cuda else flash_attention_bwd_shape
            grads = run(q, k, v, o, do, lse, **ctx.kw)
        else:
            grads = flash_attention_bwd_plain(q, k, v, o, do, **ctx.kw)
        return (*grads, None, None, None, None, None, None)
