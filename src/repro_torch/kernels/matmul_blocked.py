"""Blocked matrix product (K1): the hand-written CUDA kernels, their plain
version and the rule of which tiles they can run.

``matmul_blocked_cuda`` launches K1 (the port of
``repro/kernels/matmul_blocked.py::_kernel``) on CUDA tensors.  Its C entry
point (``csrc/matmul_blocked.cu``) dispatches by dtype: bf16 runs the
tensor-core kernel of ``csrc/matmul_wgmma.cuh`` (``wgmma`` fed by a TMA /
``mbarrier`` ring), fp32 the CUDA-core kernel of ``matmul_blocked.cu``.
``matmul_blocked_plain`` computes the same function in plain torch: fp32
products summed in fp32, cast to A's dtype.

The ``(block_m, block_n, block_k)`` tile is what the kernel tuner
(``core/kerneltune.py``) chooses.  Each block is clamped to its dimension,
``(block_m, block_n)`` selects the smallest compiled output tile that
covers it, and ``block_k`` sizes the shared memory.  ``fits`` is the
feasibility rule that replaces the TPU kernel's ``vmem_bytes``; a tile it
refuses raises ``ValueError`` and is never swapped for another.  The rule
depends on the dtype, and every function takes it as ``dtype_bytes``:
4 is fp32, any other size the bf16 kernel.

* fp32, 256 threads a block: sides are powers of two 16..512 with
  ``bm * bn <= 32768`` (128 accumulators a thread), and one A and one B
  tile, ``(bm + bn) * bk * 4`` bytes, fit 227 KB.
* bf16, ``wgmma``: ``bm`` is split over ``min(bm / 64, 4)`` consumer
  warpgroups, ``bn <= 256`` (one ``wgmma``), and a consumer thread holds at
  most 128 fp32 accumulators (64 with four consumer warpgroups).  A
  stage's depth is ``bk`` rounded up to a multiple of 64 (one 128-byte
  swizzled row); the ring holds as many stages of ``(bm + bn) * bk * 2``
  bytes as fit 227 KB beside the barriers and alignment padding, at most
  8, and the tile is feasible if it holds two.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref

LIBRARY = _build.Library("matmul_blocked", (
    "matmul_blocked.cu", "matmul_wgmma_bm64.cu", "matmul_wgmma_bm128.cu",
    "matmul_wgmma_bm256.cu"))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Hopper's shared memory a block may use after opting in: 227 KB
# (232,448 bytes) of the SM's 256 KB (NVIDIA H100 data sheet / CUDA
# programming guide, compute capability 9.0)
SMEM_LIMIT_BYTES = 232_448
MAX_TILE = 512

# fp32, the CUDA-core kernel: 256 threads, each owning (bm * bn) / 256 fp32
# accumulators in registers.  A thread may hold at most 255 registers
# (compute capability 9.0); 128 accumulators leave room for the
# bm/16 + bn/16 operand registers and addressing without spilling
# (nvcc -Xptxas -v, printed by chip_smoke.py's build phase)
THREADS = 256
MAX_ACC_PER_THREAD = 128
MAX_ACC_ELEMENTS = THREADS * MAX_ACC_PER_THREAD        # bm * bn <= 32768

# bf16, the wgmma kernel (csrc/matmul_wgmma.cuh): a warpgroup is 128
# threads and a wgmma 64 rows by at most 256 columns.  setmaxnreg leaves a
# consumer thread 255 registers with one consumer warpgroup, 232 with two
# (the producer keeps 40) and 112 with four (the producer keeps 24); the
# accumulators may take 128, 128 and 64 of them.
WARPGROUP = 128
WGMMA_M, WGMMA_MAX_N = 64, 256
MAX_CONSUMER_WARPGROUPS = 4
BOX_K = 64                 # bf16 values in one 128-byte swizzled row
MAX_STAGES = 8
BARRIER_BYTES = 16         # a full and an empty mbarrier per stage
ALIGN_PAD = 1024           # aligning the ring to a 1024-byte swizzle atom
TMA_ALIGN = 8              # bf16 values in 16 bytes: TMA's stride unit

MIN_TILE = {4: 16, 2: WGMMA_M}


def _fp32(dtype_bytes) -> bool:
    return dtype_bytes == 4


def consumer_warpgroups(bm):
    """Consumer warpgroups of a bf16 tile of ``bm`` rows."""
    return np.minimum(np.asarray(bm) // WGMMA_M, MAX_CONSUMER_WARPGROUPS)


def acc_per_thread(bm, bn):
    """fp32 accumulators each consumer thread of a bf16 tile holds."""
    return np.asarray(bm) // consumer_warpgroups(bm) * np.asarray(bn) // WARPGROUP


def _compiled(sm, sn, dtype_bytes):
    """Whether the output tile (sm, sn), powers of two, is compiled."""
    sm, sn = np.asarray(sm, np.float64), np.asarray(sn, np.float64)
    if _fp32(dtype_bytes):
        return (sm <= MAX_TILE) & (sn <= MAX_TILE) & (sm * sn <= MAX_ACC_ELEMENTS)
    w = consumer_warpgroups(sm)
    return (sm <= MAX_TILE) & (sn <= WGMMA_MAX_N) \
        & (acc_per_thread(sm, sn) <= np.where(w >= 4, 64, 128))


# every compiled (BM, BN) by dtype_bytes: the lists csrc/matmul_blocked.cu
# and csrc/matmul_wgmma.h instantiate
FP32_TILES = tuple((bm, bn) for bm in (1 << e for e in range(4, 10))
                   for bn in (1 << e for e in range(4, 10))
                   if _compiled(bm, bn, 4))
WGMMA_TILES = tuple((bm, bn) for bm in (64, 128, 256, 512)
                    for bn in (64, 128, 256, 512) if _compiled(bm, bn, 2))
INSTANTIATED = {4: FP32_TILES, 2: WGMMA_TILES}

# kernel launches since the last reset; a run sets it to 0 and reads it back
# to show that its products went through the kernel
launches = 0


def launch_tile(block, dtype_bytes: int = 2):
    """The compiled tile side that covers ``block``: the smallest power of
    two >= block, at least the dtype's ``MIN_TILE``.  Broadcasts over numpy
    arrays."""
    b = np.maximum(np.asarray(block, np.float64), 1.0)
    floor = float(MIN_TILE[4 if _fp32(dtype_bytes) else 2])
    side = np.maximum(floor, 2.0 ** np.ceil(np.log2(b)))
    return side if side.ndim else float(side)


def launch_depth(bk, dtype_bytes: int = 2):
    """The K depth a launch stages: ``bk`` for fp32; for bf16, ``bk``
    rounded up to a multiple of 64.  Broadcasts over numpy arrays."""
    d = np.asarray(bk, np.float64)
    if not _fp32(dtype_bytes):
        d = np.ceil(d / BOX_K) * BOX_K
    return d if d.ndim else float(d)


def stages(bm, bn, bk):
    """Ring stages of a bf16 launch (bm, bn, bk): as many as fit the shared
    memory beside the padding, at most ``MAX_STAGES``."""
    stage = (np.asarray(bm) + np.asarray(bn)) * np.asarray(bk) * 2 + BARRIER_BYTES
    return np.minimum(MAX_STAGES, (SMEM_LIMIT_BYTES - ALIGN_PAD) // stage)


def smem_bytes(bm, bn, bk, dtype_bytes: int = 2):
    """Dynamic shared memory of a launch (compiled tile, launch depth).
    fp32: one A tile (bm x bk) and one B tile (bk x bn).  bf16: the ring's
    stages, their barriers and the alignment padding; where fewer than two
    stages fit, the two it would need.  Broadcasts over numpy arrays."""
    if _fp32(dtype_bytes):
        return (bm + bn) * bk * 4
    s = np.maximum(stages(bm, bn, bk), 2)
    return s * ((bm + bn) * bk * 2 + BARRIER_BYTES) + ALIGN_PAD


def fits(bm, bn, bk, dtype_bytes: int = 2):
    """The feasibility rule, broadcast over tile arrays: the covering
    output tile is compiled and its launch's shared memory fits."""
    sm, sn = launch_tile(bm, dtype_bytes), launch_tile(bn, dtype_bytes)
    depth = launch_depth(bk, dtype_bytes)
    ok = _compiled(sm, sn, dtype_bytes) & (np.asarray(bk, np.float64) >= 1) \
        & (smem_bytes(sm, sn, depth, dtype_bytes) <= SMEM_LIMIT_BYTES)
    return ok if np.ndim(ok) else bool(ok)


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, *, block_m: int = 128, block_n: int = 128,
         block_k: int = 128, dtype_bytes: int = 2) -> tuple[int, int, int]:
    """The launch a request maps to: blocks clamped to ``min(block, dim)``
    as the JAX wrapper does, then the covering compiled ``(BM, BN)`` and
    the launch depth.  Raises ``ValueError`` on a tile the rule refuses.
    Cached: the rule's numpy arithmetic takes longer on the host than a
    small launch takes on the card."""
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if min(bm, bn, bk) < 1:
        raise ValueError(f"blocks must be positive, got ({block_m}, {block_n}, {block_k})")
    if not fits(bm, bn, bk, dtype_bytes):
        sm, sn = int(launch_tile(bm, dtype_bytes)), int(launch_tile(bn, dtype_bytes))
        depth = int(launch_depth(bk, dtype_bytes))
        need = int(smem_bytes(sm, sn, depth, dtype_bytes))
        if _fp32(dtype_bytes):
            rule = (f"sides <= {MAX_TILE} and bm*bn <= {MAX_ACC_ELEMENTS} "
                    f"(register rule), and {need} bytes of shared memory")
        else:
            rule = (f"bm <= {MAX_TILE}, bn <= {WGMMA_MAX_N} and at most 128 "
                    "accumulators a consumer thread (64 with four consumer "
                    f"warpgroups), and a ring of two stages, {need} bytes of "
                    "shared memory")
        raise ValueError(
            f"tile ({bm}, {bn}, {bk}) is not feasible for the blocked matmul: "
            f"compiled tile ({sm}, {sn}) at depth {depth} needs {rule} "
            f"against {SMEM_LIMIT_BYTES}")
    return (int(launch_tile(bm, dtype_bytes)), int(launch_tile(bn, dtype_bytes)),
            int(launch_depth(bk, dtype_bytes)))


def pad_operands(a, b):
    """bf16 operands as TMA takes them: K and N zero-padded to multiples of
    8 where they are not (TMA needs 16-byte row strides), and a base that
    is not 16-byte aligned copied.  The zeros add nothing to the product,
    and the kernel stores only the first N columns."""
    k, n = b.shape
    kp, np_ = -(-k // TMA_ALIGN) * TMA_ALIGN, -(-n // TMA_ALIGN) * TMA_ALIGN
    if kp != k:
        a, b = F.pad(a, (0, kp - k)), F.pad(b, (0, 0, 0, kp - k))
    if np_ != n:
        b = F.pad(b, (0, np_ - n))
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))


def launch_args(a, b, *, block_m: int = 128, block_n: int = 128,
                block_k: int = 128):
    """``(a, b, (BM, BN, bk))`` as the CUDA wrapper launches them: the
    plan of the request, and bf16 operands through ``pad_operands``."""
    m, k = a.shape
    tile = plan(m, k, b.shape[1], block_m=block_m, block_n=block_n,
                block_k=block_k, dtype_bytes=a.element_size())
    if a.dtype == torch.bfloat16:
        a, b = pad_operands(a, b)
    return a, b, tile


def _lib():
    lib = _build.load(LIBRARY)
    if lib.matmul_blocked.argtypes is None:
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        lib.matmul_blocked.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr,
                                       i32, i32, i32, i32, ptr]
        lib.matmul_blocked.restype = i32
        lib.matmul_blocked_tiles.argtypes = [i32, ctypes.POINTER(i32), i32]
        lib.matmul_blocked_tiles.restype = i32
        lib.matmul_blocked_smem.argtypes = [i32, i32, i32, i32]
        lib.matmul_blocked_smem.restype = i32
        lib.matmul_blocked_error.argtypes = [i32]
        lib.matmul_blocked_error.restype = ctypes.c_char_p
    return lib


def compiled_tiles(dtype_bytes: int = 2) -> list[tuple[int, int]]:
    """The (BM, BN) tiles the built library compiles for a dtype (loads it)."""
    buf = (ctypes.c_int * (2 * 64))()
    n = _lib().matmul_blocked_tiles(0 if _fp32(dtype_bytes) else 1, buf, 64)
    return [(buf[2 * i], buf[2 * i + 1]) for i in range(min(n, 64))]


def launch_smem(bm: int, bn: int, bk: int, dtype_bytes: int = 2) -> int:
    """The shared memory the built library requests for a launch, -1 where
    it would refuse it (loads it)."""
    return _lib().matmul_blocked_smem(0 if _fp32(dtype_bytes) else 1, bm, bn, bk)


def _check(a, b):
    for name, x in (("a", a), ("b", b)):
        if not x.is_cuda:
            raise ValueError(f"matmul_blocked_cuda needs CUDA tensors; {name} is on {x.device}")
        if x.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(x.shape)}")
        if x.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} has dtype {x.dtype}; the kernel takes "
                             f"{sorted(str(d) for d in _DTYPE_CODES)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtypes differ: {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")


def matmul_blocked_cuda(a, b, *, block_m: int = 128, block_n: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel.  a: [M,K], b: [K,N] -> [M,N] in a's dtype."""
    global launches
    _check(a, b)
    a, b = a.contiguous(), b.contiguous()
    m, n = a.shape[0], b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0 or a.shape[1] == 0:
        return c.zero_()
    a, b, (bm, bn, bk) = launch_args(a, b, block_m=block_m, block_n=block_n,
                                     block_k=block_k)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.matmul_blocked(_DTYPE_CODES[a.dtype], bm, bn, bk, a.data_ptr(),
                             b.data_ptr(), c.data_ptr(), m, n, a.shape[1],
                             b.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"matmul_blocked launch ({bm}, {bn}, {bk}) failed: "
                           f"cudaError {err} ({lib.matmul_blocked_error(err).decode()})")
    launches += 1
    return c


def matmul_blocked_plain(a, b, **_blocks) -> torch.Tensor:
    """The same function in plain torch (the oracle); blocks do not change it."""
    return matmul_ref(a, b)
