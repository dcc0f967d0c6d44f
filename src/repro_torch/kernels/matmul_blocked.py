"""Blocked matrix product: the hand-written CUDA kernel, its plain version
and the rule of which tiles it can run.

``matmul_blocked_cuda`` launches ``csrc/matmul_blocked.cu`` (the port of
``repro/kernels/matmul_blocked.py::_kernel``) on CUDA tensors.
``matmul_blocked_plain`` computes the same function in plain torch: fp32
products summed in fp32, cast to A's dtype.

The ``(block_m, block_n, block_k)`` tile is what the kernel tuner
(``core/kerneltune.py``) chooses.  ``(block_m, block_n)`` selects one of
the compiled output tiles: the smallest power of two, at least
``MIN_TILE``, that covers the block.  ``block_k`` is a launch argument that
sizes the shared memory.  ``fits`` is the feasibility rule that replaces
the TPU kernel's ``vmem_bytes``; a tile it refuses raises ``ValueError``
and is never swapped for another.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref

SOURCE = "matmul_blocked.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Hopper's shared memory a block may use after opting in: 227 KB
# (232,448 bytes) of the SM's 256 KB (NVIDIA H100 data sheet / CUDA
# programming guide, compute capability 9.0)
SMEM_LIMIT_BYTES = 232_448
# the kernel's block: 256 threads, each owning (bm * bn) / 256 fp32
# accumulators in registers.  A thread may hold at most 255 registers
# (compute capability 9.0); 128 accumulators leave room for the
# bm/16 + bn/16 operand registers and addressing without spilling
# (nvcc -Xptxas -v, printed by chip_smoke.py's build phase)
THREADS = 256
MAX_ACC_PER_THREAD = 128
MAX_ACC_ELEMENTS = THREADS * MAX_ACC_PER_THREAD        # bm * bn <= 32768
MIN_TILE, MAX_TILE = 16, 512

# every compiled (BM, BN): powers of two MIN_TILE..MAX_TILE under the
# register rule -- the list csrc/matmul_blocked.cu instantiates
TILE_SIDES = tuple(1 << e for e in range(4, 10))
INSTANTIATED = tuple((bm, bn) for bm in TILE_SIDES for bn in TILE_SIDES
                     if bm * bn <= MAX_ACC_ELEMENTS)

# kernel launches since the last reset; a run sets it to 0 and reads it back
# to show that its products went through the kernel
launches = 0


def launch_tile(block):
    """The compiled tile side that covers ``block``: the smallest power of
    two >= block, at least ``MIN_TILE``.  Broadcasts over numpy arrays."""
    b = np.maximum(np.asarray(block, np.float64), 1.0)
    side = np.maximum(float(MIN_TILE), 2.0 ** np.ceil(np.log2(b)))
    return side if side.ndim else float(side)


def smem_bytes(bm, bn, bk, dtype_bytes: int = 2):
    """Shared memory one block takes: one A tile (bm x bk) and one B tile
    (bk x bn) in the input dtype.  Broadcasts over numpy arrays."""
    return (bm + bn) * bk * dtype_bytes


def fits(bm, bn, bk, dtype_bytes: int = 2):
    """The feasibility rule, broadcast over tile arrays: the covering
    compiled tile exists (sides <= MAX_TILE, bm * bn accumulators within
    the register rule) and its A and B tiles fit the shared memory."""
    sm, sn = launch_tile(bm), launch_tile(bn)
    bk = np.asarray(bk, np.float64)
    ok = (sm <= MAX_TILE) & (sn <= MAX_TILE) & (sm * sn <= MAX_ACC_ELEMENTS) \
        & (bk >= 1) & (smem_bytes(sm, sn, bk, dtype_bytes) <= SMEM_LIMIT_BYTES)
    return ok if np.ndim(ok) else bool(ok)


def plan(m: int, k: int, n: int, *, block_m: int = 128, block_n: int = 128,
         block_k: int = 128, dtype_bytes: int = 2) -> tuple[int, int, int]:
    """The launch a request maps to: blocks clamped to ``min(block, dim)``
    as the JAX wrapper does, then the covering compiled ``(BM, BN)`` and
    the clamped ``bk``.  Raises ``ValueError`` on a tile the rule refuses."""
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if min(bm, bn, bk) < 1:
        raise ValueError(f"blocks must be positive, got ({block_m}, {block_n}, {block_k})")
    if not fits(bm, bn, bk, dtype_bytes):
        sm, sn = int(launch_tile(bm)), int(launch_tile(bn))
        raise ValueError(
            f"tile ({bm}, {bn}, {bk}) is not feasible for the blocked matmul: "
            f"compiled tile ({sm}, {sn}) needs sides <= {MAX_TILE} and "
            f"bm*bn <= {MAX_ACC_ELEMENTS} (register rule), and "
            f"{smem_bytes(sm, sn, bk, dtype_bytes)} bytes of shared memory "
            f"against {SMEM_LIMIT_BYTES}")
    return int(launch_tile(bm)), int(launch_tile(bn)), bk


def _kernel():
    lib = _build.load(SOURCE)
    fn = lib.matmul_blocked
    if fn.argtypes is None:
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
    return fn


def compiled_tiles() -> list[tuple[int, int]]:
    """The (BM, BN) tiles the built library instantiates (loads it)."""
    fn = _build.load(SOURCE).matmul_blocked_tiles
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_int * (2 * 64))()
    n = fn(buf, 64)
    return [(buf[2 * i], buf[2 * i + 1]) for i in range(min(n, 64))]


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
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0 or k == 0:
        return c.zero_()
    bm, bn, bk = plan(m, k, n, block_m=block_m, block_n=block_n,
                      block_k=block_k, dtype_bytes=a.element_size())
    fn = _kernel()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(_DTYPE_CODES[a.dtype], bm, bn, bk, a.data_ptr(), b.data_ptr(),
             c.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"matmul_blocked launch ({bm}, {bn}, {bk}) failed: "
                           f"cudaError {err}")
    launches += 1
    return c


def matmul_blocked_plain(a, b, **_blocks) -> torch.Tensor:
    """The same function in plain torch (the oracle); blocks do not change it."""
    return matmul_ref(a, b)
