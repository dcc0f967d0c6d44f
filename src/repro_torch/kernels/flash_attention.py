"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention.py::_kernel``) on CUDA tensors.
``flash_attention_plain`` computes the same function in plain torch, as the
JAX package's ``_ref_expand`` does: kv heads repeated so that query head h
reads kv head ``h // (H/KV)``, then the oracle.

Forward only: serving needs no gradient.  The backward, which the JAX
package recomputes through its oracle, comes with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

LIBRARY = _build.Library("flash_attention", ("flash_attention.cu",))
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset; a run sets it to 0 and reads it back
# to show that its attention went through the kernel
launches = 0


def _kernel():
    lib = _build.load(LIBRARY)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([i32, i32, ptr, ptr, ptr, ptr] + [i32] * 5 + [i64] * 12
                       + [ctypes.c_float, i32, i32, i32, ptr])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_cuda needs CUDA tensors; {name} is on {x.device}")
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


def flash_attention_cuda(q, k, v, *, scale: float, window: int = 0,
                         n_meta: int = 0, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel.  q: [B,T,H,d]; k, v: [B,S,KV,d]."""
    global launches
    _check(q, k, v)
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or s == 0:
        return o.zero_()
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), b, t, s, h, kvh,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             o.stride(0), o.stride(1), o.stride(2),
             float(scale), int(window), int(n_meta), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    launches += 1
    return o


def flash_attention_plain(q, k, v, *, scale: float, window: int = 0,
                          n_meta: int = 0, causal: bool = True) -> torch.Tensor:
    """The same function in plain torch (the JAX package's ``_ref_expand``)."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return flash_attention_ref(q, k, v, window=window, n_meta=n_meta,
                               scale=scale, causal=causal)
