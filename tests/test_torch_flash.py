"""The port's flash attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import flash_attention_ref, matmul_ref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, b, t, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, d)), rng.normal(size=(b, s, kv, d)),
            rng.normal(size=(b, s, kv, d)))


def _both(arrays, dtype, **kw):
    """Run JAX's ops.flash_attention and the port's on the same arrays."""
    want = jops.flash_attention(*(jnp.asarray(a, JDT[dtype]) for a in arrays), **kw)
    got = tops.flash_attention(*(torch.tensor(a).to(TDT[dtype]) for a in arrays), **kw)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("t,h,kv,d,win,meta", [
    (128, 4, 4, 64, 0, 0),        # MHA causal
    (128, 4, 2, 64, 0, 0),        # GQA
    (128, 8, 2, 32, 32, 0),       # GQA + sliding window
    (96, 4, 2, 32, 32, 8),        # window + always-visible meta prefix
    (64, 2, 1, 128, 16, 0),       # MQA + window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_jax_sweep(t, h, kv, d, win, meta, dtype):
    arrays = _inputs(t + h + win, 2, t, t, h, kv, d)
    got, want = _both(arrays, dtype, window=win, n_meta=meta, block_q=32,
                      block_k=32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("t,s,block", [
    (100, 100, 32),               # causal, T and S not block multiples (padded)
    (64, 192, 64),                # T < S, right-aligned causal mask
])
def test_flash_matches_jax_ragged(t, s, block):
    arrays = _inputs(11, 2, t, s, 4, 2, 32)
    got, want = _both(arrays, "float32", block_q=block, block_k=block)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_t_less_than_s_ragged_follows_oracle():
    """T < S with keys that do not fill the last block: the port keeps the
    oracle's right alignment by S - T.  (The JAX wrapper pads S first and
    aligns by the padded length, which shifts the causal mask here.)"""
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(12, 2, 50, 100, 4, 2, 32))
    got = tops.flash_attention(q, k, v, block_q=64, block_k=64)
    kk, vv = (x.repeat_interleave(2, dim=2) for x in (k, v))
    want = flash_attention_ref(q, kk, vv)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_noncausal_pad_raises_as_in_jax():
    arrays = _inputs(13, 1, 64, 100, 2, 2, 32)
    with pytest.raises(AssertionError):
        jops.flash_attention(*(jnp.asarray(a, jnp.float32) for a in arrays),
                             causal=False, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="length mask"):
        tops.flash_attention(*(torch.tensor(a, dtype=torch.float32) for a in arrays),
                             causal=False, block_q=32, block_k=32)


def test_flash_block_size_invariance():
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(5, 1, 128, 128, 4, 4, 32))
    outs = [tops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in [(32, 32), (64, 32), (32, 64), (128, 128)]]
    for o in outs[1:]:
        torch.testing.assert_close(outs[0], o, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_without_a_launch():
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(6, 1, 32, 32, 2, 1, 32))
    before = tfa.launches
    tops.flash_attention(q, k, v)
    assert tfa.launches == before


@pytest.mark.parametrize("bad", ["cpu", "dtype", "head_dim", "heads"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.zeros(s) for s in [(1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)])
    if bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(x.shape[:3] + (48,)) for x in (q, k, v))
    elif bad == "heads":
        k, v = torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, k, v, scale=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refs_match_jax(dtype):
    from repro.kernels.ref import flash_attention_ref as jref
    from repro.kernels.ref import matmul_ref as jmm
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(48, 40)), rng.normal(size=(40, 24))
    got = matmul_ref(torch.tensor(a).to(TDT[dtype]), torch.tensor(b).to(TDT[dtype]))
    want = jmm(jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype]))
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)
    q, k, v = _inputs(4, 2, 40, 56, 3, 3, 16)
    got = flash_attention_ref(*(torch.tensor(x).to(TDT[dtype]) for x in (q, k, v)),
                              window=8, n_meta=4)
    want = jref(*(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)), window=8, n_meta=4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
