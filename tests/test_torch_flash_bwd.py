"""The gradient of the port's flash attention (the autograd Function whose
backward is K2 bwd on the card and its plain version on the CPU) against
``jax.grad`` through the JAX package's ``ops.flash_attention`` (Pallas in
interpret mode, its ``custom_vjp`` recomputing through the oracle), on the
same numpy inputs; the wrapper's checks; the kernel on the card where
there is one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops


def _inputs(seed, b, t, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d), (b, t, h, d))]


def _port_grads(q, k, v, g, **kw):
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tops.flash_attention(q, k, v, **kw)
    out.backward(torch.tensor(g))
    return out, (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("t,s,h,kv,d,window,n_meta,block", [
    (64, 64, 4, 2, 32, 0, 0, 32),        # causal GQA
    (96, 96, 4, 2, 32, 16, 4, 32),       # window 16, always-visible meta prefix of 4
    (64, 128, 4, 1, 64, 0, 0, 64),       # T < S, right-aligned causal mask (MQA)
    (96, 32, 4, 2, 32, 0, 0, 32),        # T > S: the first 64 rows see no key
])
def test_flash_grads_match_jax(t, s, h, kv, d, window, n_meta, block):
    """fp32: dq, dk, dv within 1e-5 (sum order; the shapes fill the blocks,
    where the JAX wrapper and the oracle agree: ROADMAP.md section 3)."""
    q, k, v, g = _inputs(t + s + window, 2, t, s, h, kv, d)
    kw = dict(window=window, n_meta=n_meta, block_q=block, block_k=block)

    def loss(qq, kk, vv):
        return jnp.sum(jops.flash_attention(qq, kk, vv, **kw) * g)
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    before = (tfa.launches, tfa.bwd_launches)
    out, got = _port_grads(q, k, v, g, **kw)
    assert isinstance(out.grad_fn, tfa.FlashAttention._backward_cls)
    assert (tfa.launches, tfa.bwd_launches) == before     # the CPU launches nothing
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


def test_bwd_plain_is_the_gradient_of_the_plain_forward():
    q, k, v, g = (torch.tensor(x, dtype=torch.float64)
                  for x in _inputs(3, 1, 40, 56, 4, 2, 32))
    kw = dict(scale=32 ** -0.5, window=8, n_meta=2, causal=True)
    o = tfa.flash_attention_plain(q, k, v, **kw)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, g, **kw)

    def f(qq, kk, vv):
        return (tfa.flash_attention_plain(qq, kk, vv, **kw) * g).sum()
    want = torch.func.grad(f, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_no_grad_call_skips_the_autograd_function():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(4, 1, 32, 32, 2, 1, 32))
    q.requires_grad_(True)
    with torch.no_grad():
        assert tops.flash_attention(q, k, v).grad_fn is None
    assert tops.flash_attention(q.detach(), k, v).grad_fn is None


def test_gradient_of_an_unsupported_head_dim_raises_on_the_cpu():
    q, k, v, _ = (torch.tensor(x, requires_grad=True) for x in _inputs(5, 1, 32, 32, 2, 1, 48))
    with pytest.raises(ValueError, match="not feasible"):
        tops.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["cpu", "head_dim", "lse", "do"])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, g = (torch.zeros(s) for s in [(1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32),
                                           (1, 8, 4, 32)])
    lse = torch.zeros(1, 4, 8)
    if bad == "head_dim":
        q, k, v, g = (torch.zeros(x.shape[:3] + (48,)) for x in (q, k, v, g))
    elif bad == "lse":
        lse = torch.zeros(1, 8, 4)
    elif bad == "do":
        g = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_cuda(q, k, v, q, g, lse, scale=1.0)


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("t,s,window,n_meta,causal", [
    (192, 256, 0, 0, True), (160, 160, 32, 8, True), (100, 100, 0, 0, True),
    (64, 128, 0, 0, False), (160, 96, 0, 0, True), (100, 70, 16, 4, True)])
def test_bwd_kernel_matches_plain_on_the_card(card, dtype, tol, t, s, window, n_meta, causal):
    """fp32 within 1e-4 (sum order over keys); bf16 within 3e-2 of the
    largest gradient entry (the forward rounds P to bf16 for PV, and the
    gradients are rounded to bf16).  Two launches agree bit for bit."""
    for d in tfa.HEAD_DIMS:
        q, k, v, g = (torch.tensor(x).to(card, dtype) for x in _inputs(d, 2, t, s, 4, 2, d))
        kw = dict(scale=d ** -0.5, window=window, n_meta=n_meta, causal=causal)
        o, lse = tfa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        got = tfa.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
        again = tfa.flash_attention_bwd_cuda(q, k, v, o, g, lse, **kw)
        want = tfa.flash_attention_bwd_plain(q, k, v, o, g, **kw)
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            scale = c.float().abs().max().item()
            torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=tol * scale)


@pytest.mark.cuda
def test_forward_with_lse_keeps_its_output_on_the_card(card):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = (torch.tensor(x).to(card, dtype) for x in _inputs(9, 2, 128, 128, 4, 2, 64))
        plain_o = tfa.flash_attention_cuda(q, k, v, scale=0.125)
        o, lse = tfa.flash_attention_cuda(q, k, v, scale=0.125, return_lse=True)
        assert torch.equal(o, plain_o)
        scores = torch.einsum("bthd,bshd->bhts", q.float(),
                              k.float().repeat_interleave(2, dim=2)) * 0.125
        mask = torch.ones(128, 128, dtype=torch.bool, device=card).tril()
        want = scores.masked_fill(~mask, float("-inf")).logsumexp(-1)
        torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)
