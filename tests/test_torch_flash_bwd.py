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
from repro.kernels.flash_attention import _vjp_bwd
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.matmul_blocked import SMEM_LIMIT_BYTES


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
    (64, 64, 4, 4, 96, 0, 0, 32),        # phi-3-vision's head dim, MHA
    (128, 128, 8, 2, 120, 32, 4, 64),    # h2o-danube's, group 4, window and meta
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


def test_bwd_operands_reach_the_kernel_as_tma_takes_them():
    """A bf16 ``do`` whose strides TMA refuses (not d-contiguous, or a row
    stride that is no multiple of 8) is copied through ``tma_operand``
    before the launch; q, k, v and do that TMA takes, and o, are passed as
    they are."""
    q, k, v, o = (torch.randn(s).to(torch.bfloat16)
                  for s in [(1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32), (1, 8, 4, 32)])
    for do in (torch.randn(1, 8, 32, 4).to(torch.bfloat16).transpose(2, 3),
               torch.randn(1, 8, 4, 36).to(torch.bfloat16)[..., :32]):
        args = tfa._bwd_operands(q, k, v, o, do)
        assert all(a.data_ptr() == x.data_ptr() for a, x in zip(args[:4], (q, k, v, o)))
        got = args[4]
        assert got.data_ptr() != do.data_ptr() and got.is_contiguous()
        assert torch.equal(got, do)
        assert tfa.tma_operand(got) is got
    do = torch.randn(1, 8, 4, 32).to(torch.bfloat16)
    assert tfa._bwd_operands(q, k, v, o, do)[4] is do
    # fp32 operands are read through their strides: only d must be contiguous
    do32 = torch.randn(1, 8, 4, 36)[..., :32]
    assert tfa._bwd_operands(q.float(), k.float(), v.float(), o.float(), do32)[4] is do32


@pytest.mark.parametrize("kernel", tfa.BWD_KERNELS)
@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_bwd_smem_rule(d, kernel):
    """bf16: two resident 64 x d tiles, a ring of two stages of two, 40
    bytes of barriers and 1024 of alignment padding, and in the dK/dV
    kernel 1024 bytes of staged lse and delta (csrc/flash_bwd_wgmma.cuh);
    d = 96 and 120 are laid out at d = 128 (TMA zero-fills the columns past
    d); every head dim fits 227 KB, and two dQ blocks fit an SM."""
    dp = {96: 128, 120: 128}.get(d, d)
    want = 1024 + 6 * 64 * dp * 2 + 40 + (1024 if kernel == "dkdv" else 0)
    assert tfa.bwd_smem_bytes(d, kernel) == want <= SMEM_LIMIT_BYTES
    if kernel == "dq":
        assert 2 * (want + 1024) <= 228 * 1024
    assert tfa.bwd_smem_bytes(d, kernel, 4) <= SMEM_LIMIT_BYTES


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_bf16_bwd(q, k, v, g, *, scale, window, n_meta, causal, tile=64):
    """K2 bwd's bf16 scheme in torch on the CPU, tile by tile as its dK/dV
    and dQ kernels run: fp32 products of bf16 inputs, P = exp(S scale -
    lse) and dS = P (dP - delta) in fp32, each rounded to bf16 before the
    dV, dK and dQ products, fp32 accumulators, masked pairs selected to 0,
    the blind-row term, outputs rounded to bf16.  o and lse are the
    forward's (o rounded to bf16)."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group, off = h // kvh, s - t
    qpos = torch.arange(t)[:, None] + off
    kpos = torch.arange(s)[None, :]
    seen = torch.ones(t, s, dtype=torch.bool)
    if causal:
        seen &= kpos <= qpos
    if window > 0:
        seen &= ((qpos - kpos) < window) | (kpos < n_meta)
    kx, vx = (x.repeat_interleave(group, dim=2) for x in (k, v))
    scores = torch.einsum("bthd,bshd->bhts", q, kx) * scale
    lse = scores.masked_fill(~seen, float("-inf")).logsumexp(-1)       # [b, h, t]
    probs = torch.exp(scores - lse[..., None]).masked_fill(~seen, 0.0)
    o = _bf16(torch.einsum("bhts,bshd->bthd", probs, vx))
    delta = (g * o).sum(-1).transpose(1, 2)                              # [b, h, t]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def tile_pd(bb, hh, q0, k0):
        """P and dS of rows [q0, q0 + tile) against keys [k0, k0 + tile)."""
        rows, keys = slice(q0, q0 + tile), slice(k0, k0 + tile)
        st = q[bb, rows, hh] @ k[bb, keys, hh // group].T
        dp = g[bb, rows, hh] @ v[bb, keys, hh // group].T
        ok = seen[rows, keys]
        pr = torch.exp(st * scale - lse[bb, hh, rows, None]).masked_fill(~ok, 0.0)
        ds = (pr * (dp - delta[bb, hh, rows, None])).masked_fill(~ok, 0.0)
        return pr, ds

    for bb in range(b):
        for kv in range(kvh):
            for k0 in range(0, s, tile):
                for hh in range(kv * group, (kv + 1) * group):
                    for q0 in range(0, t, tile):
                        if not seen[q0:q0 + tile, k0:k0 + tile].any():
                            continue
                        pr, ds = tile_pd(bb, hh, q0, k0)
                        dv[bb, k0:k0 + tile, kv] += _bf16(pr).T @ g[bb, q0:q0 + tile, hh]
                        dk[bb, k0:k0 + tile, kv] += _bf16(ds).T @ q[bb, q0:q0 + tile, hh]
        for hh in range(h):
            for q0 in range(0, t, tile):
                for k0 in range(0, s, tile):
                    if seen[q0:q0 + tile, k0:k0 + tile].any():
                        dq[bb, q0:q0 + tile, hh] += _bf16(tile_pd(bb, hh, q0, k0)[1]) \
                            @ k[bb, k0:k0 + tile, hh // group]
    blind = ~seen.any(-1)                        # rows that see no key: dO / S to every key
    if blind.any():
        u = g[:, blind].sum(1).reshape(b, kvh, group, d).sum(2)
        dv += u[:, None] / s
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


@pytest.mark.parametrize("t,s,h,kv,window,n_meta,causal", [
    (200, 200, 8, 2, 0, 0, True),        # GQA, T = S a multiple of no tile
    (160, 160, 4, 2, 32, 8, True),       # window 32, meta prefix of 8
    (64, 192, 4, 2, 0, 0, True),         # T < S, right-aligned
    (100, 70, 4, 2, 16, 4, True),        # T > S: rows that see no key
    (64, 128, 4, 2, 0, 0, False),        # non-causal
])
def test_bf16_scheme_within_the_card_tolerance_of_jax(t, s, h, kv, window, n_meta, causal,
                                                      capsys):
    """The bf16 kernels' rounding (P and dS to bf16 before their products)
    at d = 128 keeps dq, dk and dv within phase 10's bf16 tolerance, 3e-2
    of the largest gradient entry, of the JAX package's ``_vjp_bwd`` on
    the same bf16 inputs; the reading is printed."""
    d = 128
    q, k, v, g = (_bf16(torch.tensor(x)) for x in _inputs(t + s + h, 2, t, s, h, kv, d))
    scale = d ** -0.5
    got = _emulate_bf16_bwd(q, k, v, g, scale=scale, window=window, n_meta=n_meta,
                            causal=causal)
    want = _vjp_bwd(scale, window, n_meta, causal, 64, 64, True,
                    tuple(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(g.numpy()))
    rel = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.tensor(np.asarray(w))
        top = w.abs().max().item()
        rel.append((a - w).abs().max().item() / top)
        assert rel[-1] <= 3e-2, (name, rel[-1])
    with capsys.disabled():
        print(f"\n[bf16 scheme] t={t} s={s} window={window} causal={causal}: max abs err "
              f"of dq, dk, dv {', '.join(f'{r:.3e}' for r in rel)} of max |grad| (tol 3e-2)")


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
