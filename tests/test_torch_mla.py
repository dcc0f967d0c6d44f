"""MLA (DeepSeek-V3's multi-head latent attention) against the JAX package on
the same numpy weights and inputs: the full-sequence path with and without
its latent, the absorbed decode against a latent cache written in place,
the plain attention with a v head dim of its own (dense and chunked), and
MLA's refusal of the flash kernel, as the reference's MLA never calls it.

The widths are deepseek-v3-671b's reduced config (d_model 128, 4 heads,
q rank 64, kv rank 32, nope 16, rope 16, v head dim 32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import attention as jattn
from repro_torch.configs import reduced_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.weights import init_params

ARCH = "deepseek-v3-671b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}   # tests/test_chunked_attention.py's; K2's bf16


def _weights(cfg, seed=0):
    """MLA weights from numpy: projections N(0, 1/fan_in), norm scales
    N(0, 0.1) so that they are not the identity."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in tattn.mla_spec(cfg).items():
        if spec.init == "zeros":
            out[name] = rng.normal(0, 0.1, spec.shape)
        else:
            out[name] = rng.normal(0, spec.shape[0] ** -0.5, spec.shape)
    return out


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch arrays of ``dtype`` (bf16
    rounded once, in JAX, so both hold the same bits)."""
    j = {k: jnp.asarray(a, jnp.float32).astype(dtype) for k, a in arrays.items()}
    t = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(getattr(torch, dtype))
         for k, v in j.items()}
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.fixture(scope="module")
def cfg():
    cfg = reduced_config(ARCH)
    assert repr(cfg) == repr(jreduced_config(ARCH)) and cfg.mla is not None
    return cfg


def _inputs(cfg, dtype, b=2, t=40, seed=1):
    rng = np.random.default_rng(seed)
    return _both(dict(_weights(cfg), x=rng.normal(size=(b, t, cfg.d_model))), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("return_latent", [False, True])
def test_mla_forward_matches_jax(cfg, dtype, return_latent):
    (jp, tp) = _inputs(cfg, dtype)
    jx, tx = jp.pop("x"), tp.pop("x")
    t = jx.shape[1]
    want = jattn.mla_forward(cfg, jp, jx, jnp.arange(t), return_latent=return_latent)
    got = tattn.mla_forward(cfg, tp, tx, torch.arange(t), return_latent=return_latent)
    if not return_latent:
        want, got = (want, None), (got, None)
    (y, lat), (jy, jlat) = got, want
    assert y.dtype == tx.dtype and y.shape == tx.shape
    _close(y, jy, dtype)
    if return_latent:
        m = cfg.mla
        assert lat[0].shape == (2, t, m.kv_lora_rank) and lat[1].shape == (2, t, m.qk_rope_dim)
        for a, b in zip(lat, jlat):
            _close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax_and_writes_the_cache_in_place(cfg, dtype, steps=3):
    """Prefill T - steps tokens into a latent cache of capacity T + 2, then
    decode ``steps`` tokens: each step's output and the whole cache against
    the JAX package's; the port returns the cache's own tensors, written at
    ``pos`` and nowhere else.  The cast points are the reference's, so in
    bf16 at most 5 % of a step's outputs may differ from its at all (none
    do); moving one (q_lat or o_lat in fp32, scores rounded to bf16) changes
    57-67 % of them by one bf16 step, which the 3e-2 tolerance passes."""
    (jp, tp) = _inputs(cfg, dtype, t=24)
    jx, tx = jp.pop("x"), tp.pop("x")
    t0, cap = jx.shape[1] - steps, jx.shape[1] + 2
    _, (jc, jk) = jattn.mla_forward(cfg, jp, jx[:, :t0], jnp.arange(t0), return_latent=True)
    _, (tc, tk) = tattn.mla_forward(cfg, tp, tx[:, :t0], torch.arange(t0), return_latent=True)
    pad = ((0, 0), (0, cap - t0), (0, 0))
    jcache = {"ckv": jnp.pad(jc, pad), "krope": jnp.pad(jk, pad)}
    tcache = {"ckv": torch.nn.functional.pad(tc, (0, 0, 0, cap - t0)),
              "krope": torch.nn.functional.pad(tk, (0, 0, 0, cap - t0))}
    for pos in range(t0, t0 + steps):
        before = {k: v.clone() for k, v in tcache.items()}
        want, jcache = jattn.mla_decode(cfg, jp, jx[:, pos:pos + 1], jcache,
                                        jnp.asarray(pos, jnp.int32))
        got, out = tattn.mla_decode(cfg, tp, tx[:, pos:pos + 1], tcache, pos)
        assert got.shape == (2, 1, cfg.d_model) and got.dtype == tx.dtype
        _close(got, want, dtype)
        if dtype == "bfloat16":
            assert (got.float().numpy() != np.asarray(want, np.float32)).mean() <= 0.05
        for name in ("ckv", "krope"):
            assert out[name] is tcache[name]
            changed = (tcache[name] != before[name]).any(dim=-1).any(dim=0)
            assert changed.nonzero().flatten().tolist() == [pos]
            _close(tcache[name], jcache[name], dtype)


@pytest.mark.parametrize("dense", [True, False])
def test_attend_takes_a_v_head_dim_of_its_own(monkeypatch, dense):
    """MLA's v head dim differs from its qk head dim: the port's _attend,
    whole or walking query chunks of 16, against the JAX package's
    _chunked_sdpa (tests/test_chunked_attention.py's MLA case) and dense
    _sdpa."""
    rng = np.random.default_rng(0)
    q, k = (rng.normal(size=(1, 48, 2, 24)) for _ in range(2))
    v = rng.normal(size=(1, 48, 2, 10))
    pos = np.arange(48)
    monkeypatch.setattr(jattn, "_CHUNK_Q", 16)
    mask = jattn.causal_window_mask(jnp.asarray(pos), jnp.asarray(pos), 0, 0)
    jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
    want = (jattn._sdpa(jq, jk, jv, mask[None], 24 ** -0.5) if dense else
            jattn._chunked_sdpa(jq, jk, jv, jnp.asarray(pos), 0, 0, 24 ** -0.5))
    if not dense:
        monkeypatch.setattr(tattn, "_CHUNK_THRESHOLD", 1)
        monkeypatch.setattr(tattn, "_CHUNK_Q", 16)
    got = tattn._attend(*(torch.tensor(a, dtype=torch.float32) for a in (q, k, v)),
                        torch.from_numpy(pos), 0, 0, 24 ** -0.5)
    assert got.shape == (1, 48, 2, 10)
    _close(got, want, "float32")


def test_mla_training_attention_in_recomputed_query_chunks(cfg, monkeypatch):
    """While autograd records, ``_attend`` walks its queries in chunks once
    the whole [B, H, T, S] scores pass ``_TRAIN_CHUNK_SCORES``, each chunk
    recomputed in the backward.  With that limit under the [2, 4, 40, 40]
    scores and chunks of 16 queries (the last of 8), ``mla_forward``'s
    output, the loss sum(y * w) and its gradient for every MLA weight and
    for x: against the whole scores' within 1e-6 (fp32), and against the
    JAX package's (``jax.grad``) at this file's fp32 tolerance, the
    gradients' relative to each leaf's largest entry (sums over 80
    positions, in another order).  The chunks'
    attention runs three times in the forward and three again in the
    backward; without autograd the scores stay whole."""
    jp, tp = _inputs(cfg, "float32")
    jx, tx = jp.pop("x"), tp.pop("x")
    t = tx.shape[1]
    w = np.random.default_rng(3).normal(size=tx.shape).astype(np.float32)
    calls = []
    sdpa = tattn._sdpa

    def counted(q, *a, **k):
        calls.append(q.shape[1])
        return sdpa(q, *a, **k)
    monkeypatch.setattr(tattn, "_sdpa", counted)

    def run():
        xs = {k: v.clone().requires_grad_(True) for k, v in dict(tp, x=tx).items()}
        x = xs.pop("x")
        y = tattn.mla_forward(cfg, xs, x, torch.arange(t))
        loss = (y * torch.from_numpy(w)).sum()
        names = sorted(xs)
        grads = torch.autograd.grad(loss, [xs[k] for k in names] + [x])
        return y.detach(), loss.detach(), dict(zip(names + ["x"], grads))

    whole = run()
    assert calls == [t]
    calls.clear()
    monkeypatch.setattr(tattn, "_TRAIN_CHUNK_SCORES", 2 * 4 * t * t - 1)
    monkeypatch.setattr(tattn, "_CHUNK_Q", 16)
    chunked = run()
    assert calls[:3] == [16, 16, 8] and sorted(calls[3:]) == [8, 16, 16]
    calls.clear()
    with torch.no_grad():
        tattn.mla_forward(cfg, tp, tx, torch.arange(t))
    assert calls == [t]
    for a, b in ((chunked[0], whole[0]), (chunked[1], whole[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    for k, g in whole[2].items():
        np.testing.assert_allclose(chunked[2][k].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6 * g.abs().max().item(), err_msg=k)

    def jloss(p, x):
        return jnp.sum(jattn.mla_forward(cfg, p, x, jnp.arange(t)) * w)
    jy = jattn.mla_forward(cfg, jp, jx, jnp.arange(t))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    _close(chunked[0], jy, "float32")
    for k, g in dict(jgp, x=jgx).items():
        g = np.asarray(g)
        np.testing.assert_allclose(chunked[2][k].numpy(), g, rtol=TOL["float32"],
                                   atol=TOL["float32"] * np.abs(g).max(), err_msg=k)


def test_mla_never_calls_flash(cfg, monkeypatch):
    """``use_flash=True`` on an MLA config leaves flash attention uncalled
    and the K2 launch counter at 0, and gives the plain output."""
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(2, cfg.vocab, (2, 20)))
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return flash(*args, **kwargs)
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", counted)
    tfa.launches = 0
    with torch.no_grad():
        want, *_ = ttf.model_forward(cfg, params, tokens)
        got, *_ = ttf.model_forward(cfg, params, tokens, use_flash=True)
        last, _ = ttf.prefill(cfg, params, tokens, use_flash=True)
    assert calls == [] and tfa.launches == 0
    assert torch.equal(got, want) and torch.equal(last[:, 0], want[:, -1])
