"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) against the
JAX package's on the same weights and inputs, made from a seed with numpy.

The config is mamba2-370m's reduced one (d_model 128, 16 SSM heads of 16,
d_state 16, chunk 16), once more with two B/C groups, so that each group's
projection is shared by its heads."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import ssm as jssm
from repro_torch.configs import reduced_config
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import ParamSpec, init_leaf

TOL = 2e-3
ARCH = "mamba2-370m"
GROUPS = (1, 2)


def _configs(groups=1):
    jcfg, tcfg = jreduced_config(ARCH), reduced_config(ARCH)
    return tuple(c.replace(ssm=dataclasses.replace(c.ssm, n_groups=groups))
                 for c in (jcfg, tcfg))


def _params(cfg, seed=0):
    """Every leaf of ``ssm_spec`` drawn at a scale that makes each term of
    the block count (the reference's zero inits would hide the conv bias
    and the norm)."""
    rng = np.random.default_rng(seed)
    shapes = {k: s.shape for k, s in tssm.ssm_spec(cfg).items()}
    nh = shapes["a_log"]
    u = rng.uniform(1e-3, 1e-1, nh)
    return {
        "in_proj": rng.normal(size=shapes["in_proj"]) * 0.1,
        "conv_w": rng.normal(size=shapes["conv_w"]) * 0.4,
        "conv_b": rng.normal(size=shapes["conv_b"]) * 0.1,
        "a_log": np.log(rng.uniform(1.0, 16.0, nh)),
        "d_skip": rng.normal(size=nh),
        "dt_bias": u + np.log(-np.expm1(-u)),
        "norm": rng.normal(size=shapes["norm"]) * 0.1,
        "out_proj": rng.normal(size=shapes["out_proj"]) * 0.05,
    }


def _both(tree):
    """(jax, torch) fp32 copies of a dict of numpy arrays."""
    return ({k: jnp.asarray(v, jnp.float32) for k, v in tree.items()},
            {k: torch.tensor(v, dtype=torch.float32) for k, v in tree.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _x(cfg, b, t, seed=1):
    return np.random.default_rng(seed).normal(size=(b, t, cfg.d_model))


def test_specs_match_jax():
    jcfg, tcfg = _configs()
    for name, spec in tssm.ssm_spec(tcfg, (3,)).items():
        ref = jssm.ssm_spec(jcfg, (3,))[name]
        assert (spec.shape, spec.dtype, spec.init, spec.axes) == \
            (ref.shape, ref.dtype, ref.init, ref.axes), name
    assert tssm._dims(tcfg)[1:] == jssm._dims(jcfg)[1:]


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    x, w, b = rng.normal(size=(2, 11, 24)), rng.normal(size=(4, 24)), rng.normal(size=24)
    want = jssm._causal_conv(*(jnp.asarray(a, jnp.float32) for a in (x, w, b)))
    got = tssm._causal_conv(*(torch.tensor(a, dtype=torch.float32) for a in (x, w, b)))
    _close(got, want)
    # causal: the first output sees only the first input, times the last tap
    first = torch.nn.functional.silu(torch.tensor(x[:, 0] * w[-1] + b, dtype=torch.float32))
    _close(got[:, 0], first.numpy())


def test_segsum_matches_jax():
    x = -np.random.default_rng(3).uniform(0, 0.5, size=(2, 3, 16))
    want = np.asarray(jssm._segsum(jnp.asarray(x, jnp.float32)))
    got = tssm._segsum(torch.tensor(x, dtype=torch.float32)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=TOL, atol=TOL)


# T: whole chunks (48 = 3 x 16), a ragged last chunk (37), shorter than a
# chunk (5: the chunk shrinks to T)
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("t", [48, 37, 5])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "initial-state"])
def test_ssd_forward_matches_jax(groups, t, with_state):
    jcfg, tcfg = _configs(groups)
    jp, tp = _both(_params(tcfg))
    x = _x(tcfg, 2, t)
    kw_j, kw_t = {}, {}
    if with_state:
        _, _, nh, _ = tssm._dims(tcfg)
        s0 = np.random.default_rng(4).normal(size=(2, nh, tcfg.ssm.head_dim,
                                                   tcfg.ssm.d_state))
        kw_j["initial_state"] = jnp.asarray(s0, jnp.float32)
        kw_t["initial_state"] = torch.tensor(s0, dtype=torch.float32)
    want, wst = jssm.ssd_forward(jcfg, jp, jnp.asarray(x, jnp.float32),
                                 return_state=True, **kw_j)
    got, tst = tssm.ssd_forward(tcfg, tp, torch.tensor(x, dtype=torch.float32),
                                return_state=True, **kw_t)
    _close(got, want)
    assert tst["state"].dtype == torch.float32
    assert tst["state"].shape == wst["state"].shape
    assert tst["conv"].shape == wst["conv"].shape == (2, tcfg.ssm.d_conv - 1,
                                                     tssm._dims(tcfg)[3])
    _close(tst["state"], wst["state"])
    _close(tst["conv"], wst["conv"])
    plain = tssm.ssd_forward(tcfg, tp, torch.tensor(x, dtype=torch.float32), **kw_t)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


@pytest.mark.parametrize("groups", GROUPS)
def test_ssd_decode_matches_jax(groups):
    """Three recurrent steps from a random cache; each step's output and
    the cache it leaves (the port writes it in place) match."""
    jcfg, tcfg = _configs(groups)
    jp, tp = _both(_params(tcfg))
    s, _, nh, conv_dim = tssm._dims(tcfg)
    rng = np.random.default_rng(5)
    state = rng.normal(size=(2, nh, s.head_dim, s.d_state))
    conv = rng.normal(size=(2, s.d_conv - 1, conv_dim))
    jcache = {"state": jnp.asarray(state, jnp.float32), "conv": jnp.asarray(conv, jnp.float32)}
    tcache = {"state": torch.tensor(state, dtype=torch.float32),
              "conv": torch.tensor(conv, dtype=torch.float32)}
    held = dict(tcache)
    for step in range(3):
        x = _x(tcfg, 2, 1, seed=10 + step)
        want, jcache = jssm.ssd_decode(jcfg, jp, jnp.asarray(x, jnp.float32), jcache)
        got, tcache = tssm.ssd_decode(tcfg, tp, torch.tensor(x, dtype=torch.float32), tcache)
        _close(got, want)
        _close(tcache["state"], jcache["state"])
        _close(tcache["conv"], jcache["conv"])
        assert all(tcache[k] is held[k] for k in held)      # written in place


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("t,k", [(40, 5), (32, 3)])
def test_forward_equals_prefix_then_decode(groups, t, k):
    """The port alone: ``ssd_forward`` over T tokens gives, at its last k
    positions, what T - k tokens of ``ssd_forward`` and k ``ssd_decode``
    steps give.  (40, 5) decodes across the chunk boundary at 48 - 16 = 32
    from a ragged prefix; (32, 3) from a ragged one ending at 29."""
    _, tcfg = _configs(groups)
    _, tp = _both(_params(tcfg, seed=6))
    x = torch.tensor(_x(tcfg, 2, t, seed=7), dtype=torch.float32)
    full = tssm.ssd_forward(tcfg, tp, x)
    out, cache = tssm.ssd_forward(tcfg, tp, x[:, :t - k], return_state=True)
    _close(out, full[:, :t - k].numpy())
    for pos in range(t - k, t):
        y, cache = tssm.ssd_decode(tcfg, tp, x[:, pos:pos + 1], cache)
        _close(y[:, 0], full[:, pos].numpy())


def test_ssm_inits_follow_the_reference_ranges():
    """``ones``; A_log = log U[1, 16]; dt_bias = softplus^-1(U[1e-3, 1e-1]),
    drawn in fp32 and cast, as the JAX package's ``_init_leaf``."""
    gen = torch.Generator().manual_seed(0)
    shape = (4096,)
    ones = init_leaf(ParamSpec(shape, (None,), "float32", "ones"), gen, "cpu")
    assert torch.equal(ones, torch.ones(shape))
    a_log = init_leaf(ParamSpec(shape, (None,), "float32", "ssm_a"), gen, "cpu")
    a = a_log.exp()
    assert a_log.dtype == torch.float32
    assert float(a.min()) >= 1.0 - 1e-5 and float(a.max()) <= 16.0 + 1e-4
    assert abs(float(a.mean()) - 8.5) < 0.3                      # uniform on [1, 16]
    dt_bias = init_leaf(ParamSpec(shape, (None,), "float32", "ssm_dt"), gen, "cpu")
    dt = torch.nn.functional.softplus(dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 1e-1 * (1 + 1e-4)
    assert abs(float(dt.mean()) - 0.0505) < 2e-3                 # uniform on [1e-3, 1e-1]
    bf16 = init_leaf(ParamSpec(shape, (None,), "bfloat16", "ssm_a"),
                     torch.Generator().manual_seed(0), "cpu")
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, init_leaf(
        ParamSpec(shape, (None,), "float32", "ssm_a"),
        torch.Generator().manual_seed(0), "cpu").to(torch.bfloat16), rtol=0, atol=0)
