"""The port's mixture-of-experts FFN against the JAX package's on the same
weights and tokens: the softmax router (mixtral's reduced config) and the
sigmoid router with a shared expert (deepseek-v3's reduced MoE config),
with drops (capacity factor 1.25) and without (n_experts / top_k), whole
and routed in groups.  fp32 at the reference tests' 2e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import moe as jmoe
from repro.models.layers import init_param_tree
from repro_torch.configs import reduced_config
from repro_torch.models import moe as tmoe
from repro_torch.weights import _convert

TOL = 2e-3
ROUTERS = {"softmax": "mixtral-8x7b", "sigmoid": "deepseek-v3-671b"}


def _configs(router, no_drop):
    arch = ROUTERS[router]
    out = []
    for cfg in (jreduced_config(arch), reduced_config(arch)):
        assert cfg.moe.router == router
        cf = cfg.moe.n_experts / cfg.moe.top_k if no_drop else 1.25
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))
    return out


def _pair(router, no_drop, seed=0):
    jcfg, tcfg = _configs(router, no_drop)
    jp = init_param_tree(jmoe.moe_spec(jcfg), jax.random.PRNGKey(seed))
    tp = _convert(tmoe.moe_spec(tcfg), jax.tree.map(np.asarray, jp), "moe", "cpu")
    return jcfg, tcfg, jp, tp


def _run(router, no_drop, x):
    jcfg, tcfg, jp, tp = _pair(router, no_drop)
    want, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x), router)
    got, taux = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x), router)
    return tcfg, (want, jaux), (got, taux)


def _skewed(rng, shape):
    """Tokens that share a common direction, so the router favours some
    experts over others at random init and a capacity factor of 1.25
    drops tokens."""
    return (rng.normal(size=shape) + 2 * rng.normal(size=shape[-1:])).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("no_drop", [False, True], ids=["drops", "no-drop"])
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_apply_matches_jax(router, no_drop):
    x = _skewed(np.random.default_rng(1), (2, 40, 128))
    cfg, (want, jaux), (got, taux) = _run(router, no_drop, x)
    _, _, _, tp = _pair(router, no_drop)
    scores = torch.from_numpy(x).reshape(80, 128) @ tp["router"]
    load = torch.bincount(torch.topk(scores, cfg.moe.top_k).indices.reshape(-1))
    # the drop case really drops: an expert is offered more than it takes
    assert (int(load.max()) > tmoe.capacity(80, cfg.moe)) != no_drop
    assert got.shape == x.shape
    _close(got, want)
    _close(taux, jaux)


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_grouped_dispatch_matches_jax(router, monkeypatch):
    """Above MAX_DISPATCH_TOKENS each group of tokens is routed alone, with
    its own capacity, in both packages; the aux loss is the groups' mean."""
    monkeypatch.setattr(jmoe, "MAX_DISPATCH_TOKENS", 32)
    monkeypatch.setattr(tmoe, "MAX_DISPATCH_TOKENS", 32)
    x = _skewed(np.random.default_rng(2), (2, 48, 128))
    _, (want, jaux), (got, taux) = _run(router, False, x)
    _close(got, want)
    _close(taux, jaux)
    monkeypatch.setattr(tmoe, "MAX_DISPATCH_TOKENS", 1 << 20)   # one group
    _, _, _, tp = _pair(router, False)
    _, whole_aux = tmoe.moe_apply(_configs(router, False)[1], tp, torch.from_numpy(x),
                                  router)
    # the mean of per-group products is not the product of whole means
    assert abs(float(whole_aux) - float(taux)) > 1e-4


def test_capacity_matches_jax():
    for router in ROUTERS:
        for no_drop in (False, True):
            jcfg, tcfg = _configs(router, no_drop)
            for nt in (1, 2, 7, 8, 9, 80, 333, 4096):
                assert tmoe.capacity(nt, tcfg.moe) == jmoe.capacity(nt, jcfg.moe)


def test_zero_affinity_picks_contribute_nothing():
    """With few tokens, each expert's top-C over the token axis takes many
    tokens of zero affinity (ties at 0); those add exactly nothing.  The
    output equals a dense per-token sum over each token's routed experts."""
    _, tcfg, _, tp = _pair("softmax", True)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 5, 128)).astype(np.float32))
    got, _ = tmoe.moe_apply(tcfg, tp, x)
    xf = x[0]
    probs = torch.softmax(xf @ tp["router"], dim=-1)
    topv, topi = torch.topk(probs, tcfg.moe.top_k, dim=-1)
    weights = topv / topv.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for n in range(xf.shape[0]):
        for w, e in zip(weights[n], topi[n]):
            h = torch.nn.functional.silu(xf[n] @ tp["w_gate"][e]) * (xf[n] @ tp["w_in"][e])
            want[n] += w * (h @ tp["w_out"][e])
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_gradients_match_jax(router):
    """The router's gradient through the output and the aux loss together."""
    jcfg, tcfg, jp, tp = _pair(router, False)
    x = _skewed(np.random.default_rng(4), (2, 24, 128))

    def jloss(p):
        y, aux = jmoe.moe_apply(jcfg, p, jnp.asarray(x), router)
        return jnp.sum(y ** 2) * 1e-3 + aux
    jgrads = jax.grad(jloss)(jp)
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    y, aux = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x), router)
    (torch.sum(y ** 2) * 1e-3 + aux).backward()
    for name in ("router", "w_in", "w_gate", "w_out"):
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(tp[name].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
