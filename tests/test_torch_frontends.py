"""The head dims and frontends this slice of the port adds, against the JAX
package on the same weights and numpy inputs.

- K2 at head dims 96 and 120 end to end: ``model_forward`` with
  ``use_flash=True`` and ``train_loss``'s gradients at h2o-danube-3-4b's
  reduced config widened to head dim 120 (GQA, window 32) and at
  phi-3-vision-4.2b's at head dim 96 (with its image prefix), against the
  JAX package's Pallas kernel in interpret mode.  The port used to refuse
  both head dims with ``ValueError``.
- The frontends: phi-3-vision-4.2b's image prefix and musicgen-large's four
  codebooks, ``train_loss`` and its gradients, with and without flash; the
  image prefix moves the logits but not their alignment to the text.
- That the port refuses no arch, and the new parameter leaves carried
  across in bf16.

Forward and prefill + decode parity for both frontend archs are cases of
``tests/test_torch_model.py``'s fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import transformer as jtf
from repro.models.layers import init_param_tree
from repro_torch.configs import ARCH_IDS, reduced_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve
from repro_torch.models import transformer as ttf
from repro_torch.runtime.tree import leaves, unflatten
from repro_torch.weights import init_params, params_from_jax
from test_torch_train import _assert_tree_close, _np

TOL = 2e-3                 # tests/test_torch_model.py's, on logits
GRAD_TOL = 1e-5            # of each gradient leaf's largest entry (fp32 sum order)
LOSS_RTOL = 1e-6
# (name, arch, replace): the two head dims K2 now compiles, at a reduced
# config that keeps the arch's kinds (h2o's window 32 masks at seq 48; GQA
# 2 over 1 for h2o, MHA for phi-3 as published)
HEAD_DIM_CASES = [
    ("d=120", "h2o-danube-3-4b", dict(d_model=240, n_heads=2, n_kv_heads=1, d_head=120)),
    ("d=96", "phi-3-vision-4.2b", dict(d_model=192, n_heads=2, n_kv_heads=2, d_head=96)),
]
FRONTENDS = ("phi-3-vision-4.2b", "musicgen-large")


def _configs(arch, **replace):
    return (jreduced_config(arch).replace(**replace), reduced_config(arch).replace(**replace))


def _batch(cfg, seed=0, b=2, t=48):
    """``serve.draw_inputs`` as a train batch of numpy arrays."""
    tokens, image = serve.draw_inputs(cfg, b, t, np.random.default_rng(seed))
    return {"tokens": tokens} if image is None else {"tokens": tokens, "image_embeds": image}


def _loss_and_grads(jcfg, tcfg, batch, use_flash):
    """(JAX loss, JAX grads, port loss, port grads) of ``train_loss`` from
    the same weights and batch."""
    jparams = init_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jtf.train_loss(jcfg, p, jbatch, use_flash=use_flash),
        has_aux=True)(jparams)
    tparams = params_from_jax(tcfg, _np(jparams))
    flat = leaves(tparams)
    for x in flat:
        x.requires_grad_(True)
    got, _ = ttf.train_loss(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                            use_flash=use_flash)
    return want, jgrads, got, unflatten(tparams, torch.autograd.grad(got, flat))


@pytest.mark.parametrize("name,arch,replace", HEAD_DIM_CASES,
                         ids=[c[0] for c in HEAD_DIM_CASES])
def test_flash_forward_at_a_padded_head_dim_matches_jax(name, arch, replace):
    jcfg, tcfg = _configs(arch, **replace)
    assert tcfg.head_dim == replace["d_head"] and tcfg.head_dim in tfa.HEAD_DIMS
    batch = _batch(tcfg, seed=1)
    jparams = init_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, _np(jparams))
    img = batch.get("image_embeds")
    want, *_ = jtf.model_forward(jcfg, jparams, jnp.asarray(batch["tokens"]),
                                 None if img is None else jnp.asarray(img), use_flash=True)
    with torch.no_grad():
        got, *_ = ttf.model_forward(tcfg, tparams, torch.from_numpy(batch["tokens"]),
                                    None if img is None else torch.from_numpy(img),
                                    use_flash=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,arch,replace", HEAD_DIM_CASES,
                         ids=[c[0] for c in HEAD_DIM_CASES])
def test_flash_train_grads_at_a_padded_head_dim_match_jax(name, arch, replace):
    """fp32: the loss within 1e-6 and every gradient leaf within 1e-5 of its
    largest entry, with the JAX package's Pallas kernel in interpret mode
    (its gradient recomputed through the oracle) against the port's plain
    K2 and K2 bwd behind the autograd Function."""
    jcfg, tcfg = _configs(arch, **replace)
    want, jgrads, got, grads = _loss_and_grads(jcfg, tcfg, _batch(tcfg), use_flash=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    _assert_tree_close(jgrads, grads, GRAD_TOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_train_loss_and_grads_match_jax(arch, use_flash):
    """phi-3-vision's loss covers the text positions only (16 image
    embeddings before them); musicgen's is the mean of its four codebooks'
    cross entropies.  Tolerances as above; img_proj and the [K, ...]
    embedding and head get gradients too."""
    jcfg, tcfg = _configs(arch)
    want, jgrads, got, grads = _loss_and_grads(jcfg, tcfg, _batch(tcfg), use_flash)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    _assert_tree_close(jgrads, grads, GRAD_TOL)
    new = "img_proj" if tcfg.frontend == "vision" else "head"
    assert grads[new].abs().max() > 0


def test_image_prefix_moves_logits_but_not_their_text_alignment():
    """As the JAX package's test_vision_prefix_masked_from_loss: doubling
    the image embeddings changes the logits and the loss, and both stay
    aligned to the text tokens (no logits for the prefix)."""
    cfg = reduced_config("phi-3-vision-4.2b")
    params = params_from_jax(cfg, _np(init_param_tree(
        jtf.param_specs(jreduced_config("phi-3-vision-4.2b")), jax.random.PRNGKey(0))))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, t=32).items()}
    doubled = dict(batch, image_embeds=2.0 * batch["image_embeds"])
    with torch.no_grad():
        outs = [ttf.model_forward(cfg, params, b["tokens"], b["image_embeds"])
                for b in (batch, doubled)]
        losses = [float(ttf.train_loss(cfg, params, b)[0]) for b in (batch, doubled)]
    for logits, hidden, _, _, n_prefix in outs:
        assert n_prefix == cfg.image_tokens == 16
        assert logits.shape == (2, 32, cfg.vocab)
        assert hidden.shape[1] == 32 + cfg.image_tokens
    assert not torch.equal(outs[0][0], outs[1][0])
    assert np.isfinite(losses).all() and losses[0] != losses[1]


def test_no_arch_is_refused():
    """Every arch's reduced config builds its parameter specs and runs its
    forward, its frontend's inputs included."""
    for arch in ARCH_IDS:
        cfg = reduced_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens, img = serve.draw_inputs(cfg, 1, 12, np.random.default_rng(0), "cpu")
        with torch.no_grad():
            logits, *_ = ttf.model_forward(cfg, params, tokens, img)
        assert logits.shape[:2] == (1, 12) and bool(torch.isfinite(logits).all()), arch


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_leaves_carry_across_in_bf16(arch):
    replace = dict(param_dtype="bfloat16")
    cfg = reduced_config(arch).replace(**replace)
    jparams = init_param_tree(jtf.param_specs(jreduced_config(arch).replace(**replace)),
                              jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, _np(jparams))
    d, v, k = cfg.d_model, cfg.vocab, cfg.n_codebooks
    if cfg.frontend == "vision":
        want = {"tok_emb": (v, d), "img_proj": (d, d), "head": (d, v)}
    else:
        want = {"tok_emb": (k, v, d), "head": (k, d, v)}
    for name, shape in want.items():
        assert tuple(tparams[name].shape) == shape and tparams[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(tparams[name].float().numpy(),
                                      np.asarray(jparams[name], np.float32))
