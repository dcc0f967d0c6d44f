"""The port's training path against the JAX package on the same weights and
tokens: ``train_loss`` and its gradients, three train steps with gradient
accumulation (the JAX package's no-mesh ``make_train_step``, jitted), and
the launcher's loss, resume and failure-injection paths on the CPU.

The models are Yi-6B's and mixtral-8x7b's reduced configs scaled to
d_model 128, 2 layers, vocab 256 and 4 query heads over 2 kv heads: head
dim 32, the smallest that the port's flash-attention kernel takes (it
refuses 16, which d_model 64 would give).  Mixtral's loss carries the MoE
load-balance term, whose gradient has to survive per-layer remat."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.launch.train import scale_config as jscale_config
from repro.models import transformer as jtf
from repro.models.layers import init_param_tree
from repro.runtime import optim as joptim
from repro.runtime import steps as jsteps
from repro_torch.configs import reduced_config
from repro_torch.launch import train
from repro_torch.launch.serve import scale_config
from repro_torch.models import transformer as ttf
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.tree import flatten, leaves, unflatten
from repro_torch.weights import opt_state_from_jax, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
SCALE = dict(d_model=128, n_layers=2, vocab=256, heads=4)
HP = dict(peak_lr=1e-3, warmup=2, total_steps=6)
ARCHS = ("yi-6b", "mixtral-8x7b")


def _configs(arch="yi-6b", **replace):
    return (jscale_config(jreduced_config(arch), **SCALE).replace(**replace),
            scale_config(reduced_config(arch), **SCALE).replace(**replace))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(jtree, ttree, rel):
    """Every leaf within ``rel`` of the JAX leaf's largest magnitude."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = flatten(ttree)
    assert len(jflat) == len(tflat)
    for (jpath, a), (path, b) in zip(jflat, tflat):
        assert "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                        for k in jpath) == path
        a = np.asarray(a, np.float32)
        b = b.detach().float().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * (np.abs(a).max() + 1e-30),
                                   err_msg=path)


@pytest.fixture(scope="module", params=ARCHS)
def loss_pair(request):
    jcfg, tcfg = _configs(request.param)
    jparams = init_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, SCALE["vocab"], (2, 64)).astype(np.int32)
    return jcfg, tcfg, jparams, tokens


@pytest.mark.parametrize("use_flash", [False, True])
def test_train_loss_and_grads_match_jax(loss_pair, use_flash):
    """fp32: the loss within 1e-6 and every gradient leaf within 1e-5 of
    its largest entry (measured 7.7e-7: sum order only).  With flash, JAX's
    Pallas kernel runs in interpret mode and its gradient recomputes
    through the oracle; the port's takes the plain versions of K2 and K2
    bwd through its autograd Function."""
    jcfg, tcfg, jparams, tokens = loss_pair

    def jloss(p):
        return jtf.train_loss(jcfg, p, {"tokens": jnp.asarray(tokens)},
                              use_flash=use_flash)
    (want, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    tparams = params_from_jax(tcfg, _np(jparams))
    flat = leaves(tparams)
    for x in flat:
        x.requires_grad_(True)
    got, metrics = ttf.train_loss(tcfg, tparams, {"tokens": torch.from_numpy(tokens)},
                                  use_flash=use_flash)
    grads = unflatten(tparams, torch.autograd.grad(got, flat))
    assert metrics["loss"] is got
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    if tcfg.moe is not None:                    # the aux loss is in the loss
        aux = float(metrics["aux"].detach())
        np.testing.assert_allclose(aux, float(jmetrics["aux"]), rtol=1e-6)
        assert aux > 0 and float(metrics["ce"].detach()) != float(got.detach())
    _assert_tree_close(jgrads, grads, 1e-5)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_train_loss_and_grads_match_jax(arch):
    """The SSM families under per-layer remat (the configs' default), fp32:
    the loss within 1e-6 and every gradient leaf within 1e-5 of its largest
    entry, against the JAX package's jitted value_and_grad of train_loss
    (what its no-mesh make_train_step takes).  Seq 64 runs four SSD chunks
    of 16 for mamba2, and for hymba (8 meta tokens) a ragged fifth."""
    jcfg, tcfg = _configs(arch)
    assert tcfg.remat and jcfg.remat
    jparams = init_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, SCALE["vocab"], (2, 64)).astype(np.int32)
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.train_loss(jcfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jparams)
    tparams = params_from_jax(tcfg, _np(jparams))
    flat = leaves(tparams)
    for x in flat:
        x.requires_grad_(True)
    got, _ = ttf.train_loss(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    grads = unflatten(tparams, torch.autograd.grad(got, flat))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    _assert_tree_close(jgrads, grads, 1e-5)


def test_remat_changes_no_gradient(loss_pair):
    """Per-layer recomputation in the backward gives the loss and the
    gradients of the plain backward bit for bit (the same ops run on the
    same inputs); for MoE that includes the aux loss and its gradient."""
    _, tcfg, jparams, tokens = loss_pair
    out, losses = [], []
    for remat in (True, False):
        cfg = tcfg.replace(remat=remat)
        params = params_from_jax(cfg, _np(jparams))
        flat = leaves(params)
        for x in flat:
            x.requires_grad_(True)
        loss, _ = ttf.train_loss(cfg, params, {"tokens": torch.from_numpy(tokens)})
        losses.append(loss.detach())
        out.append(torch.autograd.grad(loss, flat))
    assert torch.equal(*losses)
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_remat_dots_policy_raises_naming_its_item(loss_pair):
    _, tcfg, jparams, tokens = loss_pair
    cfg = tcfg.replace(remat_policy="dots")
    params = params_from_jax(cfg, _np(jparams))
    with torch.no_grad():                  # no remat without autograd: runs
        ttf.train_loss(cfg, params, {"tokens": torch.from_numpy(tokens)})
    params["head"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match=r'ROADMAP.md, training: remat "dots"'):
        ttf.train_loss(cfg, params, {"tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("remat", [True, False])
def test_mla_mtp_train_loss_and_grads_match_jax(remat):
    """deepseek-v3-671b's reduced config (MLA, two dense layers and a
    sigmoid-routed MoE layer, multi-token prediction), fp32, with and
    without per-layer remat on both sides: ce, aux, mtp and the loss within
    1e-6, every gradient leaf within 1e-5 of its largest entry, and every
    leaf of the MTP subtree gets a gradient (its norms' too)."""
    arch = "deepseek-v3-671b"
    jcfg = jreduced_config(arch).replace(remat=remat)
    tcfg = reduced_config(arch).replace(remat=remat)
    assert tcfg.mla is not None and tcfg.mtp_depth == 1 and any(tcfg.layer_moe)
    jparams = init_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 48)).astype(np.int32)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.train_loss(jcfg, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jparams)
    tparams = params_from_jax(tcfg, _np(jparams))
    flat = leaves(tparams)
    for x in flat:
        x.requires_grad_(True)
    got, metrics = ttf.train_loss(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    grads = unflatten(tparams, torch.autograd.grad(got, flat))
    assert set(metrics) == set(jmetrics) == {"ce", "aux", "mtp", "loss"}
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key].detach()), float(jmetrics[key]),
                                   rtol=1e-6, err_msg=key)
    _assert_tree_close(jgrads, grads, 1e-5)
    mtp = flatten(grads["mtp"])
    assert len(mtp) == 16 and all(bool(g.abs().max() > 0) for _, g in mtp)


@pytest.mark.parametrize("kw,item", [({"compress_fn": lambda g: g}, "compress.py"),
                                     ({"shard_ctx": object()}, "shardctx.py")])
def test_unported_step_options_raise(kw, item):
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match=item):
        tsteps.make_train_step(tcfg, **kw)


@pytest.fixture(scope="module", params=ARCHS)
def three_steps(request):
    """Three steps of the JAX package's jitted no-mesh step and of the
    port's, from the same weights, on the same tokens, two microbatches."""
    jcfg, tcfg = _configs(request.param, train_microbatches=2)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsteps.TrainHParams(**HP)))
    tstep = tsteps.make_train_step(tcfg, tsteps.TrainHParams(**HP))
    jp = init_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(1))
    jo = init_param_tree(joptim.opt_state_specs(jcfg, jtf.param_specs(jcfg)),
                         jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, _np(jp))
    to = opt_state_from_jax(tcfg, _np(jo))
    rng = np.random.default_rng(1)
    out = []
    for step in range(3):
        tokens = rng.integers(0, SCALE["vocab"], (2, 2, 64)).astype(np.int32)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(tokens)},
                           jnp.asarray(step, jnp.int32))
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(tokens)}, step)
        out.append((_np(jp), _np(jo), {k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()},
                    jax.tree.map(lambda x: x.clone(), (tp, to))))
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
def test_train_steps_match_jax(three_steps, step):
    """loss, gnorm and lr within 1e-6; every parameter and moment leaf
    within 2e-5 of the leaf's largest entry.  The gradients agree to ~1e-6
    (sum order); AdamW's early updates are ~lr * sign(g), so an entry whose
    gradient is near eps can move by a different fraction of lr (measured:
    6.1e-6 at a norm scale, 1.2e-6 in the moments)."""
    jp, jo, jm, tm, (tp, to) = three_steps[step]
    for key in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-6, err_msg=key)
    assert tm["step"] == jm["step"] == step + 1
    _assert_tree_close(jp, tp, 2e-5)
    _assert_tree_close(jo["mu"], to["mu"], 2e-5)
    _assert_tree_close(jo["nu"], to["nu"], 2e-5)
    assert int(to["count"]) == int(jo["count"]) == step + 1


# ------------------------------------------------------------- the launcher
ARGS = ["--device", "cpu", "--quiet", "--global-batch", "8", "--seq", "64"]


def test_launcher_loss_improves(tmp_path):
    losses = train.main(["--steps", "14", "--ckpt-every", "7",
                         "--ckpt-dir", str(tmp_path / "ck"), *ARGS])
    assert len(losses) == 14 and np.all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_launcher_resumes_from_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    whole = train.main(["--steps", "12", "--ckpt-every", "4",
                        "--ckpt-dir", str(tmp_path / "whole"), *ARGS])
    train.main(["--steps", "8", "--ckpt-every", "4", "--ckpt-dir", ck, *ARGS])
    losses = train.main(["--steps", "12", "--ckpt-every", "4", "--resume",
                         "--ckpt-dir", ck, *ARGS])
    assert len(losses) == 4                     # resumed at 8, ran to 12
    # the checkpoint holds weights, moments and the data cursor: the resumed
    # steps are the uninterrupted run's
    np.testing.assert_allclose(losses, whole[8:], rtol=1e-6)


def test_launcher_failure_injection_recovers(tmp_path):
    losses = train.main(["--steps", "12", "--ckpt-every", "4",
                         "--inject-failure", "6", "--use-flash",
                         "--ckpt-dir", str(tmp_path / "ck"), *ARGS])
    # restored to step 4 then re-ran: steps 5 and 6 ran twice, alike
    assert len(losses) == 14
    np.testing.assert_allclose(losses[6:8], losses[4:6], rtol=1e-6)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_python_m_repro_torch_train_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "train", "--steps", "2",
         "--ckpt-dir", str(tmp_path / "ck"), "--microbatches", "1", *ARGS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "[train] done" in proc.stdout
    assert (tmp_path / "ck" / "step_00000002" / "COMMITTED").exists()


def test_launcher_without_a_card_refuses_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
