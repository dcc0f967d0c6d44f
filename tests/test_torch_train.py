"""The port's training path against the JAX package on the same weights and
tokens: ``train_loss`` and its gradients, remat "dots" against "full", no
remat and the JAX package's "dots", three train steps with gradient
accumulation (the JAX package's no-mesh ``make_train_step``, jitted), the
step with top-k compression, the sharded step on a one-rank mesh, and the
launcher's loss, resume and failure-injection paths on the CPU (one rank, a
1x1 mesh; four ranks in ``tests/test_torch_elastic.py``).

The models are Yi-6B's and mixtral-8x7b's reduced configs scaled to
d_model 128, 2 layers, vocab 256 and 4 query heads over 2 kv heads: head
dim 32, the smallest that the port's flash-attention kernel takes (it
refuses 16, which d_model 64 would give).  Mixtral's loss carries the MoE
load-balance term, whose gradient has to survive per-layer remat.  The
three steps also run hymba-1.5b's, mamba2-370m's, h2o-danube-3-4b's,
phi-3-vision-4.2b's (image embeddings), musicgen-large's (four
codebooks) and gemma3-27b's (a local and a global layer) reduced configs
at the same scale, and deepseek-v3-671b's at 3 layers (MLA, an MoE layer,
MTP) under its own Adafactor with fp32 or bf16 accumulation and state; the
bf16 accumulation is held bit for bit on its own; one flash step of five
of them counts K2's and K2 bwd's calls against ``chip_smoke.py``'s launch
formula, and ``chip_smoke.model_flops`` is held to a hand count."""
import contextlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from repro_torch.runtime import optim as topt
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.optim import cosine_schedule as tcosine_schedule
from repro_torch.runtime.optim import opt_state_specs as topt_state_specs
from repro_torch.runtime.optim import opt_update as topt_update
from repro_torch.runtime.tree import flatten, leaves, tree_map, unflatten
from repro_torch.weights import opt_state_from_jax, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
SCALE = dict(d_model=128, n_layers=2, vocab=256, heads=4)
HP = dict(peak_lr=1e-3, warmup=2, total_steps=6)
ARCHS = ("yi-6b", "mixtral-8x7b")


def _configs(arch="yi-6b", scale=SCALE, **replace):
    return (jscale_config(jreduced_config(arch), **scale).replace(**replace),
            scale_config(reduced_config(arch), **scale).replace(**replace))


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


def _loss_and_grads(cfg, jparams, tokens, count=None):
    """fp32 loss and gradients of the port's train_loss; with ``count`` (a
    dispatch mode) the backward runs under it."""
    params = params_from_jax(cfg, _np(jparams))
    flat = leaves(params)
    for x in flat:
        x.requires_grad_(True)
    loss, metrics = ttf.train_loss(cfg, params, {"tokens": torch.from_numpy(tokens)})
    with count if count is not None else contextlib.nullcontext():
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), metrics, unflatten(params, grads)


def test_remat_dots_matches_full_and_no_remat(loss_pair):
    """Selective recomputation (remat "dots") gives the loss and gradients
    of "full" remat and of no remat (rtol 1e-6; measured bit for bit: the
    same ops run on the same inputs, only where their outputs come from
    differs); for MoE that includes the aux loss carried out of the
    checkpoint."""
    _, tcfg, jparams, tokens = loss_pair
    runs = [_loss_and_grads(tcfg.replace(remat=remat, remat_policy=policy), jparams, tokens)
            for remat, policy in ((True, "dots"), (True, "full"), (False, "full"))]
    (dots, dm, dg), others = runs[0], runs[1:]
    for loss, metrics, grads in others:
        np.testing.assert_allclose(float(dots), float(loss), rtol=1e-6)
        if tcfg.moe is not None:
            np.testing.assert_allclose(float(dm["aux"]), float(metrics["aux"]), rtol=1e-6)
        for (path, a), b in zip(flatten(dg), leaves(grads)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(b.abs().max()), err_msg=path)


def test_remat_dots_matches_jax(loss_pair):
    """Both packages under remat "dots" (JAX's
    ``dots_with_no_batch_dims_saveable``), fp32: the loss within 1e-6 and
    every gradient leaf within the file's 1e-5 of its largest entry."""
    jcfg, tcfg, jparams, tokens = loss_pair
    jcfg, tcfg = (c.replace(remat=True, remat_policy="dots") for c in (jcfg, tcfg))

    def jloss(p):
        return jtf.train_loss(jcfg, p, {"tokens": jnp.asarray(tokens)})
    (want, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    got, _, grads = _loss_and_grads(tcfg, jparams, tokens)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _assert_tree_close(jgrads, grads, 1e-5)


class _Products(TorchDispatchMode):
    """Counts the unbatched matrix products (what "dots" saves) and the
    batched ones (what it recomputes) that run under it."""

    def __init__(self):
        super().__init__()
        self.unbatched = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if ttf.unbatched_product(func, args):
            self.unbatched += 1
        elif func is torch.ops.aten.bmm.default:
            self.batched += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_backward_recomputes_no_unbatched_product(loss_pair):
    """Under "dots" the backward runs exactly the unbatched products of the
    backward without remat: none is recomputed, while "full" recomputes
    some.  The batched products (scores, MoE experts) are recomputed under
    "dots" as under "full"."""
    _, tcfg, jparams, tokens = loss_pair
    counts = {}
    for name, remat, policy in (("none", False, "full"), ("full", True, "full"),
                                ("dots", True, "dots")):
        mode = _Products()
        _loss_and_grads(tcfg.replace(remat=remat, remat_policy=policy), jparams, tokens,
                        count=mode)
        counts[name] = (mode.unbatched, mode.batched)
    assert counts["dots"][0] == counts["none"][0] > 0
    assert counts["full"][0] > counts["none"][0]
    assert counts["dots"][1] == counts["full"][1] > counts["none"][1]


def _per_layer_selects(tree, n, place=lambda v: v):
    """The stage's layers as a ``v[r]`` per layer and leaf: the
    ``select`` whose backward fills a stack-sized zero gradient per layer."""
    return [{k: _per_layer_selects(v, n, place)[r] if isinstance(v, dict) else place(v[r])
             for k, v in tree.items()} for r in range(n)]


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_unbind_per_stage_gives_the_select_loops_gradients(monkeypatch, arch, policy):
    """``stage_forward`` takes a stage's layers with one ``unbind`` of each
    stacked leaf; a ``v[r]`` per layer summed stack-sized zero gradients.
    Both give every parameter gradient bit for bit (adding zeros is exact),
    under remat "full" and "dots": two train steps of two microbatches,
    the accumulated gradient tree of each step and the weights after."""
    _, tcfg = _configs(arch, train_microbatches=2, remat=True, remat_policy=policy)
    pspecs = ttf.param_specs(tcfg)
    state = train.init_state((pspecs, topt_state_specs(tcfg, pspecs)), torch.device("cpu"), 2)
    rng = np.random.default_rng(4)
    tokens = [torch.from_numpy(rng.integers(0, SCALE["vocab"], (2, 2, 64)).astype(np.int32))
              for _ in range(2)]
    runs = []
    for layers in (ttf._layers, _per_layer_selects):
        monkeypatch.setattr(ttf, "_layers", layers)
        seen = []

        def keep(g):
            seen.append(tree_map(torch.clone, g))
            return g
        step = tsteps.make_train_step(tcfg, tsteps.TrainHParams(**HP), compress_fn=keep)
        p, o = tree_map(torch.clone, state)
        for i, t in enumerate(tokens):
            p, o, _ = step(p, o, {"tokens": t}, i)
        runs.append((seen, p))
    (seen_a, p_a), (seen_b, p_b) = runs
    assert len(seen_a) == len(seen_b) == 2
    for ga, gb in zip(seen_a, seen_b):
        for (path, a), b in zip(flatten(ga), leaves(gb)):
            assert torch.equal(a, b), path
    for (path, a), b in zip(flatten(p_a), leaves(p_b)):
        assert torch.equal(a, b), path


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


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_step_matches_jax(arch):
    """Three steps with top-k gradient compression (ratio 0.25, no carried
    feedback: stateless under jit) against the JAX package's jitted no-mesh
    step given JAX's compressor: loss and gnorm (of the compressed
    gradient) within 1e-6 at every step; JAX's compressor given the very
    gradients the port's step handed its compressor returns what the port's
    returned, bit for bit; and the step really sent a sparse gradient (the
    same steps without compression move the weights elsewhere).  The
    weights are not compared leaf by leaf: a gradient entry within a
    sum-order difference of its leaf's k-th magnitude falls on either side
    of the cut (2 of mixtral's 65536 ``w_gate`` entries after three steps).

    JAX's ``compress_topk`` takes the tree apart with ``is_leaf=tuple``,
    which also catches a model's ``stages`` tuple (an IndexError on every
    model's gradient tree), so the JAX side applies it leaf by leaf; the
    port's walks the tree by its paths."""
    from repro.runtime import compress as jc
    from repro_torch.runtime import compress as tc

    jcfg, tcfg = _configs(arch, train_microbatches=2)

    def jcompress(g):
        return jax.tree.map(
            lambda x: jc.compress_topk({"x": x}, jc.init_feedback({"x": x}), 0.25)[0]["x"], g)

    seen = []

    def tcompress(g):
        sent = tc.compress_topk(g, tc.init_feedback(g), 0.25)[0]
        # copies: the optimizer clips the gradients it is handed in place
        seen.append((tree_map(torch.clone, g), tree_map(torch.clone, sent)))
        return sent
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsteps.TrainHParams(**HP),
                                           compress_fn=jcompress))
    tstep = tsteps.make_train_step(tcfg, tsteps.TrainHParams(**HP), compress_fn=tcompress)
    plain = tsteps.make_train_step(tcfg, tsteps.TrainHParams(**HP))
    jp = init_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(1))
    jo = init_param_tree(joptim.opt_state_specs(jcfg, jtf.param_specs(jcfg)),
                         jax.random.PRNGKey(0))
    tp, to = params_from_jax(tcfg, _np(jp)), opt_state_from_jax(tcfg, _np(jo))
    pp, po = params_from_jax(tcfg, _np(jp)), opt_state_from_jax(tcfg, _np(jo))
    rng = np.random.default_rng(1)
    for step in range(3):
        tokens = rng.integers(0, SCALE["vocab"], (2, 2, 64)).astype(np.int32)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(tokens)},
                           jnp.asarray(step, jnp.int32))
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(tokens)}, step)
        pp, po, _ = plain(pp, po, {"tokens": torch.from_numpy(tokens)}, step)
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6,
                                       err_msg=key)
        grads, sent = seen[-1]
        want = jcompress(jax.tree.unflatten(jax.tree.structure(jp),
                                            [jnp.asarray(g.numpy()) for g in leaves(grads)]))
        for (path, a), b in zip(flatten(sent), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)
    assert len(seen) == 3
    assert not torch.allclose(tp["head"], pp["head"])


def test_sharded_step_on_one_rank_matches_plain():
    """The sharded step on a 1x1 mesh (one gloo rank, in-process): params and
    moments are DTensors before and after, and three steps give the plain
    step's loss and gnorm (rtol 1e-6) and weights (1e-5 of each leaf's
    scale: its largest entry and at least the peak learning rate, as
    ``tests/test_torch_sharding.py`` holds four ranks; the sharded loss's
    log-sum-exp is summed in another order, and AdamW turns that into up to
    2e-6 of a zero-initialised norm scale's largest entry)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import sharding as shd

    _, tcfg = _configs(train_microbatches=2)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        shape = ShapeConfig("t", "train", 64, 4)
        rules = shd.make_rules(tcfg, mesh, shape)
        hp = tsteps.TrainHParams(**HP)
        sharded = tsteps.make_train_step(tcfg, hp, shard_ctx=(mesh, rules))
        plain = tsteps.make_train_step(tcfg, hp)
        pspecs = ttf.param_specs(tcfg)
        p, o = train.init_state((pspecs, topt_state_specs(tcfg, pspecs)),
                                torch.device("cpu"), 0)
        sp = shd.distribute_tree(tree_map(torch.clone, p), mesh,
                                 shd.spec_shardings(pspecs, mesh, rules))
        so = shd.distribute_tree(tree_map(torch.clone, o), mesh,
                                 shd.spec_shardings(topt_state_specs(tcfg, pspecs),
                                                    mesh, rules))
        bpl = shd.spec_shardings(tsteps.input_specs(tcfg, shape), mesh, rules)
        rng = np.random.default_rng(1)
        for step in range(3):
            tokens = torch.from_numpy(rng.integers(0, SCALE["vocab"], (2, 2, 64))
                                      .astype(np.int32))
            p, o, pm = plain(p, o, {"tokens": tokens}, step)
            sp, so, sm = sharded(sp, so, shd.distribute_tree({"tokens": tokens}, mesh, bpl),
                                 step)
            for key in ("loss", "gnorm"):
                assert type(sm[key]) is torch.Tensor
                np.testing.assert_allclose(float(sm[key]), float(pm[key]), rtol=1e-6)
        assert all(hasattr(x, "placements") for x in leaves(sp) + leaves(so))
        for (path, a), b in zip(flatten(sp), leaves(p)):
            scale = max(float(b.abs().max()), HP["peak_lr"])
            np.testing.assert_allclose(a.full_tensor().numpy(), b.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=path)
    finally:
        dist.destroy_process_group()


def test_remat_recompute_on_another_thread_keeps_the_mesh_scope():
    """On the card autograd runs the backward on its device thread, where a
    scope opened by the step's thread does not hold.  A checkpointed layer's
    recompute (with flash, which needs the scope to place its DTensors)
    run from a thread of its own gives the gradients of the same-thread
    backward, bit for bit (one gloo rank, a 1x1 mesh)."""
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import shardctx
    from repro_torch.runtime import sharding as shd

    _, tcfg = _configs()
    assert tcfg.remat
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        rules = shd.make_rules(tcfg, mesh, ShapeConfig("t", "train", 64, 2))
        pspecs = ttf.param_specs(tcfg)
        params, _ = train.init_state((pspecs, topt_state_specs(tcfg, pspecs)),
                                     torch.device("cpu"), 0, mesh=mesh,
                                     placements=(shd.spec_shardings(pspecs, mesh, rules),
                                                 shd.spec_shardings(topt_state_specs(
                                                     tcfg, pspecs), mesh, rules), None))
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, SCALE["vocab"], (2, 64)).astype(np.int32))
        flat = leaves(params)
        for x in flat:
            x.requires_grad_(True)
        grads = []
        for threaded in (False, True):
            with shardctx.scope(mesh, rules):
                batch = shd.distribute_tree({"tokens": tokens}, mesh,
                                            {"tokens": shd.pspec_placements(("data",), mesh)})
                loss, _ = ttf.train_loss(tcfg, params, batch, use_flash=True)
            out = {}

            def backward():
                try:
                    out["grads"] = torch.autograd.grad(loss, flat)
                except Exception as e:      # noqa: BLE001 -- reported below
                    out["error"] = e
            if threaded:
                worker = threading.Thread(target=backward)
                worker.start()
                worker.join()
            else:
                with shardctx.scope(mesh, rules):
                    backward()
            assert "error" not in out, out.get("error")
            grads.append([g.full_tensor() for g in out["grads"]])
        for a, b in zip(*grads):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# the step on every family: GQA, MoE, hybrid (meta tokens, a window), SSM,
# a window alone, the image prefix, the four codebooks, and gemma3's GeGLU,
# scaled embeddings and two rope thetas over a local and a global layer
STEP_ARCHS = ARCHS + ("hymba-1.5b", "mamba2-370m", "h2o-danube-3-4b", "phi-3-vision-4.2b",
                      "musicgen-large", "gemma3-27b")
# the reduced config cycles its local layers into both of SCALE's 2 layers
# and sets one rope theta: give it back a global layer and its own theta
STEP_REPLACE = {"gemma3-27b": dict(windows=(32, 0), rope_theta=1e6)}


def _step_batch(cfg, rng, m=2, b=2, t=64):
    """A batch [m, b, ...] as the port's pipeline lays it out: [.., K, T]
    tokens for K codebooks, and for a vision config t - image_tokens text
    tokens after as many image embeddings N(0, 0.02)."""
    t_text = t - (cfg.image_tokens if cfg.frontend == "vision" else 0)
    lead = (m, b) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    batch = {"tokens": rng.integers(0, cfg.vocab, lead + (t_text,)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["image_embeds"] = rng.normal(0, 0.02, (m, b, cfg.image_tokens, cfg.d_model)
                                           ).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=STEP_ARCHS)
def three_steps(request):
    """Three steps of the JAX package's jitted no-mesh step and of the
    port's, from the same weights, on the same batches, two microbatches."""
    jcfg, tcfg = _configs(request.param, train_microbatches=2,
                          **STEP_REPLACE.get(request.param, {}))
    return request.param, _three_steps(jcfg, tcfg)


def _three_steps(jcfg, tcfg):
    """[(JAX params, JAX state, JAX metrics, port metrics, (port params, port
    state))] after each of three steps from the same weights and batches."""
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
        batch = _step_batch(tcfg, rng)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(step, jnp.int32))
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in batch.items()}, step)
        out.append((_np(jp), _np(jo), {k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()},
                    jax.tree.map(lambda x: x.clone(), (tp, to))))
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
def test_train_steps_match_jax(three_steps, step):
    """loss, gnorm and lr within 1e-6; every moment leaf, and for Yi-6B,
    mixtral and gemma3 (moments 1.14e-6, parameters 5.33e-6 at most) every
    parameter leaf, within 2e-5 of the leaf's largest entry.
    The gradients agree to ~1e-6 (sum order); AdamW's early updates are ~lr
    * sign(g), so an entry whose gradient is near eps can move by a
    different fraction of lr (measured: 6.1e-6 at a norm scale, 1.2e-6 in
    the moments).  The other families hold more such entries: zero-init
    norm scales and conv biases (their largest entry is ~lr after a step)
    and embedding rows seen once; there a parameter reads up to 3.6e-5 of
    its leaf's largest entry (hymba-1.5b, mamba2-370m, phi-3-vision-4.2b)
    while every moment reads at most 3.2e-6.  Their parameters are held
    through the moments, which carry the gradients, and AdamW's arithmetic,
    which ``tests/test_torch_optim.py::test_adamw_matches_jax`` holds."""
    arch, steps = three_steps
    jp, jo, jm, tm, (tp, to) = steps[step]
    for key in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-6, err_msg=key)
    assert tm["step"] == jm["step"] == step + 1
    if arch in ARCHS + ("gemma3-27b",):
        _assert_tree_close(jp, tp, 2e-5)
    _assert_tree_close(jo["mu"], to["mu"], 2e-5)
    _assert_tree_close(jo["nu"], to["nu"], 2e-5)
    assert int(to["count"]) == int(jo["count"]) == step + 1


# deepseek-v3-671b's reduced config at SCALE's widths with its MoE layer (two
# dense MLA layers, then a sigmoid-routed MoE layer with a shared expert;
# MTP) under its own Adafactor: {case: (grad_accum_dtype, opt_dtype, slot
# tolerance, parameter tolerance)}, each relative to the leaf's largest entry
ADAFACTOR_CASES = {"fp32 accumulation": ("float32", "float32", 2e-5, 2e-5),
                   "bf16 accumulation": ("bfloat16", "float32", 4e-3, 4e-3),
                   "bf16 accumulation and slots": ("bfloat16", "bfloat16", 8e-3, 4e-3)}


# Yi-6B's and deepseek-7b's reduced configs at SCALE's widths under the
# reference's Adafactor (``optimizer="adafactor"``, the only knob changed:
# fp32 state and fp32 accumulation as published), as chip_smoke's phase 37
# trains them whole; held at ADAFACTOR_CASES["fp32 accumulation"]
ADAFACTOR_DENSE = ("yi-6b", "deepseek-7b")


@pytest.fixture(scope="module", params=list(ADAFACTOR_CASES) + list(ADAFACTOR_DENSE))
def adafactor_steps(request):
    """``_three_steps`` of deepseek-v3-671b at 3 layers, two microbatches, in
    one of ``ADAFACTOR_CASES``' dtypes; or of one of ``ADAFACTOR_DENSE``
    under Adafactor, two microbatches, its published dtypes."""
    if request.param in ADAFACTOR_DENSE:
        jcfg, tcfg = _configs(request.param, train_microbatches=2, optimizer="adafactor")
        assert (tcfg.opt_dtype, tcfg.grad_accum_dtype) == ("float32", "float32")
        assert tcfg.mla is None and tcfg.moe is None and jcfg.optimizer == "adafactor"
        return "fp32 accumulation", _three_steps(jcfg, tcfg)
    accum, state = ADAFACTOR_CASES[request.param][:2]
    jcfg, tcfg = _configs("deepseek-v3-671b", dict(SCALE, n_layers=3), train_microbatches=2,
                          grad_accum_dtype=accum, opt_dtype=state)
    assert tcfg.optimizer == "adafactor" and tcfg.mla is not None and tcfg.mtp_depth == 1
    assert tcfg.layer_moe == (False, False, True) and tcfg.layer_windows == (0, 0, 0)
    return request.param, _three_steps(jcfg, tcfg)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_adafactor_steps_match_jax(adafactor_steps, step):
    """loss and gnorm within 1e-5, lr within 1e-6; every Adafactor slot and
    every parameter leaf within the case's tolerance of the leaf's largest
    entry.  With fp32 accumulation slots read up to 2.70e-6 and parameters
    8.36e-6 (sum order), so 2e-5.  The config's bf16 accumulator rounds
    each microbatch's sum to bf16 in both packages, and an fp32 gradient
    ~1e-6 apart can round to the neighbouring bf16 value: slots read
    1.06e-3 and parameters 1.79e-3, held to one bf16 ulp (2^-8 ~ 3.9e-3).
    bf16 slots round once more on the way out: slots 4.37e-3, held to two
    ulps, parameters 2.51e-3.  Loss and gnorm read at most 1.6e-7 and
    1.4e-6.  Yi-6B's and deepseek-7b's dense configs (``ADAFACTOR_DENSE``)
    are held at the fp32 case's limits."""
    case, steps = adafactor_steps
    _, _, slot_tol, param_tol = ADAFACTOR_CASES[case]
    jp, jo, jm, tm, (tp, to) = steps[step]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
    assert tm["step"] == jm["step"] == step + 1
    _assert_tree_close(jp, tp, param_tol)
    _assert_tree_close(jo["slots"], to["slots"], slot_tol)
    assert int(to["count"]) == int(jo["count"]) == step + 1


@pytest.mark.parametrize("n_micro", [2, 16])
def test_bf16_accumulation_is_the_jax_packages_bit_for_bit(n_micro):
    """``steps._accumulate`` in bf16 over ``n_micro`` microbatches' fp32
    gradients, then the mean's division, as the port's ``make_train_step``
    runs them, against the JAX package's accumulation (its scan body ``a +
    b.astype(acc_dt)`` from bf16 zeros, then ``g / n_micro``, jitted) on
    the same gradients, spread over four decades: every bf16 accumulator
    entry is bit-identical."""
    rng = np.random.default_rng(n_micro)
    shapes = [(64, 48), (3, 40, 24), (129,)]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1, size=s)).astype(np.float32)
              for s in shapes] for _ in range(n_micro)]

    def jaccumulate(zeros, stacked):
        def body(gacc, g):
            return jax.tree.map(lambda a, b: a + b.astype(jnp.bfloat16), gacc, g), ()
        acc, _ = jax.lax.scan(body, zeros, stacked)
        return jax.tree.map(lambda g: g / n_micro, acc)
    want = jax.jit(jaccumulate)([jnp.zeros(s, jnp.bfloat16) for s in shapes],
                                [jnp.stack([g[i] for g in grads]) for i in range(len(shapes))])
    acc = None
    for g in grads:
        acc = tsteps._accumulate(acc, [torch.from_numpy(x) for x in g], torch.bfloat16)
    for a in acc:
        a.div_(n_micro)
    for a, w in zip(acc, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))


class _Ops(TorchDispatchMode):
    """Records the aten ops dispatched under it."""
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n_micro", [2, 8])
def test_widening_accumulation_adds_bf16_gradients_as_they_are_bit_for_bit(n_micro):
    """``steps._accumulate`` of ``n_micro`` microbatches' bf16 gradients into
    fp32 accumulators, spread over four decades: every entry bit-identical
    to adding each gradient's fp32 cast (bf16 widens to fp32 exactly, so
    the sum is one fp32 rounding either way), and after the first
    microbatch's copy no cast is made: the adds take the bf16 gradient as
    it is (an ``aten.add_`` each, no ``_to_copy``)."""
    rng = np.random.default_rng(30 + n_micro)
    shapes = [(64, 48), (3, 40, 24), (129,)]
    grads = [[torch.from_numpy((rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1, size=s))
                               .astype(np.float32)).bfloat16() for s in shapes]
             for _ in range(n_micro)]
    want = [g.float() for g in grads[0]]
    for gs in grads[1:]:
        for a, g in zip(want, gs):
            a.add_(g.to(torch.float32))
    acc = tsteps._accumulate(None, grads[0], torch.float32)
    with _Ops() as seen:
        for gs in grads[1:]:
            acc = tsteps._accumulate(acc, gs, torch.float32)
    assert torch.ops.aten._to_copy not in seen.ops
    assert seen.ops.count(torch.ops.aten.add_) == len(shapes) * (n_micro - 1)
    for a, w in zip(acc, want):
        assert a.dtype == torch.float32
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))


def _two_pass_step(cfg, hp):
    """The train step as the port ran it before each leaf's gradient was
    taken into its accumulator as made, kept here to hold the hooked step
    to: each microbatch's whole gradient tree from ``torch.autograd.grad``,
    then added by ``steps._accumulate``, the mean's division, the
    optimizer."""
    n_micro, acc_dt = cfg.train_microbatches, getattr(torch, cfg.grad_accum_dtype)

    def micro_grads(params, flat, mb):
        loss, _ = ttf.train_loss(cfg, params, mb)
        return loss.detach(), list(torch.autograd.grad(loss, flat))

    def step_fn(params, opt_state, batch, step):
        lr = tcosine_schedule(step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                              total=hp.total_steps)
        flat = leaves(params)
        for x in flat:
            x.requires_grad_(True)
        try:
            if n_micro == 1:
                loss, grads = micro_grads(params, flat, {k: v[0] for k, v in batch.items()})
            else:
                grads, lsum = None, None
                for m in range(n_micro):
                    loss, g = micro_grads(params, flat, {k: v[m] for k, v in batch.items()})
                    grads = tsteps._accumulate(grads, g, acc_dt)
                    lsum = loss.float() if lsum is None else lsum + loss
                loss = lsum / n_micro
                for a in grads:
                    a.div_(n_micro)
        finally:
            for x in flat:
                x.requires_grad_(False)
        params, opt_state, gnorm = topt_update(cfg, unflatten(params, grads), opt_state,
                                               params, lr)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}
    return step_fn


@pytest.mark.parametrize("n_micro", [1, 2, 16])
@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_gradients_taken_as_made_are_the_two_pass_accumulation_bit_for_bit(monkeypatch,
                                                                          accum, n_micro):
    """``make_train_step`` takes each leaf's gradient into its accumulator
    from a hook as autograd makes it; two steps of deepseek-v3-671b's
    reduced config at 3 layers (a stacked stage of 2 dense MLA layers, a
    one-layer MoE stage, MTP; Adafactor with bf16 state) over ``n_micro``
    microbatches leave the parameters, the state, the loss and the gnorm
    bit-identical to the two-pass step's (``_two_pass_step``), with fp32 or
    bf16 accumulators; ``_accumulate`` is called once a leaf a microbatch
    (none with one microbatch), and no leaf keeps a ``.grad``."""
    _, cfg = _configs("deepseek-v3-671b", dict(SCALE, n_layers=3), train_microbatches=n_micro,
                      grad_accum_dtype=accum, opt_dtype="bfloat16")
    assert cfg.layer_moe == (False, False, True) and cfg.mtp_depth == 1
    pspecs = ttf.param_specs(cfg)
    state = train.init_state((pspecs, topt_state_specs(cfg, pspecs)), torch.device("cpu"), 3)
    assert any(x.shape[0] == 2 for x in leaves(state[0]["stages"]))
    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(v) for k, v in _step_batch(cfg, rng, m=n_micro, b=1,
                                                                t=24).items()}
               for _ in range(2)]
    calls = []
    accumulate = tsteps._accumulate

    def counted(acc, grads, dtype):
        calls.append(len(grads))
        return accumulate(acc, grads, dtype)
    runs = []
    for make in (tsteps.make_train_step, _two_pass_step):
        p, o = tree_map(torch.clone, state)
        step = make(cfg, tsteps.TrainHParams(**HP))
        if make is tsteps.make_train_step:
            monkeypatch.setattr(tsteps, "_accumulate", counted)
        metrics = []
        for i, batch in enumerate(batches):
            p, o, m = step(p, o, batch, i)
            metrics.append((m["loss"].clone(), m["gnorm"].clone()))
        monkeypatch.setattr(tsteps, "_accumulate", accumulate)
        runs.append((p, o, metrics))
    n_leaves = len(leaves(state[0]))
    assert calls == ([] if n_micro == 1 else [1] * (2 * n_micro * n_leaves))
    (p_a, o_a, m_a), (p_b, o_b, m_b) = runs
    assert all(x.grad is None for x in leaves(p_a))
    for (la, ga), (lb, gb) in zip(m_a, m_b):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
    for (path, a), b in zip(flatten((p_a, o_a)), leaves((p_b, o_b))):
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), path


ADAFACTOR_CUT_SLICE = 1000


@pytest.fixture(scope="module", params=list(ADAFACTOR_CASES))
def adafactor_moe_cut_steps(request):
    """``_three_steps`` of chip_smoke's deepseek-v3-671b cut at ``SCALE``
    widths: one MoE layer (``moe_layers=(True,)``) and the MTP module, two
    microbatches, in one of ``ADAFACTOR_CASES``' dtypes, Adafactor walking
    each factored leaf with lead axes past ``ADAFACTOR_CUT_SLICE`` entries
    in slices (the stacked [1, 4, 128, 64] expert leaves, an expert a
    slice)."""
    accum, state = ADAFACTOR_CASES[request.param][:2]
    jcfg, tcfg = _configs("deepseek-v3-671b", dict(SCALE, n_layers=1), train_microbatches=2,
                          grad_accum_dtype=accum, opt_dtype=state, moe_layers=(True,))
    assert tcfg.optimizer == "adafactor" and tcfg.mla is not None and tcfg.mtp_depth == 1
    assert tcfg.layer_moe == (True,) and jcfg.layer_moe == (True,)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(topt, "ADAFACTOR_SLICE", ADAFACTOR_CUT_SLICE)
        w_in = ttf.param_specs(tcfg)["stages"][0]["u0"]["ffn"]["w_in"]
        assert topt._slice_rows(torch.empty(w_in.shape)) == 1
        return request.param, _three_steps(jcfg, tcfg)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_adafactor_steps_of_the_moe_cut_match_jax(adafactor_moe_cut_steps, step):
    """The cut that phase 36 trains (its first MoE layer with MTP) against
    the JAX package, with the expert leaves' Adafactor in slices, at
    ``test_adafactor_steps_match_jax``'s tolerances: loss and gnorm within
    1e-5, lr within 1e-6, slots and parameters within the case's."""
    case, steps = adafactor_moe_cut_steps
    _, _, slot_tol, param_tol = ADAFACTOR_CASES[case]
    jp, jo, jm, tm, (tp, to) = steps[step]
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
    _assert_tree_close(jp, tp, param_tol)
    _assert_tree_close(jo["slots"], to["slots"], slot_tol)
    assert int(to["count"]) == int(jo["count"]) == step + 1


def test_deepseek_v3_moe_cut_has_14_05_b_parameters():
    """chip_smoke's deepseek-v3-671b cut (``depth_cut(..., 1,
    moe_layers=(True,))``) counted from its ``ParamSpec``s, nothing drawn,
    against a hand count: the embedding and the untied head, the final
    norm, one MoE layer (MLA: q rank 1536, kv rank 512, qk 128 + 64, v 128
    over 128 heads; a router over 256 experts, 256 gated experts of d_ff
    2048 and one shared; two norms) and the MTP module (its projection of
    2 x 7168, three norms, and a dense MLA layer of d_ff 18432)."""
    cs = _chip_smoke()
    whole, cut = cs.depth_cut("deepseek-v3-671b", 1, moe_layers=(True,))
    assert whole.layer_moe[3] and not whole.layer_moe[2] and cut.layer_moe == (True,)
    d, v, h, e, f = 7168, 129280, 128, 256, 2048
    mla = (d * 1536 + 1536 + 1536 * h * 192 + d * (512 + 64) + 512 + 512 * h * (128 + 128)
           + h * 128 * d)
    moe_layer = mla + 2 * d + d * e + 3 * e * d * f + 3 * d * f
    mtp = 2 * d * d + 3 * d + mla + 2 * d + 3 * d * 18432
    want = 2 * v * d + d + moe_layer + mtp
    assert (moe_layer, mtp) == (11_507_286_016, 686_265_344)
    assert cs.param_count(cut) == want == 14_046_916_608
    assert round(want / 1e9, 2) == 14.05


def _adafactor_entries(shape) -> int:
    """Adafactor's state entries for a leaf of ``shape``: its row and column
    factors (the shape less its last dim; less its second to last) where it
    has two dims or more, else a second moment of its own shape."""
    if len(shape) < 2:
        return int(np.prod(shape))
    return int(np.prod(shape[:-1])) + int(np.prod(shape[:-2] + shape[-1:]))


@pytest.mark.parametrize("arch, counts", [
    ("yi-6b", (6_061_035_520, 61_498_433)), ("deepseek-7b", (6_910_365_696, 64_622_141))])
def test_dense_models_trained_whole_have_their_published_counts(arch, counts):
    """Yi-6B's and deepseek-7b's parameters and their Adafactor state
    entries, counted from ``ParamSpec``s with nothing allocated, against a
    hand count: the embedding and the untied head, the final norm, and
    ``n_layers`` stacked layers of GQA (or MHA) attention, a SwiGLU MLP and
    two norm scales; Adafactor keeps a row and a column factor for each
    leaf of two dims or more (a stacked norm's [L, d] too) and a second
    moment for the final norm, and one step count; and phase 37's memory
    plan (``chip_smoke._dense_whole_reckoning``) from those specs."""
    cs = _chip_smoke()
    cfg = cs.get_config(arch).replace(optimizer="adafactor")
    L, d, h, kv, dh, f, v = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.vocab)
    layer = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * f + 2 * d
    params = 2 * v * d + d + L * layer
    attn = (d * h + d * dh) + 2 * (d * kv + d * dh) + (h * dh + h * d)
    state = d + 2 * (v + d) + L * (attn + 3 * (d + f)) + 2 * (L + d) + 1
    pspecs = ttf.param_specs(cfg)
    ospecs = topt_state_specs(cfg, pspecs)
    got_state = sum(int(np.prod(s.shape)) for s in leaves(ospecs))
    assert got_state == sum(_adafactor_entries(s.shape) for s in leaves(pspecs)) + 1
    assert (cs.param_count(cfg), got_state) == (params, state) == counts
    assert cfg.n_params() == params
    assert (round(params / 1e9, 3), round(state / 1e9, 4)) == \
        {"yi-6b": (6.061, 0.0615), "deepseek-7b": (6.910, 0.0646)}[arch]
    # phase 37's memory plan from the same specs: bf16 parameters, the fp32
    # accumulator, Adafactor's fp32 state, the stacked layers' bf16
    # gradients and the largest leaf's stack (``ffn/wg``), in GB; the sum
    # with activations and logits at the low end of the reckoned peak
    parts = cs._dense_whole_reckoning("test", cfg, 4096)
    assert [round(b / 1e9, 2) for b in list(parts.values())[:5]] == {
        "yi-6b": [12.12, 24.24, 0.25, 11.07, 2.89],
        "deepseek-7b": [13.82, 27.64, 0.26, 12.14, 2.71]}[arch]
    lo, hi = cs.DENSE_WHOLE_RECKONED_GB[arch]
    assert lo - 1 < sum(parts.values()) / 1e9 < hi


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ["hymba-1.5b", "musicgen-large", "phi-3-vision-4.2b",
                                  "gemma3-27b", "mixtral-8x7b"])
def test_a_flash_step_calls_k2_as_chip_smoke_counts_its_launches(monkeypatch, arch):
    """One flash train step of the reduced config (2 microbatches, per-layer
    remat) calls K2 (``ops.flash_attention``) ``attention_layers x micro x
    2`` times, the checkpoint recomputing each layer, and K2 bwd (its plain
    version here) ``x 1``: the counts ``chip_smoke.train_launches`` gates
    the card's train runs on."""
    cs = _chip_smoke()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    counts = {"fwd": 0, "bwd": 0}

    def counted(key, fn):
        def run(*args, **kw):
            counts[key] += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(ops, "flash_attention", counted("fwd", ops.flash_attention))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        counted("bwd", fa.flash_attention_bwd_plain))
    _, cfg = _configs(arch, train_microbatches=2, **STEP_REPLACE.get(arch, {}))
    assert cfg.remat and cs.attention_layers(cfg) == cfg.n_layers == 2
    step = tsteps.make_train_step(cfg, tsteps.TrainHParams(**HP), use_flash=True)
    pspecs = ttf.param_specs(cfg)
    params, opt = train.init_state((pspecs, topt_state_specs(cfg, pspecs)), "cpu", 0)
    batch = _step_batch(cfg, np.random.default_rng(0))
    step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert counts == cs.train_launches(cfg, 1) == {"fwd": 2 * 2 * 2, "bwd": 2 * 2}


def test_model_flops_counts_active_experts_mla_and_mtp():
    """``chip_smoke.model_flops`` of the reduced mixtral-8x7b and
    deepseek-v3-671b configs (d_model 128, 4 heads, vocab 512) at 2 x 64
    positions, against a hand count: 6 x the matmul parameters a position
    (an MoE layer's routed experts at top_k / n_experts, its router and
    shared expert whole; norm scales ride along as ``n_params`` counts
    them: ln1, ln2 and the final norm, not MLA's two latent norms), 3 x the
    forward's attention over the live pairs (2 flops a multiply-add, a
    qk-wide dot product and a v-wide update a pair and head), and for MTP
    6 x its module's parameters and the head's over the 63 positions it
    predicts from, plus 3 x its block's attention."""
    cs = _chip_smoke()
    b, t, d, h, vocab = 2, 64, 128, 4, 512
    head = vocab * d
    # mixtral: 2 layers, GQA (2 kv heads, head dim 32), window 32, top-2 of
    # 4 experts (d_ff 64)
    cfg = reduced_config("mixtral-8x7b")
    assert (cfg.n_layers, cfg.layer_windows, cfg.moe.n_experts, cfg.moe.top_k) == \
        (2, (32, 32), 4, 2)
    gqa = d * h * 32 + 2 * d * 2 * 32 + h * 32 * d
    layer = gqa + d * 4 + 2 * 3 * d * 64 + 2 * d
    live = sum(min(i + 1, 32) for i in range(t))
    want = 6 * (2 * layer + d + head) * t * b + 2 * 3 * 2 * b * h * live * (32 + 32)
    assert cs.model_flops(cfg, t, b) == want == 212_140_032
    # deepseek-v3: 2 dense MLA layers (d_ff 256) and an MoE one (top-2 of 4,
    # d_ff 64, one shared expert); MLA q rank 64, kv rank 32, qk 16 + 16, v 32
    cfg = reduced_config("deepseek-v3-671b")
    assert (cfg.n_layers, cfg.layer_moe, cfg.mtp_depth) == (3, (False, False, True), 1)
    mla = d * 64 + 64 * h * 32 + d * (32 + 16) + 32 * h * (16 + 32) + h * 32 * d
    dense = mla + 3 * d * 256 + 2 * d
    routed = mla + d * 4 + 2 * 3 * d * 64 + 3 * d * 64 + 2 * d
    mtp = 2 * d * d + 3 * d + (mla + 64 + 32) + 3 * d * 256 + 2 * d
    causal = t * (t + 1) // 2
    want = (6 * (2 * dense + routed + d + head) * t * b
            + 3 * 3 * 2 * b * h * causal * (32 + 32)
            + 6 * (mtp + head) * (t - 1) * b
            + 3 * 2 * b * h * ((t - 1) * t // 2) * (32 + 32))
    assert cs.mtp_params(cfg) == mtp
    assert cs.model_flops(cfg, t, b) == want == 571_456_896


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


def test_launcher_failure_injection_recovers(tmp_path, capsys):
    losses = train.main(["--steps", "12", "--ckpt-every", "4",
                         "--inject-failure", "6", "--use-flash",
                         "--ckpt-dir", str(tmp_path / "ck"), *ARGS])
    # one rank: the plain step on a 1x1 mesh, re-meshed onto the same mesh
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1} step=plain (one rank)" in out
    assert "resumed at step 4 on 1 device(s), mesh={'data': 1, 'model': 1}" in out
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
