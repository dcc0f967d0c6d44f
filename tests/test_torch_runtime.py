"""The port's training runtime against the JAX package's: the data
pipeline (bit-identical batches, also across state/restore), checkpoints
(the port's own round trip, keep-last-k, torn and corrupt fallbacks,
checkpoints crossing between the packages both ways, and a train step
resumed from an async checkpoint bit for bit), the optimizer state carried
from JAX, and the straggler detector."""
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import reduced_config as jreduced_config
from repro.models import transformer as jtf
from repro.models.layers import init_param_tree as jinit
from repro.models.layers import spec_tree_to_sds
from repro.runtime import fault as jfault
from repro.runtime import optim as jopt
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime.pipeline import DataPipeline as JDataPipeline
from repro.runtime.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.configs import ShapeConfig, reduced_config
from repro_torch.launch import train
from repro_torch.models import transformer as ttf
from repro_torch.runtime import checkpoint as ckpt_module
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.optim import opt_state_specs
from repro_torch.runtime.pipeline import DataPipeline, PipelineConfig
from repro_torch.runtime.tree import flatten
from repro_torch.weights import opt_state_from_jax, params_from_jax

ARCH = "yi-6b"


def _cfgs(**kw):
    return (jreduced_config(ARCH).replace(**kw), reduced_config(ARCH).replace(**kw))


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("micro,batch,seq", [(1, 2, 64), (2, 4, 96)])
def test_pipeline_batches_match_jax_bit_for_bit(micro, batch, seq):
    jcfg, tcfg = _cfgs(train_microbatches=micro)
    pcfg = dict(seed=3, mean_doc_len=40)
    jpipe = JDataPipeline(jcfg, JShapeConfig("t", "train", seq, batch),
                          JPipelineConfig(**pcfg))
    tpipe = DataPipeline(tcfg, ShapeConfig("t", "train", seq, batch), PipelineConfig(**pcfg))
    for _ in range(3):
        want, got = next(jpipe), next(tpipe)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    state = tpipe.state()
    assert json.loads(json.dumps(state)) == json.loads(json.dumps(jpipe.state()))
    later = [next(tpipe)["tokens"].numpy() for _ in range(2)]
    # restore the port's cursor into both: the same batches come again
    jpipe.restore(state)
    tpipe.restore(state)
    for want in later:
        np.testing.assert_array_equal(next(tpipe)["tokens"].numpy(), want)
        np.testing.assert_array_equal(np.asarray(next(jpipe)["tokens"]), want)


def test_prefetching_pipeline_resumes_exactly():
    """With the prefetch thread, state() is the cursor after the last batch
    handed out, so a restored pipeline repeats no batch and skips none, nor
    does one stopped and started again."""
    _, tcfg = _cfgs(train_microbatches=2)
    shape = ShapeConfig("t", "train", 32, 4)
    pcfg = PipelineConfig(seed=5, prefetch=3, mean_doc_len=20)
    sync = DataPipeline(tcfg, shape, pcfg)
    want = [next(sync)["tokens"] for _ in range(6)]
    pipe = DataPipeline(tcfg, shape, pcfg).start()
    try:
        got = [next(pipe)["tokens"] for _ in range(3)]
        state = pipe.state()
        next(pipe)
        pipe.restore(state)
        got.append(next(pipe)["tokens"])
        pipe.stop()                    # drops the batches built ahead
        pipe.start()
        got += [next(pipe)["tokens"] for _ in range(2)]
    finally:
        pipe.stop()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -------------------------------------------------------------- checkpoint
def _tparams(seed=0, dtype="float32"):
    _, tcfg = _cfgs(param_dtype=dtype)
    jcfg = jreduced_config(ARCH).replace(param_dtype=dtype)
    jp = jinit(jtf.param_specs(jcfg), jax.random.PRNGKey(seed))
    return tcfg, jcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def test_checkpoint_round_trip_keeps_dtypes_and_extra(tmp_path):
    tcfg, _, _, params = _tparams(dtype="bfloat16")
    opt = {"count": torch.tensor(7, dtype=torch.int32)}
    ck = CheckpointManager(tmp_path, keep=3, async_save=False)
    ck.save(3, {"params": params, "opt": opt}, extra={"pipeline": {"step": 3}})
    target = {"params": ttf.param_specs(tcfg), "opt": opt}
    restored, manifest = ck.restore_latest(target)
    assert manifest["step"] == 3 and manifest["extra"] == {"pipeline": {"step": 3}}
    for (path, a), (_, b) in zip(flatten(restored["params"]), flatten(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), path
    assert restored["opt"]["count"].dtype == torch.int32
    assert restored["opt"]["count"].shape == () and int(restored["opt"]["count"]) == 7


def test_checkpoint_keeps_the_last_k_and_bounds_by_max_step(tmp_path):
    ck = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, {"x": torch.full((3,), float(step))})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    tree, manifest = ck.restore_latest({"x": torch.zeros(3)}, max_step=3)
    assert manifest["step"] == 3 and torch.equal(tree["x"], torch.full((3,), 3.0))


def test_async_checkpoint_holds_the_tree_as_it_was_at_save(tmp_path):
    ck = CheckpointManager(tmp_path, keep=3, async_save=True)
    gate = threading.Event()
    ck._pool.submit(gate.wait)                   # the write queues behind this
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "count": torch.tensor(3, dtype=torch.int32)}
    before = {k: v.clone() for k, v in tree.items()}
    ck.save(1, tree)
    tree["w"].mul_(-2.0).add_(1.0)               # the next step's in-place update
    tree["count"].add_(1)
    gate.set()
    ck.wait()
    restored, manifest = ck.restore_latest({k: torch.zeros_like(v) for k, v in tree.items()})
    assert manifest["step"] == 1
    for k, v in before.items():
        assert torch.equal(restored[k], v), k


@pytest.mark.parametrize("fault", ["torn", "corrupt"])
def test_checkpoint_falls_back_past_torn_or_corrupt(tmp_path, fault):
    ck = CheckpointManager(tmp_path, keep=3, async_save=False)
    ck.save(1, {"x": torch.ones(4)})
    ck.save(2, {"x": torch.full((4,), 2.0)})
    newest = tmp_path / "step_00000002"
    if fault == "torn":
        (newest / "COMMITTED").unlink()
    else:
        manifest = json.loads((newest / "manifest.json").read_text())
        manifest["leaves"]["x"]["sha256"] = "0" * 64
        (newest / "manifest.json").write_text(json.dumps(manifest))
    tree, manifest = ck.restore_latest({"x": torch.zeros(4)})
    assert manifest["step"] == 1 and torch.equal(tree["x"], torch.ones(4))


def test_npz_members_read_as_np_load_reads_them(tmp_path):
    """``checkpoint._npz_arrays`` gives the keys, dtypes, shapes and values
    ``np.load`` gives for what ``np.savez`` writes (members of several
    dims, a 0-d and an empty one, keys with "/"), read straight from the
    file; a compressed npz is refused, and ``restore_latest`` falls back
    past it."""
    rng = np.random.default_rng(7)
    arrays = {"stages/0/u0/w": rng.normal(size=(3, 5, 7)).astype(np.float32),
              "count": np.array(9, np.int32), "empty": np.zeros((0, 4), np.float32),
              "head": rng.integers(0, 100, (64,)).astype(np.int64)}
    np.savez(tmp_path / "a.npz", **arrays)
    with np.load(tmp_path / "a.npz") as z:
        want = {k: z[k] for k in z.files}
    got = dict(ckpt_module._npz_arrays(tmp_path / "a.npz"))
    assert list(got) == list(want) == list(arrays)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    ck = CheckpointManager(tmp_path / "ck", async_save=False)
    ck.save(1, {"x": torch.ones(4)})
    ck.save(2, {"x": torch.full((4,), 2.0)})
    newest = tmp_path / "ck" / "step_00000002" / "arrays.npz"
    np.savez_compressed(newest, x=np.full((4,), 2.0, np.float32))
    with pytest.raises(ValueError, match="compressed"):
        dict(ckpt_module._npz_arrays(newest))
    tree, manifest = ck.restore_latest({"x": torch.zeros(4)})
    assert manifest["step"] == 1 and torch.equal(tree["x"], torch.ones(4))


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    tcfg, jcfg, jparams, params = _tparams(seed=1)
    opt = opt_state_from_jax(tcfg, jax.tree.map(np.asarray, jinit(
        jopt.opt_state_specs(jcfg, jtf.param_specs(jcfg)), jax.random.PRNGKey(0))))
    opt["mu"]["head"].normal_(generator=torch.Generator().manual_seed(0))
    opt["count"].fill_(5)
    CheckpointManager(tmp_path, async_save=False).save(
        5, {"params": params, "opt": opt}, extra={"pipeline": {"step": 5}})
    pspecs = jtf.param_specs(jcfg)
    target = {"params": spec_tree_to_sds(pspecs),
              "opt": spec_tree_to_sds(jopt.opt_state_specs(jcfg, pspecs))}
    restored, manifest = JCheckpointManager(tmp_path).restore_latest(target)
    assert manifest["step"] == 5
    for (path, t), (_, j) in zip(flatten({"params": params, "opt": opt}),
                                 flatten(jax.tree.map(np.asarray, restored))):
        np.testing.assert_array_equal(j, t.numpy(), err_msg=path)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tcfg, jcfg, jparams, _ = _tparams(seed=2, dtype="bfloat16")
    jopt_state = jinit(jopt.opt_state_specs(jcfg, jtf.param_specs(jcfg)),
                       jax.random.PRNGKey(0))
    JCheckpointManager(tmp_path, async_save=False).save(
        9, {"params": jparams, "opt": jopt_state}, extra={"pipeline": {"step": 9}})
    pspecs = ttf.param_specs(tcfg)
    restored, manifest = CheckpointManager(tmp_path).restore_latest(
        {"params": pspecs, "opt": opt_state_specs(tcfg, pspecs)})
    assert manifest["step"] == 9 and manifest["extra"]["pipeline"] == {"step": 9}
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    for (path, a), (_, b) in zip(flatten(restored["params"]), flatten(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), path
    assert int(restored["opt"]["count"]) == 0


def test_step_resumed_from_an_async_checkpoint_is_the_uninterrupted_step(tmp_path):
    """Yi-6B's reduced config under Adafactor with bf16 params (fp32 state
    and accumulation, 2 microbatches), driven as ``launch/train.py`` drives
    it: two steps, an async ``CheckpointManager`` save of params and state
    with the pipeline's cursor, a third step while the write waits in the
    queue (the snapshot must be the state at save time), then a restore
    through ``train._restore`` (checksums verified) and the third step
    again from the restored state and cursor: its loss and gnorm equal the
    uninterrupted step's, and every parameter and Adafactor slot is
    ``torch.equal`` to it."""
    _, cfg = _cfgs(optimizer="adafactor", param_dtype="bfloat16",
                   compute_dtype="bfloat16", train_microbatches=2)
    assert (cfg.opt_dtype, cfg.grad_accum_dtype) == ("float32", "float32")
    cpu = torch.device("cpu")
    shape = ShapeConfig("t", "train", 64, 4)
    step_fn, specs, placements = train.build(cfg, shape, None, train.TrainHParams(
        peak_lr=1e-3, warmup=2, total_steps=6))
    params, opt = train.init_state(specs, cpu, 4)
    pipe = DataPipeline(cfg, shape, PipelineConfig(seed=6, mean_doc_len=40), device=cpu)
    ckpt = CheckpointManager(tmp_path, keep=1)
    gate = threading.Event()
    try:
        pipe.start()
        for step in range(2):
            params, opt, _, _ = train.run_step(step_fn, params, opt, next(pipe), step, cpu)
        ckpt._pool.submit(gate.wait)              # the write queues behind this
        ckpt.save(2, {"params": params, "opt": opt}, extra={"pipeline": pipe.state()})
        params, opt, want, _ = train.run_step(step_fn, params, opt, next(pipe), 2, cpu)
        held = [(path, x.clone()) for path, x in flatten({"params": params, "opt": opt})]
        gate.set()
        ckpt.wait()
        del params, opt
        params, opt, step = train._restore(ckpt, specs, placements, None, pipe, cpu)
        assert step == 2 and ckpt.all_steps() == [2]
        params, opt, got, _ = train.run_step(step_fn, params, opt, next(pipe), step, cpu)
    finally:
        gate.set()
        pipe.stop()
    assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["gnorm"], want["gnorm"])
    resumed = flatten({"params": params, "opt": opt})
    assert [p for p, _ in resumed] == [p for p, _ in held]
    assert any(p.startswith("opt/slots/") and p.endswith("/vr") for p, _ in held)
    for (path, a), (_, b) in zip(resumed, held):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert params["head"].dtype == torch.bfloat16


# ------------------------------------------------ optimizer state from JAX
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_from_jax_round_trips(optimizer):
    jcfg, tcfg = _cfgs(optimizer=optimizer)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.asarray(a).dtype),
                        jinit(jopt.opt_state_specs(jcfg, jtf.param_specs(jcfg)),
                              jax.random.PRNGKey(0)))
    got = opt_state_from_jax(tcfg, tree)
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    tflat = flatten(got)
    assert len(jflat) == len(tflat)
    for (_, a), (path, b) in zip(jflat, tflat):
        assert b.dtype == getattr(torch, str(np.asarray(a).dtype)), path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)


def test_opt_state_from_jax_checks_structure_and_shapes():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jinit(jopt.opt_state_specs(jcfg, jtf.param_specs(jcfg)),
                                          jax.random.PRNGKey(0)))
    bad = dict(tree, mu=dict(tree["mu"], head=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError, match="opt_state/mu/head: shape"):
        opt_state_from_jax(tcfg, bad)
    with pytest.raises(ValueError, match="keys"):
        opt_state_from_jax(tcfg, {k: v for k, v in tree.items() if k != "nu"})


# ------------------------------------------------------------------ faults
def test_straggler_detector_and_failure_schedule_match_jax():
    times = [1.0] * 6 + [3.0, 3.0, 3.0, 1.0, 5.0, 1.1, 2.4, 2.6, 2.6, 2.7]
    j, t = jfault.StragglerDetector(), tfault.StragglerDetector()
    assert [t.record(x) for x in times] == [j.record(x) for x in times]
    assert t.median() == j.median()
    schedule = {4: ("device_loss", {"lost": 1})}
    for step in range(6):
        want = jfault.simulate_failure(step, schedule)
        got = tfault.simulate_failure(step, schedule)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.step, got.kind, got.payload) == (want.step, want.kind, want.payload)
