"""The port's step builders against the JAX package's
``repro/runtime/steps.py`` and ``transformer.cache_specs``, and the
dry-run's per-rank argument bytes against the reference's shardings.

* ``input_specs`` and ``cache_specs`` for all 40 (arch, shape) pairs of
  ``cells(include_skipped=True)``: leaf for leaf on shape, axes, dtype and
  init (pure, exact).
* Per-rank argument bytes (params, optimizer state, batch or cache) of every
  one of the 35 cells on both production meshes: the port's, from
  ``dryrun.build_cell``'s meta shards on a fake 512-rank group (a
  subprocess), exactly equal to the sums of the reference's
  ``NamedSharding.shard_shape`` on a ``jax.sharding.AbstractMesh``.  The
  reference's decode cache carries ``pos`` as an int32 scalar, the port's
  as a Python int: that leaf (4 bytes) is left out of the reference's sum.
* ``step_fn_for``'s prefill and decode steps on every arch's reduced config,
  the weights ``params_from_jax``, against the reference's jitted steps:
  logits and every cache leaf within 2e-3 (``tests/test_torch_serve.py``'s
  tolerance), ``pos`` equal, the ``donate`` tuples equal, and the decode
  cache's leaves of the shapes ``input_specs`` gives the decode cell.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dryrun
from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import transformer as jtf
from repro.models.layers import ParamSpec as JParamSpec
from repro.models.layers import init_param_tree as jinit_param_tree
from repro.runtime import sharding as jshd
from repro.runtime import steps as jsteps
from repro.runtime.optim import opt_state_specs as jopt_state_specs
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, cells, get_config, reduced_config
from repro_torch.models import transformer as ttf
from repro_torch.runtime import steps
from repro_torch.runtime.tree import flatten, leaves
from repro_torch.weights import params_from_jax

ALL = list(cells(include_skipped=True))
RUN = list(cells())


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JParamSpec))


def _same_specs(got, want):
    got, want = leaves(got), _jleaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.shape, g.axes, g.dtype, g.init) == (w.shape, w.axes, w.dtype, w.init), (g, w)


def test_cell_lists_match_jax():
    assert ALL == list(jcells(include_skipped=True)) and len(ALL) == 40
    assert RUN == list(jcells()) and len(RUN) == 35


@pytest.mark.parametrize("arch,shape", ALL)
def test_input_and_cache_specs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = SHAPES[shape], JSHAPES[shape]
    _same_specs(steps.input_specs(cfg, s), jsteps.input_specs(jcfg, js))
    if s.kind == "train":
        _same_specs(steps.input_specs(cfg, s, microbatches=4),
                    jsteps.input_specs(jcfg, js, microbatches=4))
    _same_specs(ttf.cache_specs(cfg, s.global_batch, s.seq_len),
                jtf.cache_specs(jcfg, js.global_batch, js.seq_len))


def test_input_specs_refuse_an_uneven_microbatch_split():
    with pytest.raises(ValueError, match="microbatches"):
        steps.input_specs(get_config("yi-6b"), SHAPES["train_4k"], microbatches=3)


@pytest.fixture(scope="module")
def port_arg_bytes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("argbytes")
    _torch_dryrun.run(tmp, "arg_bytes", tmp / "out.json")
    return json.loads((tmp / "out.json").read_text())


_ABSTRACT = {"pod16x16": ((16, 16), ("data", "model")),
             "pods2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_arg_bytes(arch, shape, mesh_name):
    """The reference's per-device argument bytes of a cell, as its
    ``build_cell`` places them, pos left out."""
    mesh = jax.sharding.AbstractMesh(*_ABSTRACT[mesh_name])
    cfg, s = jget_config(arch), JSHAPES[shape]
    rules = jshd.make_rules(cfg, mesh, s)
    pspecs = jtf.param_specs(cfg)
    trees = [(pspecs, rules)]
    bspecs = jsteps.input_specs(cfg, s)
    if s.kind == "decode":
        bspecs = {**bspecs, "cache": {"stages": bspecs["cache"]["stages"]}}
    trees.append((bspecs, rules))
    if s.kind == "train":
        opt_rules = rules
        if cfg.opt_sharding == "zero1":
            opt_rules = {**rules, "embed": "data", "embed_out": "data"}
        trees.append((jopt_state_specs(cfg, pspecs), opt_rules))
    total = 0
    for specs, r in trees:
        shardings = jax.tree.leaves(jshd.spec_shardings(specs, mesh, r))
        for spec, sh in zip(_jleaves(specs), shardings):
            total += int(np.prod(sh.shard_shape(spec.shape), dtype=np.int64)) \
                * np.dtype(spec.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", RUN)
def test_argument_bytes_match_jax_shard_shapes(port_arg_bytes, arch, shape):
    for mesh_name in _ABSTRACT:
        got = port_arg_bytes[f"{arch}__{shape}__{mesh_name}"]
        assert got == _ref_arg_bytes(arch, shape, mesh_name), mesh_name


def _draw(cfg, specs, rng):
    """A batch for ``specs``: tokens in [0, vocab), image embeddings normal."""
    out = {}
    for k, s in specs.items():
        if k == "tokens":
            out[k] = rng.integers(0, cfg.vocab, s.shape).astype(np.int32)
        elif k == "image_embeds":
            out[k] = rng.standard_normal(s.shape).astype(np.float32)
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3, err_msg=what)


def _same_cache(got, want):
    jflat = jax.tree_util.tree_flatten_with_path(want["stages"])[0]
    tflat = flatten(got["stages"])
    assert len(tflat) == len(jflat)
    for (path, x), (_, y) in zip(tflat, jflat):
        _close(x, y, path)
    assert int(got["pos"]) == int(want["pos"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_steps_match_jax(arch):
    """A 40-token prompt (the reduced windows of 32 wrap in prefill), its
    cache grown to the decode cell's capacity, then one decode step."""
    cfg, jcfg = reduced_config(arch), jreduced_config(arch)
    prompt = 40
    n_prefix = cfg.meta_tokens + (cfg.image_tokens if cfg.frontend == "vision" else 0)
    seq = prompt + n_prefix
    pshape, jpshape = (ShapeConfig("p", "prefill", seq, 2),
                       JShapeConfig("p", "prefill", seq, 2))
    jparams = jinit_param_tree(jtf.param_specs(jcfg), jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    batch = _draw(cfg, steps.input_specs(cfg, pshape), np.random.default_rng(0))
    assert batch["tokens"].shape[-1] == prompt

    fn, donate = steps.step_fn_for(cfg, pshape)
    jfn, jdonate = jsteps.step_fn_for(jcfg, jpshape)
    assert donate == jdonate == ()
    last, cache = fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    jlast, jcache = jax.jit(jfn)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(last, jlast, "prefill logits")
    _same_cache(cache, jcache)

    cap = seq + 2
    dshape, jdshape = (ShapeConfig("d", "decode", cap, 2),
                       JShapeConfig("d", "decode", cap, 2))
    cache = ttf.grow_cache(cfg, cache, cap)
    jcache = jtf.grow_cache(jcfg, jcache, cap)
    for (path, x), s in zip(flatten(cache["stages"]),
                            leaves(steps.input_specs(cfg, dshape)["cache"]["stages"])):
        assert tuple(x.shape) == s.shape, path
    tok = _draw(cfg, steps.input_specs(cfg, dshape), np.random.default_rng(1))["tokens"]
    fn, donate = steps.step_fn_for(cfg, dshape)
    jfn, jdonate = jsteps.step_fn_for(jcfg, jdshape)
    assert donate == jdonate == (1,)
    logits, cache = fn(tparams, {"tokens": torch.from_numpy(tok), "cache": cache})
    jlogits, jcache = jax.jit(jfn)(jparams, {"tokens": jnp.asarray(tok), "cache": jcache})
    _close(logits, jlogits, "decode logits")
    _same_cache(cache, jcache)


def test_train_step_donates_params_and_optimizer_state():
    cfg, jcfg = reduced_config("yi-6b"), jreduced_config("yi-6b")
    shape, jshape = ShapeConfig("t", "train", 32, 8), JShapeConfig("t", "train", 32, 8)
    assert steps.step_fn_for(cfg, shape)[1] == jsteps.step_fn_for(jcfg, jshape)[1] == (0, 1)
