"""The port's optimizers against the JAX package's (``repro.runtime.optim``)
on the same numpy trees: the schedule, global-norm clipping, and one and
three AdamW and Adafactor updates (Adafactor also with its slots in
bf16).  fp32 arithmetic throughout; tolerance 1e-6 relative (1 ulp of the
fp32 steps, plus sum order in the norms)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import transformer as jtf
from repro.models.layers import ParamSpec as JParamSpec
from repro.models.layers import init_param_tree as jinit
from repro.runtime import optim as jopt
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import ParamSpec, init_param_tree
from repro_torch.runtime import optim as topt
from repro_torch.runtime.tree import flatten, tree_map

SHAPES = {"w": (6, 5), "stack": {"a": (2, 4, 3), "b": (7,)}, "pair": ((3, 3), (4,))}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes[0], tuple):
        return tuple(_tree(rng, s, scale) for s in shapes)
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(jtree, ttree, rtol=1e-6):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = flatten(ttree)
    assert len(jflat) == len(tflat)
    for (_, a), (path, b) in zip(jflat, tflat):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=rtol,
                                   atol=rtol * (np.abs(a).max() + 1e-30), err_msg=path)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    want = jopt.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
    got = topt.cosine_schedule(step, **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])   # clips, and leaves alone
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(np.random.default_rng(0))
    jclipped, jn = jopt.clip_by_global_norm(_jax(grads), max_norm)
    tgrads = _torch(grads)
    tclipped, tn = topt.clip_by_global_norm(tgrads, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(jclipped, tclipped)
    _close(_jax(grads), tgrads, rtol=0)          # the input is left as it was


def _run(name, n_steps, opt_dtype="float32"):
    """``n_steps`` updates of both packages from the same params and grads,
    the state in ``opt_dtype``."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    shapes = SHAPES
    to_spec = {"j": lambda s: JParamSpec(s, (None,) * len(s), "float32"),
               "t": lambda s: ParamSpec(s, (None,) * len(s), "float32")}

    def spec_tree(kind, node=shapes):
        if isinstance(node, dict):
            return {k: spec_tree(kind, v) for k, v in node.items()}
        if isinstance(node[0], tuple):
            return tuple(spec_tree(kind, s) for s in node)
        return to_spec[kind](node)

    jcfg = {"adamw": jopt.AdamWConfig(), "adafactor": jopt.AdafactorConfig()}[name]
    tcfg = {"adamw": topt.AdamWConfig(), "adafactor": topt.AdafactorConfig()}[name]
    jspecs = getattr(jopt, f"{name}_state_specs")(spec_tree("j"), opt_dtype)
    tspecs = getattr(topt, f"{name}_state_specs")(spec_tree("t"), opt_dtype)
    jstate = jinit(jspecs, jax.random.PRNGKey(0))
    tstate = init_param_tree(tspecs, torch.Generator(), torch.device("cpu"))
    jp, tp = _jax(params), _torch(params)
    jupdate, tupdate = getattr(jopt, f"{name}_update"), getattr(topt, f"{name}_update")
    for i in range(n_steps):
        grads = _tree(rng, scale=0.1 * (i + 1))
        lr = jopt.cosine_schedule(jnp.asarray(i + 5, jnp.int32), peak_lr=1e-2,
                                  warmup=4, total=20)
        jp, jstate, jn = jupdate(jcfg, _jax(grads), jstate, jp, lr)
        tp, tstate, tn = tupdate(tcfg, _torch(grads), tstate, tp,
                                 topt.cosine_schedule(i + 5, peak_lr=1e-2, warmup=4,
                                                      total=20))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    return jp, jstate, tp, tstate


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_matches_jax(n_steps):
    jp, js, tp, ts = _run("adamw", n_steps)
    _close(jp, tp)
    _close(js["mu"], ts["mu"])
    _close(js["nu"], ts["nu"])
    assert int(ts["count"]) == int(js["count"]) == n_steps


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adafactor_matches_jax(n_steps):
    jp, js, tp, ts = _run("adafactor", n_steps)
    _close(jp, tp)
    _close(js["slots"], ts["slots"])
    assert int(ts["count"]) == int(js["count"]) == n_steps


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adafactor_with_bf16_state_matches_jax(n_steps):
    """Adafactor with its slots in bf16 (deepseek-v3-671b's ``opt_dtype``):
    each update reads the slots up to fp32 and stores them back rounded,
    in both packages; the slots stay bf16 and agree bit for bit, the fp32
    parameters within the fp32 tolerance."""
    jp, js, tp, ts = _run("adafactor", n_steps, opt_dtype="bfloat16")
    _close(jp, tp)
    jflat = jax.tree_util.tree_flatten_with_path(js["slots"])[0]
    tflat = flatten(ts["slots"])
    assert len(jflat) == len(tflat)
    for (_, a), (path, b) in zip(jflat, tflat):
        assert b.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16), err_msg=path)
    assert int(ts["count"]) == int(js["count"]) == n_steps


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 40, 24), (500, 16)], ids=["stacked", "embedding"])
def test_adamw_in_slices_is_the_whole_leaf_update_bit_for_bit(monkeypatch, shape,
                                                               param_dtype):
    """AdamW walks each leaf in slices along its first axis: with
    ``ADAMW_SLICE`` at 1000 entries a stacked [3, 40, 24] leaf goes a layer
    at a time and an embedding-shaped [500, 16] one 62 rows at a time (9
    slices), and three updates (fp32 moments, ``param_dtype`` parameters,
    the gradient clipped) leave the parameters, both moments and the
    clipped gradients bit-identical to the whole-leaf update's; a 1-D leaf
    and a small one go whole."""
    rng = np.random.default_rng(4)
    shapes = {"w": shape, "norm": (shape[-1],), "small": (4, 5)}
    rng_params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: (rng.normal(size=s) * (i + 1)).astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]

    def run(slice_entries):
        monkeypatch.setattr(topt, "ADAMW_SLICE", slice_entries)
        params = {k: torch.tensor(rng_params[k]).to(param_dtype) for k in shapes}
        specs = {k: ParamSpec(s, (None,) * len(s), "float32") for k, s in shapes.items()}
        state = init_param_tree(topt.adamw_state_specs(specs, "float32"), torch.Generator(),
                                torch.device("cpu"))
        for i, grads in enumerate(steps):
            grads = {k: torch.tensor(v) for k, v in grads.items()}
            params, state, _ = topt.adamw_update(
                topt.AdamWConfig(), grads, state, params,
                topt.cosine_schedule(i + 5, peak_lr=1e-2, warmup=4, total=20))
        return params, state, grads

    assert len(list(topt._first_axis_slices(torch.empty(shape)))) == 1
    monkeypatch.setattr(topt, "ADAMW_SLICE", 1000)
    assert len(list(topt._first_axis_slices(torch.empty(shape)))) == \
        {(3, 40, 24): 3, (500, 16): 9}[shape]
    whole, sliced = run(1 << 27), run(1000)
    for (path, a), (_, b) in zip(flatten(whole), flatten(sliced)):
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_in_slices_matches_the_whole_leaf_update(monkeypatch, dtype):
    """Adafactor walks a factored leaf in slices of its axes before the last
    two: with ``ADAFACTOR_SLICE`` at 1000 entries a [3, 4, 40, 24] leaf goes
    one [40, 24] block at a time (12 slices), a [64, 48] 2-D leaf and a
    1-D one whole.  Three updates against the whole-leaf update's
    (``ADAFACTOR_SLICE`` at its default): every vr and vc slot bit-identical
    (each row's means are its own), the 2-D and 1-D leaves and their slots
    bit-identical, the sliced leaf's parameters within 1e-6 of its largest
    entry with fp32 parameters and state, and within one bf16 ulp with bf16
    parameters and state (its RMS and scale are sums over the slices,
    divided once), and the gnorm within 1e-6."""
    rng = np.random.default_rng(7)
    shapes = {"experts": (3, 4, 40, 24), "head": (64, 48), "norm": (24,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-2, 1, size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    dt = getattr(torch, dtype)

    def run(slice_entries):
        monkeypatch.setattr(topt, "ADAFACTOR_SLICE", slice_entries)
        params = {k: torch.tensor(v).to(dt) for k, v in init.items()}
        specs = {k: ParamSpec(s, (None,) * len(s), dtype) for k, s in shapes.items()}
        state = init_param_tree(topt.adafactor_state_specs(specs, dtype), torch.Generator(),
                                torch.device("cpu"))
        norms = []
        for i, grads in enumerate(steps):
            params, state, gnorm = topt.adafactor_update(
                topt.AdafactorConfig(), {k: torch.tensor(v) for k, v in grads.items()},
                state, params, topt.cosine_schedule(i + 5, peak_lr=1e-2, warmup=4, total=20))
            norms.append(float(gnorm))
        return params, state, norms

    assert topt._slice_rows(torch.empty(shapes["experts"])) == 0
    monkeypatch.setattr(topt, "ADAFACTOR_SLICE", 1000)
    assert topt._slice_rows(torch.empty(shapes["experts"])) == 1
    assert topt._slice_rows(torch.empty(shapes["head"])) == 0
    (wp, ws, wn), (sp, ss, sn) = run(1 << 27), run(1000)
    def bits(x):
        return x.reshape(-1).view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    for (path, a), (_, b) in zip(flatten(ws["slots"]), flatten(ss["slots"])):
        assert torch.equal(bits(a), bits(b)), path
    for k in ("head", "norm"):
        assert torch.equal(bits(wp[k]), bits(sp[k])), k
    a, b = wp["experts"], sp["experts"]
    if dtype == "float32":
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * a.abs().max().item())
    else:
        assert (bits(a).int() - bits(b).int()).abs().max() <= 1
    np.testing.assert_allclose(sn, wn, rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_specs_match_jax(optimizer):
    jcfg = jreduced_config("yi-6b").replace(optimizer=optimizer, opt_dtype="bfloat16")
    tcfg = reduced_config("yi-6b").replace(optimizer=optimizer, opt_dtype="bfloat16")
    jspecs = jopt.opt_state_specs(jcfg, jtf.param_specs(jcfg))
    tspecs = topt.opt_state_specs(tcfg, ttf.param_specs(tcfg))
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JParamSpec))[0]
    tflat = flatten(tspecs)
    assert [(tuple(s.shape), s.dtype, s.axes) for _, s in jflat] == \
        [(tuple(s.shape), s.dtype, s.axes) for _, s in tflat]
