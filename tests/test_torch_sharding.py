"""The port's logical-axis sharding against the JAX package's
``repro/runtime/sharding.py``, and its sharded train step on four gloo ranks.

* The five resolver cases of ``tests/test_sharding.py``, on the same
  ``FakeMesh`` stand-in.
* A sweep: the ten configs x every shape in ``SHAPES`` x the meshes 16x16,
  2x16x16 (with "pod"), 2x2 and 1x3: ``make_rules`` and every
  ``param_specs`` leaf's ``resolve_pspec`` equal the JAX functions', the
  port's tuple holding the ``PartitionSpec``'s entries.
* DTensor placements from a spec.
* Four gloo ranks on a (2, 2) ("data", "model") mesh, fp32, the reduced
  configs at the scale of ``tests/test_torch_train.py``: two sharded steps
  (TP rules for yi-6b, with and without flash, and with top-k compression;
  FSDP rules and MoE for mixtral-8x7b; the SSD's rank-local convolution
  for hymba-1.5b; MLA, the MoE and MTP under FSDP for deepseek-v3-671b;
  the FSDP MLP and the tied head for gemma3-27b) against
  the port's plain step from the same weights and tokens: loss and gnorm
  within rtol 1e-5, every parameter within 1e-5 of its leaf's scale (the
  leaf's largest entry, and at least the peak learning rate: an AdamW step
  moves each entry by up to ~lr whatever its gradient's size, so a norm
  scale that starts at zero holds entries of ~lr, and a sum-order
  difference of 1e-7 in a near-zero gradient moves one of them by 1.4e-5
  of its leaf's largest entry, hymba's ``ssm/norm``); every rank holds only
  the shard ``resolve_pspec`` implies.  The port's own
  plain step is the oracle: the JAX package's sharded step fails under jax
  0.9 (ROADMAP.md section 3), and its plain step is held to the port's in
  ``tests/test_torch_train.py``.
* mixtral-8x7b's prefill on the same mesh against the port's plain
  prefill: the last logits and the windowed ring caches.
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_ranks
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.models.layers import ParamSpec as JParamSpec
from repro.runtime import sharding as jshd
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import ParamSpec
from repro_torch.runtime import sharding as tshd
from repro_torch.runtime.tree import leaves


class FakeMesh:
    """Axis-name/shape stand-in so resolver tests are mesh-size-accurate."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = 1
        for v in shape.values():
            self.size *= v


M16 = FakeMesh({"data": 16, "model": 16})
MESHES = {
    "16x16": M16,
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "2x2": FakeMesh({"data": 2, "model": 2}),
    "1x3": FakeMesh({"data": 1, "model": 3}),
}


def _p(spec: tuple):
    return P(*spec)


def test_divisible_dims_shard():
    spec = tshd.resolve_pspec(("vocab", "embed"), (32000, 4096),
                              tshd.make_rules(get_config("yi-6b"), M16), M16)
    assert spec == ("model",)                   # embed unsharded (tp mode)


def test_non_divisible_falls_back_to_replication():
    cfg = get_config("yi-6b")                  # kv=4 < 16
    spec = tshd.resolve_pspec(("embed", "kv", None), (4096, 4, 128),
                              tshd.make_rules(cfg, M16), M16)
    assert spec == ()                          # kv dropped, trailing None cut


def test_axis_used_once_per_tensor():
    cfg = get_config("deepseek-v3-671b")
    rules = tshd.make_rules(cfg, M16, SHAPES["decode_32k"])
    spec = tshd.resolve_pspec(("layers", "batch", "kv_seq", "kv", None),
                              (61, 128, 32768, 128, 128), rules, M16)
    assert spec == (None, "data", "model")
    wspec = tshd.resolve_pspec(("embed", "heads", "head_dim"), (7168, 128, 128),
                               rules, M16)
    assert "model" in wspec


def test_long_context_tiny_batch_gets_all_axes():
    cfg = get_config("mamba2-370m")
    rules = tshd.make_rules(cfg, M16, SHAPES["long_500k"])
    assert rules["batch"] == ()                # B=1 cannot shard
    spec = tshd.resolve_pspec(("layers", "batch", "kv_seq", "kv", None),
                              (48, 1, 524288, 8, 64), rules, M16)
    assert spec == (None, None, ("data", "model"))


def test_fsdp_vs_tp_param_rules():
    fs = tshd.make_rules(get_config("mixtral-8x7b"), M16)   # fsdp
    tp = tshd.make_rules(get_config("yi-6b"), M16)          # tp
    assert fs["embed"] == "data" and tp["embed"] is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_param_specs_match_jax(arch, mesh):
    """Every shape of ``SHAPES`` (and no shape): the rule table equals the
    JAX package's, and so does every parameter leaf's resolved spec."""
    m = MESHES[mesh]
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs = leaves(ttf.param_specs(cfg))
    jspecs = jax.tree.leaves(jtf.param_specs(jcfg),
                             is_leaf=lambda x: isinstance(x, JParamSpec))
    assert len(specs) == len(jspecs)
    for name in [None, *sorted(SHAPES)]:
        shape = None if name is None else SHAPES[name]
        jshape = None if name is None else JSHAPES[name]
        rules = tshd.make_rules(cfg, m, shape)
        assert rules == jshd.make_rules(jcfg, m, jshape), name
        for s, js in zip(specs, jspecs):
            assert isinstance(s, ParamSpec) and (s.shape, s.axes) == (js.shape, js.axes)
            got = tshd.resolve_pspec(s.axes, s.shape, rules, m)
            assert _p(got) == jshd.resolve_pspec(js.axes, js.shape, rules, m), (name, s)


def test_placements_from_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = FakeMesh({"pod": 2, "data": 2, "model": 2})
    assert tshd.pspec_placements((), m) == (Replicate(),) * 3
    assert tshd.pspec_placements((None, "model"), m) == (Replicate(), Replicate(), Shard(1))
    # a tuple of axes on one dim shards it over each of those mesh dims
    assert tshd.pspec_placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="order"):
        tshd.pspec_placements((("data", "pod"),), m)


@pytest.fixture(scope="module")
def yi_runs(tmp_path_factory):
    """yi-6b without and with flash, and with top-k compression, in one
    four-rank run."""
    tmp = tmp_path_factory.mktemp("yi")
    _torch_ranks.run(tmp, "sharded_step", tmp, "yi-6b", "01k")
    return tmp


def _check_sharded_run(path, weights=True):
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    for step in range(2):
        plain, sharded = out[f"loss{step}"]
        np.testing.assert_allclose(sharded, plain, rtol=1e-5)
        plain, sharded = out[f"gnorm{step}"]
        np.testing.assert_allclose(sharded, plain, rtol=1e-5)
    if not weights:
        return
    paths = [k[len("plain/"):] for k in out if k.startswith("plain/")]
    assert paths and int(out["sharded_leaves"]) > 0
    for path in paths:
        a, b = out[f"plain/{path}"], out[f"sharded/{path}"]
        scale = max(np.abs(a).max(), _torch_ranks.HP["peak_lr"])
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale, err_msg=path)


@pytest.mark.parametrize("flash", [0, 1])
def test_yi_sharded_step_on_four_ranks_matches_plain(yi_runs, flash):
    _check_sharded_run(yi_runs / f"variant{flash}.npz")


def test_yi_sharded_compressed_step_on_four_ranks_matches_plain(yi_runs):
    """Top-k compression (ratio 0.1) with error feedback in the sharded step:
    each rank keeps its own k largest of its shard, and the gathered
    candidates give the whole leaf's k-th largest magnitude.  Loss and
    gnorm of the compressed gradient within rtol 1e-5 of the plain step's;
    the weights are not held entry by entry, since an entry within a
    sum-order difference of the cut can fall on either side of it."""
    _check_sharded_run(yi_runs / "variantk.npz", weights=False)


@pytest.mark.parametrize("arch, batch, heads", [
    pytest.param(arch, 8, "", id=arch)
    for arch in ("mixtral-8x7b", "hymba-1.5b", "deepseek-v3-671b", "gemma3-27b")] + [
    # one sequence a rank in each microbatch; hymba's 5 heads split no mesh
    # axis, so its scores split the key axis (``attention._KeyShardAttention``
    # and its backward), and the SSD's chunk block runs on its chunk shard
    # (5 chunks on 2: replicated; mamba2's 4 on 2: split)
    pytest.param("hymba-1.5b", 4, "5x1", id="hymba-1.5b-5-heads-one-sequence-a-rank"),
    pytest.param("mamba2-370m", 4, "", id="mamba2-370m-one-sequence-a-rank")])
def test_sharded_step_on_four_ranks_matches_plain(tmp_path, arch, batch, heads):
    _torch_ranks.run(tmp_path, "sharded_step", tmp_path, arch, "0", batch, heads)
    _check_sharded_run(tmp_path / "variant0.npz")


def test_sharded_prefill_on_four_ranks_matches_plain(tmp_path):
    """mixtral-8x7b's prefill on the (2, 2) mesh: its two windowed layers
    (window 32) pack 64-token prompts into rings that wrap.  The last logits
    and every cache leaf within 1e-5 of the plain prefill's largest entry,
    and each rank holds only the shard of each cache leaf that
    ``cache_specs`` gives (checked in the ranks)."""
    _torch_ranks.run(tmp_path, "sharded_prefill", tmp_path, "mixtral-8x7b")
    with np.load(tmp_path / "prefill.npz") as z:
        out = {k: z[k] for k in z.files}
    assert out["pos"][0] == out["pos"][1] == _torch_ranks.PREFILL["seq"]
    paths = [k[len("plain/"):] for k in out if k.startswith("plain/")]
    assert "logits" in paths and any(p.endswith("/k") for p in paths)
    for path in paths:
        a, b = out[f"plain/{path}"], out[f"sharded/{path}"]
        assert a.shape == b.shape, path
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max(), err_msg=path)



@pytest.mark.parametrize("arch, heads", [("yi-6b", ""), ("hymba-1.5b", "5x1")])
def test_sharded_decode_on_four_ranks_matches_plain(tmp_path, arch, heads):
    """Decode steps on the (2, 2) mesh after a plain prefill, the cache's
    kv_seq split over "model" and one sequence a rank, so each rank attends
    over its shard of the cache (``attention._sdpa_over_keys``): hymba's
    windowed layer (window 32) has a ring that wrapped in the 72-token
    prefill and its 8 meta keys beside it.  Each step's logits and every
    cache leaf after the last step within 1e-5 of the plain decode's largest
    entry."""
    _torch_ranks.run(tmp_path, "sharded_decode", tmp_path, arch, heads)
    with np.load(tmp_path / "decode.npz") as z:
        out = {k: z[k] for k in z.files}
    assert out["pos"][0] == out["pos"][1]
    paths = [k[len("plain/"):] for k in out if k.startswith("plain/")]
    assert sum(p.startswith("logits") for p in paths) == _torch_ranks.DECODE["steps"]
    assert any(p.endswith("/k") for p in paths)
    for path in paths:
        a, b = out[f"plain/{path}"], out[f"sharded/{path}"]
        assert a.shape == b.shape, path
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max(), err_msg=path)


def test_attention_over_a_split_key_axis_matches_sdpa(tmp_path):
    """``attention._sdpa_over_keys`` with the keys split over "model" on the
    (2, 2) mesh against the plain ``_sdpa`` (fp32): the output, with and
    without a decode step's never-evicted prefix, and the gradients of q, k
    and v within 1e-5 of the plain one's largest entry, for a mask with a
    query row that sees no key on any shard (the mean of V over all keys,
    and its gradient, as the plain softmax gives) and rows whose keys all
    lie on one shard."""
    _torch_ranks.run(tmp_path, "key_shard_attention", tmp_path)
    with np.load(tmp_path / "keys.npz") as z:
        out = {k: z[k] for k in z.files}
    np.testing.assert_allclose(out["plain/out"][:, 0],
                               np.repeat(out["plain/out"][:, 0, :1], 3, axis=1))
    for name in ("out", "prefix", "grad_q", "grad_k", "grad_v"):
        a, b = out[f"plain/{name}"], out[f"sharded/{name}"]
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max(), err_msg=name)
