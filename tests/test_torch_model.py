"""The port's model (forward, prefill, decode) against the JAX package's on
the same weights: JAX's parameter tree carried across by params_from_jax.

Each supported arch runs at its reduced config; gemma3-27b runs a second
time with meta tokens and tied embeddings.  The windowed archs' reduced
window is 32, so a 37-token prefill already wraps the ring and the decode
steps wrap it again; the SSM archs' reduced chunk is 16, so the same
prefill ends in a ragged chunk (hymba's 8 meta tokens included).
phi-3-vision-4.2b runs with its 16 image embeddings prepended and
musicgen-large on [B, 4, T] codebook tokens, and deepseek-v3-671b on MLA's
latent caches (its multi-token prediction leaves ride along in the tree),
through every test of the fixture."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.layers import init_param_tree
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.weights import init_params, params_from_jax

TOL = 2e-3
RUNS = ("yi-6b", "deepseek-7b", "gemma3-27b", "h2o-danube-3-4b", "mixtral-8x7b",
        "hymba-1.5b", "mamba2-370m", "phi-3-vision-4.2b", "musicgen-large",
        "deepseek-v3-671b")
META_TIED = dict(meta_tokens=8, tie_embeddings=True)
PAIRS = [(arch, {}) for arch in RUNS] + [("gemma3-27b", META_TIED)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _prefix(cfg, img) -> int:
    """Positions before the text: meta tokens or the image."""
    return cfg.meta_tokens + (0 if img is None else img.shape[1])


@pytest.fixture(scope="module", params=PAIRS,
                ids=lambda p: p[0] + ("+meta+tied" if p[1] else ""))
def pair(request):
    arch, replace = request.param
    cfg = reduced_config(arch).replace(**replace)
    jparams = init_param_tree(
        jtf.param_specs(jreduced_config(arch).replace(**replace)),
        jax.random.PRNGKey(0))
    return cfg, jparams, params_from_jax(cfg, _np_tree(jparams))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_model_forward_matches_jax(pair, use_flash):
    cfg, jparams, tparams = pair
    tokens, img = serve.draw_inputs(cfg, 2, 48, np.random.default_rng(1))
    want, *_ = jtf.model_forward(cfg, jparams, jnp.asarray(tokens), _jax(img))
    got, *_ = ttf.model_forward(cfg, tparams, torch.tensor(tokens), _torch(img),
                                use_flash=use_flash)
    _close(got, want)


def test_prefill_then_decode_matches_jax(pair):
    cfg, jparams, tparams = pair
    tokens, img = serve.draw_inputs(cfg, 2, 40, np.random.default_rng(2))
    t0 = 37
    jlast, jcache = jtf.prefill(cfg, jparams, jnp.asarray(tokens[..., :t0]), _jax(img),
                                use_flash=True)
    tlast, tcache = ttf.prefill(cfg, tparams, torch.tensor(tokens[..., :t0]), _torch(img),
                                use_flash=True)
    _close(tlast, jlast)
    capacity = tokens.shape[-1] + _prefix(cfg, img) + 4
    jcache = jtf.grow_cache(cfg, jcache, capacity)
    tcache = ttf.grow_cache(cfg, tcache, capacity)
    for pos in range(t0, t0 + 3):
        new = tokens[..., pos:pos + 1]
        jlog, jcache = jtf.decode_step(cfg, jparams, jcache, jnp.asarray(new))
        tlog, tcache = ttf.decode_step(cfg, tparams, tcache, torch.tensor(new))
        _close(tlog, jlog)
        assert tcache["pos"] == int(jcache["pos"])
    for name, got in tcache["stages"][0]["u0"].items():
        _close(got, jcache["stages"][0]["u0"][name])


def test_chunked_attention_matches_whole(monkeypatch):
    """Above the score-size threshold the plain path walks query chunks."""
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
               for s in [(2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)])
    pos = torch.arange(40)
    whole = tattn._attend(q, k, v, pos, 8, 2, 0.25)
    monkeypatch.setattr(tattn, "_CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(tattn, "_CHUNK_Q", 16)
    torch.testing.assert_close(tattn._attend(q, k, v, pos, 8, 2, 0.25), whole)


def test_grow_cache_pads_only_seq(pair):
    """The JAX package's rule: a global layer's k/v (MLA's latent ckv and
    krope) grow along the sequence axis, zero-padded; a ring, the meta
    prefix and an SSM layer's state and conv window keep their shape."""
    cfg, jparams, tparams = pair
    tokens = np.arange(16)[None] % cfg.vocab
    if cfg.n_codebooks > 1:
        tokens = np.stack([tokens] * cfg.n_codebooks, axis=1)
    img = serve.draw_inputs(cfg, 1, 16, np.random.default_rng(3))[1]
    _, cache = ttf.prefill(cfg, tparams, torch.tensor(tokens), _torch(img))
    _, jcache = jtf.prefill(cfg, jparams, jnp.asarray(tokens), _jax(img))
    grown = ttf.grow_cache(cfg, cache, 64)
    jgrown = jtf.grow_cache(cfg, jcache, 64)
    n_full = n_fixed = 0
    for st, sc, gc, jgc in zip(ttf.build_stages(cfg), cache["stages"],
                               grown["stages"], jgrown["stages"]):
        for j, desc in enumerate(st.unit):
            u = f"u{j}"
            assert set(gc[u]) == set(jgc[u])
            for name, orig in sc[u].items():
                new = gc[u][name]
                assert new.shape == jgc[u][name].shape, (u, name)
                if desc.window == 0 and name in ("k", "v", "ckv", "krope"):
                    assert new.shape[2] == 64
                    assert torch.equal(new[:, :, :orig.shape[2]], orig)
                    assert not new[:, :, orig.shape[2]:].any()
                    n_full += 1
                else:
                    assert new is orig
                    n_fixed += 1
                _close(new, jgc[u][name])
    descs = [d for st in ttf.build_stages(cfg) for d in st.unit]
    attn = [d for d in descs if d.kind != "ssm"]
    assert n_full == 2 * sum(d.window == 0 for d in attn)
    assert n_fixed == (2 + 2 * bool(cfg.meta_tokens)) * sum(
        d.window > 0 for d in attn) + 2 * sum(d.kind != "attn" for d in descs)


def test_configs_match_jax():
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro.configs import get_config as jget_config
    from repro.configs import cells as jcells
    from repro_torch.configs import cells
    assert ARCH_IDS == JARCH_IDS
    for skipped in (False, True):
        assert list(cells(skipped)) == list(jcells(skipped))
    for arch in ARCH_IDS:
        assert repr(get_config(arch)) == repr(jget_config(arch))
        assert repr(reduced_config(arch)) == repr(jreduced_config(arch))


def _flat(tree, path=""):
    """{path: (shape, dtype, init)} over a dict / tuple spec tree of either package."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, tuple):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{path}[{i}]").items()}
    return {path: (tuple(tree.shape), tree.dtype, tree.init)}


def test_stages_and_specs_match_jax():
    for arch in RUNS:
        cfg = get_config(arch)
        assert repr(ttf.build_stages(cfg)) == repr(jtf.build_stages(cfg))
        assert _flat(ttf.param_specs(cfg)) == _flat(jtf.param_specs(cfg))


def test_layers_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 3, 16))
    scale = rng.normal(size=(16,)) * 0.1
    _close(tlayers.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-5),
           jlayers.rms_norm(jnp.asarray(x, jnp.float32), jnp.asarray(scale, jnp.float32), 1e-5))
    pos = np.arange(3, 15)
    _close(tlayers.apply_rope(torch.tensor(x, dtype=torch.float32), torch.tensor(pos), 5e6),
           jlayers.apply_rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos), 5e6))
    p = {n: rng.normal(size=s) * 0.1 for n, s in
         [("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16))]}
    h = rng.normal(size=(2, 5, 16))
    for act in ("silu", "gelu"):
        _close(tlayers.mlp({n: torch.tensor(a, dtype=torch.float32) for n, a in p.items()},
                           torch.tensor(h, dtype=torch.float32), act),
               jlayers.mlp({n: jnp.asarray(a, jnp.float32) for n, a in p.items()},
                           jnp.asarray(h, jnp.float32), act))
    for win, meta in [(0, 0), (4, 0), (4, 2)]:
        q, k = np.arange(5, 12), np.arange(12)
        got = tlayers.causal_window_mask(torch.tensor(q), torch.tensor(k), win, meta)
        want = jlayers.causal_window_mask(jnp.asarray(q), jnp.asarray(k), win, meta)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_init_params_follows_jax_rule():
    cfg = reduced_config("yi-6b")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    assert not params["final_norm"].any()
    wq = params["stages"][0]["u0"]["attn"]["wq"]          # [R, d, h, hd]
    assert abs(float(wq.std()) - min(0.02, wq.shape[-2] ** -0.5)) < 2e-3
    wi = params["stages"][0]["u0"]["ffn"]["wi"]            # fan_in d_model
    assert abs(float(wi.std()) - min(0.02, cfg.d_model ** -0.5)) < 2e-3


def test_params_from_jax_checks_structure():
    cfg = reduced_config("yi-6b")
    jparams = _np_tree(init_param_tree(jtf.param_specs(jreduced_config("yi-6b")),
                                       jax.random.PRNGKey(0)))
    bad = dict(jparams, head=jparams["head"][:, :-1])
    with pytest.raises(ValueError, match="params/head"):
        params_from_jax(cfg, bad)
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(cfg, {k: v for k, v in jparams.items() if k != "head"})


def test_params_from_jax_keeps_bfloat16():
    cfg = reduced_config("yi-6b").replace(param_dtype="bfloat16")
    jparams = init_param_tree(jtf.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, _np_tree(jparams))
    assert tparams["head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["head"].float().numpy(),
                                  np.asarray(jparams["head"], np.float32))


# Capacity-MoE drops depend on the batch: a token dropped in the T-token
# forward is never dropped in a 1-token decode step, so the port's own
# decode-vs-forward runs MoE archs with a capacity factor that admits every
# routed token, as the JAX package's test_serve.py does.
NO_DROP = {"mixtral-8x7b", "deepseek-v3-671b"}


@pytest.mark.parametrize("arch,replace", PAIRS,
                         ids=[a + ("+meta+tied" if r else "") for a, r in PAIRS])
def test_decode_matches_forward(arch, replace, T=44, B=2, steps=3):
    """The port alone: prefill T - steps tokens, then decode ``steps``
    tokens; each step's logits are the full forward's at that position.
    The reduced window is 32, so the decode steps run on a wrapped ring."""
    cfg = reduced_config(arch).replace(**replace)
    if arch in NO_DROP:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts) / cfg.moe.top_k))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens, img = (_torch(x) for x in serve.draw_inputs(cfg, B, T, np.random.default_rng(1)))
    with torch.no_grad():
        full, *_ = ttf.model_forward(cfg, params, tokens, img)
        t0 = T - steps
        last, cache = ttf.prefill(cfg, params, tokens[..., :t0], img, use_flash=True)
        cache = ttf.grow_cache(cfg, cache, T + _prefix(cfg, img) + 4)
        torch.testing.assert_close(last[:, 0], full[:, t0 - 1], rtol=0, atol=TOL)
        for pos in range(t0, T):
            logits, cache = ttf.decode_step(cfg, params, cache, tokens[..., pos:pos + 1])
            torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=0, atol=TOL)
            assert cache["pos"] == pos + 1 + _prefix(cfg, img)


def test_params_from_jax_carries_meta_and_the_tied_tree():
    replace = dict(META_TIED, param_dtype="bfloat16")
    cfg = reduced_config("gemma3-27b").replace(**replace)
    jparams = init_param_tree(
        jtf.param_specs(jreduced_config("gemma3-27b").replace(**replace)),
        jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, _np_tree(jparams))
    assert "head" not in tparams and "head" not in jparams
    assert tparams["meta"].shape == (8, cfg.d_model)
    assert tparams["meta"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["meta"].float().numpy(),
                                  np.asarray(jparams["meta"], np.float32))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(cfg, dict(_np_tree(jparams), head=np.zeros((cfg.d_model, cfg.vocab))))


def test_moe_leaves_carry_across_with_an_fp32_router():
    cfg = reduced_config("mixtral-8x7b").replace(param_dtype="bfloat16")
    jparams = init_param_tree(
        jtf.param_specs(jreduced_config("mixtral-8x7b").replace(param_dtype="bfloat16")),
        jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, _np_tree(jparams))
    for si, stage in enumerate(tparams["stages"]):
        for u, layer in stage.items():
            ffn, jffn = layer["ffn"], jparams["stages"][si][u]["ffn"]
            assert set(ffn) == {"router", "w_in", "w_gate", "w_out"}
            assert ffn["router"].dtype == torch.float32
            assert ffn["w_in"].dtype == torch.bfloat16
            for name in ffn:
                np.testing.assert_array_equal(ffn[name].float().numpy(),
                                              np.asarray(jffn[name], np.float32))
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    router = drawn["stages"][0]["u0"]["ffn"]["router"]
    assert router.dtype == torch.float32 and router.shape == (2, 128, 4)


def test_scaled_embedding_is_bit_identical_in_bf16():
    """gemma3's sqrt(d_model) scale is rounded to bf16 before the product
    (73.32 -> 73.5 at d_model 5376), in both packages."""
    cfg = get_config("gemma3-27b").replace(vocab=64)
    assert cfg.scale_embeddings and cfg.param_dtype == "bfloat16"
    table = np.random.default_rng(3).normal(size=(64, cfg.d_model)).astype(np.float32)
    jtable = jnp.asarray(table, jnp.bfloat16)
    ttable = torch.from_numpy(np.array(jtable.astype(jnp.float32))).to(torch.bfloat16)
    tokens = np.random.default_rng(4).integers(0, 64, (2, 24))
    want = jtf.embed_tokens(cfg, {"tok_emb": jtable}, jnp.asarray(tokens))
    got = ttf.embed_tokens(cfg, {"tok_emb": ttable}, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        got.float().numpy(), (ttable[torch.from_numpy(tokens)].float() * 73.5).to(
            torch.bfloat16).float().numpy())


def test_ssm_leaves_carry_across_in_fp32():
    """hymba's bf16 tree keeps the SSD's a_log, d_skip and dt_bias in fp32,
    as the JAX package's specs say, whether carried across or drawn."""
    cfg = reduced_config("hymba-1.5b").replace(param_dtype="bfloat16")
    jparams = init_param_tree(
        jtf.param_specs(jreduced_config("hymba-1.5b").replace(param_dtype="bfloat16")),
        jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, _np_tree(jparams))
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fp32 = {"a_log", "d_skip", "dt_bias"}
    for si, stage in enumerate(tparams["stages"]):
        for u, layer in stage.items():
            ssm, jssm = layer["ssm"], jparams["stages"][si][u]["ssm"]
            assert set(ssm) == set(jssm) == set(drawn["stages"][si][u]["ssm"])
            for name in ssm:
                want = torch.float32 if name in fp32 else torch.bfloat16
                assert ssm[name].dtype == drawn["stages"][si][u]["ssm"][name].dtype == want
                np.testing.assert_array_equal(ssm[name].float().numpy(),
                                              np.asarray(jssm[name], np.float32))
            assert torch.equal(drawn["stages"][si][u]["ssm"]["d_skip"],
                               torch.ones_like(ssm["d_skip"]))


def test_mla_and_mtp_leaves_carry_across_in_bf16():
    """deepseek-v3's MLA leaves (norm scales among them) and its
    multi-token prediction subtree, carried across in bf16 bit for bit:
    the same leaves, shapes and dtypes as drawn by the port."""
    arch = "deepseek-v3-671b"
    cfg = reduced_config(arch).replace(param_dtype="bfloat16")
    jparams = init_param_tree(
        jtf.param_specs(jreduced_config(arch).replace(param_dtype="bfloat16")),
        jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, _np_tree(jparams))
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mla = {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    pairs = [(tparams["stages"][si][u]["attn"], jparams["stages"][si][u]["attn"],
              drawn["stages"][si][u]["attn"])
             for si, stage in enumerate(tparams["stages"]) for u in stage]
    mtp, jmtp = tparams["mtp"], jparams["mtp"]
    assert set(mtp) == {"proj", "ln_h", "ln_e", "block", "ln_out"}
    assert set(mtp["block"]) == {"ln1", "attn", "ln2", "ffn"}
    assert set(mtp["block"]["ffn"]) == {"wi", "wg", "wo"}           # dense
    assert mtp["proj"].shape == (2 * cfg.d_model, cfg.d_model)
    pairs += [(mtp, jmtp, drawn["mtp"]), (mtp["block"]["attn"], jmtp["block"]["attn"],
                                          drawn["mtp"]["block"]["attn"]),
              (mtp["block"]["ffn"], jmtp["block"]["ffn"], drawn["mtp"]["block"]["ffn"])]
    for got, want, new in pairs:
        if "wq_a" in got:
            assert set(got) == mla
        for name, leaf in got.items():
            if isinstance(leaf, dict):
                continue
            assert leaf.dtype == new[name].dtype == torch.bfloat16
            assert leaf.shape == new[name].shape
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          np.asarray(want[name], np.float32))
