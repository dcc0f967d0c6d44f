"""The plain reference against the port, in float32 on the CPU at a tiny
size: one train step (loss, every weight's gradient, the Adafactor update),
one prefill (last logits and every layer's keys and values) and three decode
steps (their logits)."""
import pytest
import torch

from chipbench import common
from chipbench.reference import model as M
from chipbench.reference import serve as RS
from chipbench.reference import train as RT

DIMS = common.Dims(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                   rope_theta=5e6, norm_eps=1e-5)
CPU = torch.device("cpu")
TOL = 2e-5                      # float32 on both sides, summed in other orders


def port_cfg(**train):
    return common.port_config("tiny", DIMS, **train).replace(
        param_dtype="float32", compute_dtype="float32")


def weights(seed=7):
    return common.draw_weights(DIMS, seed, CPU, torch.float32)


def test_train_step_matches_port():
    from repro_torch.launch import train
    from repro_torch.models.layers import init_param_tree
    from repro_torch.runtime.steps import TrainHParams

    hp = TrainHParams(peak_lr=1e-2, warmup=0, total_steps=100)
    cfg = port_cfg(optimizer="adafactor", opt_dtype="float32", grad_accum_dtype="float32",
                   train_microbatches=2, remat=True)
    step_fn, specs, _ = train.build(cfg, None, None, hp, use_flash=True)
    w = weights()
    params = common.port_params({k: v.clone() for k, v in w.items()}, cfg)
    opt = init_param_tree(specs[1], None, CPU)
    toks = common.draw_tokens(3, "t", (2, 2, 32), DIMS.vocab, CPU)
    params, opt, metrics, _ = train.run_step(step_fn, params, opt, {"tokens": toks}, 0, CPU)

    losses, gnorms, model = RT.follow(
        lambda: w, lambda s: list(toks), 1, lambda s: RT.cosine_lr(s, 1e-2, 0, 100),
        DIMS.norm_eps, DIMS.rope_theta)
    assert float(metrics["loss"]) == pytest.approx(losses[0], rel=TOL)
    from chipbench.drivers import train as D
    got = D.program_grad_norms(opt, common.weight_shapes(DIMS))
    for name in gnorms:
        assert got[name] == pytest.approx(gnorms[name], rel=1e-4), name
    ref = {n: torch.stack(s) if st else s[0] for n, s, st in
           ((n, [p.detach() for p in s], st) for n, s, st in model.leaves())}
    prog = {"tok_emb": params["tok_emb"], "final_norm": params["final_norm"],
            "head": params["head"], "w2": params["stages"][0]["u0"]["ffn"]["wo"]}
    u = params["stages"][0]["u0"]
    prog.update({k: u["attn"][k] for k in ("wq", "wk", "wv", "wo")})
    prog.update({k: u["ffn"][k] for k in ("wi", "wg")}, ln1=u["ln1"], ln2=u["ln2"])
    for name, p in prog.items():
        moved = (ref[name] - w[name]).norm()
        assert moved > 0, name
        assert float((p - ref[name]).norm() / moved) < 1e-3, name


def test_prefill_matches_port():
    from repro_torch.models import transformer as tfm
    cfg = port_cfg()
    w = weights(11)
    params = common.port_params(w, cfg)
    toks = common.draw_tokens(5, "p", (2, 48), DIMS.vocab, CPU)
    with torch.no_grad():
        last, cache = tfm.prefill(cfg, params, toks, use_flash=True)
    seen = []

    def on_layer(li, i, kvs):
        k, v = kvs[0]
        unit = cache["stages"][0]["u0"]
        seen.append(max(common.rel_err(unit["k"][li, i], k), common.rel_err(unit["v"][li, i], v)))
    out = RS.forward(w, DIMS, list(toks), [torch.tensor([47])] * 2, on_layer=on_layer)
    for i in range(2):
        assert common.rel_err(last[i, -1], out[0][i][0]) < TOL
    assert len(seen) == 2 * DIMS.n_layers and max(seen) < TOL


def test_three_decode_steps_match_port():
    from repro_torch.models import transformer as tfm
    cfg = port_cfg()
    w = weights(13)
    params = common.port_params(w, cfg)
    toks = common.draw_tokens(9, "d", (3, 20), DIMS.vocab, CPU)
    with torch.no_grad():
        last, cache = tfm.prefill(cfg, params, toks, use_flash=True)
        cache = tfm.grow_cache(cfg, cache, 24)
        tok, served, logits = last[:, -1].argmax(-1), [], []
        for _ in range(3):
            served.append(tok)
            lg, cache = tfm.decode_step(cfg, params, cache, tok[:, None])
            logits.append(lg[:, -1])
            tok = lg[:, -1].argmax(-1)
    seqs = [torch.cat([toks[i], torch.stack(served, 1)[i]]) for i in range(3)]
    out = RS.forward(w, DIMS, seqs, [torch.arange(20, 23)] * 3)
    for i in range(3):
        for j in range(3):
            assert common.rel_err(logits[j][i], out[0][i][j]) < TOL
        assert float(common.token_gap(out[0][i], torch.stack(served[1:] + [tok], 0)[:, i]).max()) \
            < 1e-4


def test_fp8_control_rounds_products():
    """The control's products are float8 e4m3 at one scale a tensor: each
    operand is off by up to 1/16 of itself, so its logits move where float32's
    do not."""
    x = torch.randn(64, 64)
    q = M.Precision(fp8=True).round(x)
    assert not torch.equal(q, x)
    assert float(((q - x).abs() / x.abs().clamp(min=1e-3)).median()) < 1 / 16
    w = weights(17)
    toks = [common.draw_tokens(1, "c", (32,), DIMS.vocab, CPU)]
    ref, ctl = RS.forward(w, DIMS, toks, [torch.tensor([31])], (M.FP32, M.Precision(True)))
    assert common.rel_err(ctl[0], ref[0]) > 1e-3
