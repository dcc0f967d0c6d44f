"""The serving slice as a whole: the port's prefill + decode loop against
the JAX package's on the same weights, and the CLI's refusal to run on the
CPU unless asked."""
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
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.models.layers import init_param_tree
from repro_torch.launch import serve
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH, B, PROMPT, GEN = "yi-6b", 2, 16, 6


def test_small_preset_matches_jax_config():
    jcfg = jtrain.scale_config(jreduced_config(ARCH), **jtrain.PRESETS["small"])
    assert repr(serve.build_config(ARCH, "small")) == repr(jcfg)


# the windowed archs' small preset keeps the reduced window of 32, so a
# 40-token prompt wraps its rings in prefill; the SSM archs' keeps the
# reduced chunk of 16, so it ends in a ragged chunk; phi-3-vision's prompt
# follows 16 image embeddings and musicgen's is 4 codebook streams;
# deepseek-v3's decodes against MLA's latent caches
@pytest.mark.parametrize("arch,prompt_len", [(ARCH, PROMPT), ("gemma3-27b", 40),
                                             ("mixtral-8x7b", 40), ("hymba-1.5b", 40),
                                             ("mamba2-370m", 40), ("phi-3-vision-4.2b", 24),
                                             ("musicgen-large", 24),
                                             ("deepseek-v3-671b", 40)])
def test_greedy_generation_matches_jax(arch, prompt_len):
    cfg = serve.build_config(arch, "small")
    jparams = init_param_tree(jtf.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    prompts, img = serve.draw_inputs(cfg, B, prompt_len, np.random.default_rng(0))
    jimg = None if img is None else jnp.asarray(img)

    last, cache = jtf.prefill(cfg, jparams, jnp.asarray(prompts), jimg, use_flash=True)
    # room for the meta or image prefix too, as serve.generate makes it
    n_prefix = cfg.meta_tokens + (0 if img is None else img.shape[1])
    cache = jtf.grow_cache(cfg, cache, prompt_len + GEN + n_prefix + 1)
    want_logits = [last[:, -1]]
    want = [jnp.argmax(want_logits[-1], axis=-1)]
    for _ in range(GEN - 1):
        logits, cache = jtf.decode_step(cfg, jparams, cache, want[-1][..., None])
        want_logits.append(logits[:, -1])
        want.append(jnp.argmax(want_logits[-1], axis=-1))

    gen = serve.generate(cfg, tparams, torch.tensor(prompts), gen_len=GEN,
                         temperature=0.0, generator=torch.Generator(),
                         image_embeds=None if img is None else torch.from_numpy(img))
    np.testing.assert_array_equal(gen.tokens.numpy(), np.stack(want, axis=-1))
    assert len(gen.logits) == GEN
    for got, ref in zip(gen.logits, want_logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_main_on_cpu_returns_tokens_and_report():
    argv = ["--preset", "small", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen-len", "3"]
    report = {}
    out = serve.main(argv, report=report)
    assert out.shape == (2, 3)
    assert int(out.min()) >= 0 and int(out.max()) < serve.build_config(ARCH, "small").vocab
    assert report["logits_finite"] and report["prefill_ms"] > 0
    # sampling draws from an explicit, seeded generator
    assert torch.equal(out, serve.main(argv))


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "musicgen-large"])
def test_main_serves_the_frontends_on_cpu(arch):
    """serve.main draws the image prefix or the codebook prompts from the
    seed and returns codebook 0's stream [batch, gen_len]; sampling is
    seeded, codebooks drawn as B * K rows."""
    argv = ["--arch", arch, "--preset", "small", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen-len", "3"]
    report = {}
    out = serve.main(argv, report=report)
    assert out.shape == (2, 3) and report["logits_finite"]
    assert int(out.min()) >= 0 and int(out.max()) < serve.build_config(arch, "small").vocab
    assert torch.equal(out, serve.main(argv))


def test_sample_draws_each_codebook_row():
    logits = torch.full((2, 4, 16), -1e4)
    for b in range(2):
        for k in range(4):
            logits[b, k, (3 * b + k) % 16] = 0.0      # one token per row
    want = torch.tensor([[0, 1, 2, 3], [3, 4, 5, 6]])
    assert torch.equal(serve.sample(logits, torch.Generator(), 0.0), want)
    assert torch.equal(serve.sample(logits, torch.Generator().manual_seed(1), 1.0), want)
    assert serve.sample(logits[:, 0], torch.Generator(), 1.0).shape == (2,)


def test_cli_refuses_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a machine without CUDA")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", "--preset", "small",
         "--batch", "1", "--prompt-len", "4", "--gen-len", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "[serve]" not in proc.stdout


def test_cli_dispatch_help():
    from repro_torch.launch.__main__ import main
    assert main(["--help"]) == 0
    assert main(["no-such-command"]) == 2
