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
# reduced chunk of 16, so it ends in a ragged chunk
@pytest.mark.parametrize("arch,prompt_len", [(ARCH, PROMPT), ("gemma3-27b", 40),
                                             ("mixtral-8x7b", 40), ("hymba-1.5b", 40),
                                             ("mamba2-370m", 40)])
def test_greedy_generation_matches_jax(arch, prompt_len):
    cfg = serve.build_config(arch, "small")
    jparams = init_param_tree(jtf.param_specs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    prompts = np.random.default_rng(0).integers(2, cfg.vocab, (B, prompt_len))

    last, cache = jtf.prefill(cfg, jparams, jnp.asarray(prompts), use_flash=True)
    # room for the meta prefix too, as serve.generate makes it
    cache = jtf.grow_cache(cfg, cache, prompt_len + GEN + cfg.meta_tokens + 1)
    want_logits = [last[:, -1]]
    want = [jnp.argmax(want_logits[-1], axis=-1)]
    for _ in range(GEN - 1):
        logits, cache = jtf.decode_step(cfg, jparams, cache, want[-1][:, None])
        want_logits.append(logits[:, -1])
        want.append(jnp.argmax(want_logits[-1], axis=-1))

    gen = serve.generate(cfg, tparams, torch.tensor(prompts), gen_len=GEN,
                         temperature=0.0, generator=torch.Generator())
    np.testing.assert_array_equal(gen.tokens.numpy(), np.stack(want, axis=1))
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
