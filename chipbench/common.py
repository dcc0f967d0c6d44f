"""What every driver shares: the files a cell is made of, found by name; the
seeded inputs (weights and token ids), made on the device; the handing of
the weights to the program in its layout; and the readings a run prints.

Nothing here imports the program at module level: ``port_config`` and
``port_params`` import it when called.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    """``workloads/<name>.json``: the cell's config, driver, traffic
    parameters, limits and why."""
    return read_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    """``configs/<name>.json``: the model's published config.json keys."""
    return read_json(BENCH / "configs" / f"{name}.json")


@dataclass(frozen=True)
class Dims:
    """A dense llama-family decoder's sizes, as its config.json gives them."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def of(cls, cfg: dict) -> "Dims":
        return cls(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                   n_heads=cfg["num_attention_heads"],
                   n_kv_heads=cfg["num_key_value_heads"],
                   d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                   rope_theta=float(cfg["rope_theta"]), norm_eps=float(cfg["rms_norm_eps"]))


def port_config(name: str, dims: Dims, **train):
    """The program's ``ModelConfig`` for ``dims``: bf16 weights and
    activations, no tied head; ``train`` sets the training fields
    (optimizer, its state's dtype, accumulation, microbatches)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=name, family="dense", n_layers=dims.n_layers,
                       d_model=dims.d_model, n_heads=dims.n_heads,
                       n_kv_heads=dims.n_kv_heads, d_head=dims.head_dim,
                       d_ff=dims.d_ff, vocab=dims.vocab, rope_theta=dims.rope_theta,
                       norm_eps=dims.norm_eps, param_dtype="bfloat16",
                       compute_dtype="bfloat16", tie_embeddings=False, **train)


# ---------------------------------------------------------------- seeded inputs

def generator(seed: int, *key, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``key``: each input
    has its own stream, so any one can be drawn again alone."""
    digest = hashlib.sha256(repr((int(seed),) + key).encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little"))


def weight_shapes(d: Dims) -> dict:
    """Each weight's shape, the layers stacked on a leading axis, in the
    layout the program's ``param_specs`` names (``w2`` is the MLP's down
    projection, ``ffn/wo`` there)."""
    L, D, H, K, hd, F, V = (d.n_layers, d.d_model, d.n_heads, d.n_kv_heads, d.head_dim,
                            d.d_ff, d.vocab)
    return {"tok_emb": (V, D), "ln1": (L, D), "wq": (L, D, H, hd), "wk": (L, D, K, hd),
            "wv": (L, D, K, hd), "wo": (L, H, hd, D), "ln2": (L, D), "wi": (L, D, F),
            "wg": (L, D, F), "w2": (L, F, D), "final_norm": (D,), "head": (D, V)}


# the input dims each product contracts, by weight: its fan-in
_FAN_IN = {"wq": (1,), "wk": (1,), "wv": (1,), "wo": (1, 2), "wi": (1,), "wg": (1,),
           "w2": (1,), "head": (0,)}


def weight_scale(name: str, shape: tuple) -> float:
    """N(0, 1) times this: min(0.02, fan_in ** -0.5) for a product's weight,
    0.02 for the embedding and the norms' scales."""
    if name not in _FAN_IN:
        return 0.02
    fan_in = math.prod(shape[i] for i in _FAN_IN[name])
    return min(0.02, fan_in ** -0.5)


def draw_weight(d: Dims, seed: int, name: str, device, dtype=torch.bfloat16):
    """One weight, drawn whole on ``device`` in ``dtype`` from its own stream."""
    shape = weight_shapes(d)[name]
    w = torch.randn(shape, generator=generator(seed, "weight", name, device=device),
                    dtype=dtype, device=device)
    return w.mul_(weight_scale(name, shape))


def draw_weights(d: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every weight (one randn call each, twelve in all)."""
    return {name: draw_weight(d, seed, name, device, dtype) for name in weight_shapes(d)}


def rng(seed: int, *key):
    """A numpy generator seeded from ``seed`` and ``key`` (host-side draws:
    orders and samples)."""
    import numpy as np
    digest = hashlib.sha256(repr((int(seed),) + key).encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


def draw_tokens(seed: int, key, shape, vocab: int, device) -> torch.Tensor:
    """Token ids uniform in [0, vocab), int64, from the stream ``key``."""
    return torch.randint(0, vocab, shape, generator=generator(seed, "tokens", key,
                                                              device=device),
                         device=device)


def port_params(w: dict, cfg) -> dict:
    """The weights as the program's parameter tree (the same tensors, no
    copy), its shapes checked against the program's ``param_specs``."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.tree import leaves
    tree = {"tok_emb": w["tok_emb"],
            "stages": ({"u0": {"ln1": w["ln1"],
                               "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
                               "ln2": w["ln2"],
                               "ffn": {"wi": w["wi"], "wg": w["wg"], "wo": w["w2"]}}},),
            "final_norm": w["final_norm"], "head": w["head"]}
    specs = leaves(tfm.param_specs(cfg))
    got = leaves(tree)
    if [tuple(s.shape) for s in specs] != [tuple(x.shape) for x in got]:
        raise RuntimeError("the benchmark's weights do not match the program's layout: "
                           f"{[tuple(s.shape) for s in specs]} vs "
                           f"{[tuple(x.shape) for x in got]}")
    return tree


# ---------------------------------------------------------------- readings

@dataclass
class Run:
    """What a per-layer metric's reader is given: the cell, its sizes, the
    window's host seconds, the trace's ``window.Summary`` (``None``
    untraced) and the driver's counts (steps, requests, launches...)."""
    cell: str
    dims: Dims
    window_s: float
    trace: object
    readings: dict


def stamp(ctx, what: str) -> None:
    """Say how far into the run (from the process's start) ``what`` is."""
    import time
    ctx.say(f"[{ctx.cell}] {what} at {time.perf_counter() - ctx.t_start:.3f} s")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def token_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best at that position: [..., V] logits, [...] tokens."""
    ref_logits = ref_logits.double()
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[..., None].long())[..., 0]


def percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
