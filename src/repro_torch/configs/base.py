"""Configuration system for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig`` (exact numbers
from the assignment / public literature) plus a ``reduce()``'d variant used by
CPU smoke tests.  Input shapes are ``ShapeConfig``s; the cross product
(arch x shape) defines the dry-run cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""
    n_experts: int                 # routed experts
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared: int = 0              # always-on shared experts (DeepSeek-V3)
    capacity_factor: float = 1.25
    # "ep": shard experts over the model axis (needs n_experts % model == 0
    #        or padding); "tp": shard each expert's d_ff over the model axis.
    shard_mode: str = "ep"
    router_dtype: str = "float32"
    router: str = "softmax"        # softmax (mixtral) | sigmoid (deepseek-v3)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD configuration (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256               # SSD chunk length -- a tunable "block size"


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense-FFN hidden (0 for attn-free archs)
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # --- per-layer pattern -------------------------------------------------
    # kinds: "attn" | "ssm" | "hybrid"; windows: 0 = global full attention,
    # otherwise sliding-window size.  Empty tuple = homogeneous default.
    layer_kinds: tuple = ()
    windows: tuple = ()
    moe_layers: tuple = ()         # per-layer bool; empty -> all MoE iff moe

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # --- modality frontends (stubs per assignment) -------------------------
    frontend: str = "none"         # none | vision | audio
    n_codebooks: int = 1           # audio (EnCodec streams)
    image_tokens: int = 0          # vision (precomputed patch embeddings)
    meta_tokens: int = 0           # hymba learnable meta tokens

    # --- misc architecture knobs -------------------------------------------
    rope_theta: float = 10000.0
    local_rope_theta: float = 0.0  # theta for windowed layers (0 -> rope_theta)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    scale_embeddings: bool = False # gemma-style sqrt(d_model) embedding scale
    act: str = "silu"              # silu | gelu
    mtp_depth: int = 0             # DeepSeek-V3 multi-token prediction depth
    mtp_loss_weight: float = 0.1
    moe_aux_coef: float = 0.01     # load-balance aux-loss coefficient
    dense_d_ff: int = 0            # d_ff of leading dense layers in MoE archs

    # --- capability flags ---------------------------------------------------
    # True when a sub-quadratic context mechanism exists (SSM / SWA), i.e.
    # the long_500k decode cell is in-family.
    long_context_ok: bool = False
    skip_shapes: tuple = ()        # shape names this arch does not run

    # --- training / distribution policy ------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"       # adamw | adafactor
    opt_dtype: str = "float32"     # Adam moment dtype
    grad_accum_dtype: str = "float32"
    param_sharding: str = "tp"     # "tp" (replicate over data) | "fsdp"
    # "zero1": optimizer state additionally shards over the data axis even
    # when params replicate (ZeRO-1); XLA inserts the reduce-scatter /
    # all-gather pair around the update automatically.
    opt_sharding: str = "replicated"
    train_microbatches: int = 1    # grad-accumulation steps inside train_step
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save matmul outputs)
    scan_unroll: bool = False      # unroll layer scans (cost-analysis probes)
    # KV-cache layout for decode: shard cache sequence over "data" axis
    # ("seq", flash-decoding style) or shard kv heads over "model" ("heads").
    decode_cache_sharding: str = "seq"

    # ------------------------------------------------------------------ api
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def kinds(self) -> tuple:
        return self.layer_kinds if self.layer_kinds else ("attn",) * self.n_layers

    @property
    def layer_windows(self) -> tuple:
        return self.windows if self.windows else (0,) * self.n_layers

    @property
    def layer_moe(self) -> tuple:
        if self.moe_layers:
            return self.moe_layers
        return ((self.moe is not None),) * self.n_layers

    def n_params(self) -> int:
        """Analytic parameter count (embedding + per-layer + head)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        total = self.vocab * d * self.n_codebooks          # embeddings
        if not self.tie_embeddings:
            total += self.vocab * d * self.n_codebooks     # lm head(s)
        total += self.meta_tokens * d
        for i in range(self.n_layers):
            kind = self.kinds[i]
            if kind in ("attn", "hybrid"):
                if self.mla is not None:
                    m = self.mla
                    total += d * m.q_lora_rank + m.q_lora_rank * h * (m.qk_nope_dim + m.qk_rope_dim)
                    total += d * (m.kv_lora_rank + m.qk_rope_dim)
                    total += m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                    total += h * m.v_head_dim * d
                else:
                    total += d * h * hd + 2 * d * kv * hd + h * hd * d
            if kind in ("ssm", "hybrid") and self.ssm is not None:
                s = self.ssm
                d_in = s.expand * d
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                nh = d_in // s.head_dim
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
                total += conv_dim * s.d_conv + 2 * nh + d_in * d           # conv, A/dt, out
            # ffn
            if self.layer_moe[i] and self.moe is not None:
                mo = self.moe
                total += d * mo.n_experts                                   # router
                total += (mo.n_experts + mo.n_shared) * 3 * d * mo.d_ff
            elif self.d_ff or self.dense_d_ff:
                dff = self.dense_d_ff if (self.moe is not None) else self.d_ff
                total += 3 * d * dff
            total += 2 * d                                                  # norms
        total += d                                                          # final norm
        if self.mtp_depth:
            # one extra transformer block + projection per MTP depth
            total += self.mtp_depth * (4 * d * h * hd + 3 * d * (self.dense_d_ff or self.d_ff or d * 4) + 2 * d * d)
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        mo = self.moe
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_ff
        n_moe_layers = sum(self.layer_moe)
        return self.n_params() - n_moe_layers * inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned; identical for all LM-family archs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to CPU-smoke scale, preserving the layer-kind mix."""
    # keep a representative slice of the layer pattern: first 2 + one of each
    # distinct (kind, window!=0, moe) combination present in the full model.
    kinds, wins, moes = cfg.kinds, cfg.layer_windows, cfg.layer_moe
    seen, idx = set(), []
    for i in range(cfg.n_layers):
        key = (kinds[i], wins[i] != 0, moes[i])
        if key not in seen or len(idx) < 2:
            seen.add(key)
            idx.append(i)
        if len(idx) >= 4:
            break
    n_layers = len(idx)
    small_win = lambda w: 0 if w == 0 else 32
    new = dict(
        n_layers=n_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        dense_d_ff=256 if cfg.dense_d_ff else 0,
        vocab=512,
        layer_kinds=tuple(kinds[i] for i in idx),
        windows=tuple(small_win(wins[i]) for i in idx),
        moe_layers=tuple(moes[i] for i in idx),
        image_tokens=16 if cfg.image_tokens else 0,
        meta_tokens=8 if cfg.meta_tokens else 0,
        train_microbatches=1,
        param_dtype="float32",
        compute_dtype="float32",
        opt_dtype="float32",
        rope_theta=10000.0,
    )
    if cfg.moe is not None:
        new["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=64,
            n_shared=min(cfg.moe.n_shared, 1))
    if cfg.mla is not None:
        new["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                               qk_nope_dim=16, qk_rope_dim=16, v_head_dim=32)
    if cfg.ssm is not None:
        new["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.mtp_depth:
        new["mtp_depth"] = 1
    return cfg.replace(**new)


SMOKE_SHAPE = ShapeConfig("smoke", "train", 64, 2)
