"""The roofline models of the JAX package's ``core/roofline.py``: the
two-term tile roofline shared by the kernel cost model and the timing
simulator, and the analytic three-term (compute, memory, collective)
roofline per (arch x shape x mesh) cell that the mesh tuner prices its
grid with (``forward_flops``, ``model_flops``, ``cache_bytes_global``,
``cell_roofline``: the reference's arithmetic, line for line).

``V5E`` keeps the reference's TPU v5e constants, so that the port's cost
model and simulator can be held against the reference number for number.
``H100`` is the card the port runs on, from NVIDIA's H100 SXM data sheet:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, 80 GB,
NVLink 450 GB/s each way.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 197e12
    hbm_bw: float = 819e9
    link_bw: float = 50e9
    hbm_cap: float = 16 * 2**30
    dcn_bw: float = 25e9          # cross-pod per-chip share
    name: str = "v5e"             # names the timing backend's records


V5E = Hardware()
# the H100 has no cross-pod network of its own; dcn_bw stays the
# reference's placeholder and no tile formula reads it
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
                hbm_cap=80e9, name="h100")


def roofline_time(flops, hbm_bytes, *, hw: Hardware = H100,
                  eff=1.0):
    """The two-term tile roofline: max(compute, memory) seconds.  Works on
    scalars or broadcast numpy arrays — ``core/kerneltune.py``'s tile cost
    model and the ``kernels/timing.py`` simulator backend both price their
    steady-state step through this one function, so the analytic prior and
    the simulated "measurement" share a single roofline vocabulary."""
    compute = np.asarray(flops, np.float64) / (hw.peak_flops
                                               * np.maximum(eff, 1e-3))
    memory = np.asarray(hbm_bytes, np.float64) / hw.hbm_bw
    return np.maximum(compute, memory)


def mxu_efficiency(bm, bn, *, mxu: int = 128):
    """Matrix-unit utilization of a (bm, bn) output tile, broadcast over
    arrays: sub-``mxu`` dims waste slots proportionally and non-multiples
    pay a fixed fragmentation penalty.  Shared by the closed-form tile cost
    model and the timing simulator."""
    bm = np.asarray(bm, np.float64)
    bn = np.asarray(bn, np.float64)
    eff = np.minimum(bm, mxu) / mxu * np.minimum(bn, mxu) / mxu
    return np.where((bm % mxu == 0) & (bn % mxu == 0),
                    np.minimum(1.0, eff), 0.6 * eff)


def _attn_layer_flops(cfg: ModelConfig, tokens: float, ctx: float,
                      decode: bool) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk, v = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
        proj = 2 * tokens * (d * m.q_lora_rank + m.q_lora_rank * h * qk
                             + d * (m.kv_lora_rank + m.qk_rope_dim))
        if decode:   # absorbed: latent-space scores + context
            proj += 2 * tokens * h * m.qk_nope_dim * m.kv_lora_rank * 2
            att = 2 * tokens * ctx * h * (m.kv_lora_rank + m.qk_rope_dim) \
                + 2 * tokens * ctx * h * m.kv_lora_rank
            proj += 2 * tokens * h * m.kv_lora_rank * v
        else:        # decompressed
            proj += 2 * tokens * m.kv_lora_rank * h * (m.qk_nope_dim + v)
            att = 2 * tokens * ctx * h * qk + 2 * tokens * ctx * h * v
        out = 2 * tokens * h * v * d
        return proj + att + out
    qkvo = 2 * tokens * d * hd * (2 * h + 2 * kv)
    att = 4 * tokens * ctx * h * hd
    return qkvo + att


def _ssm_layer_flops(cfg: ModelConfig, tokens: float, decode: bool) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    proj = 2 * tokens * d * (2 * d_in + 2 * gn + nh) + 2 * tokens * d_in * d
    conv = 2 * tokens * (d_in + 2 * gn) * s.d_conv
    if decode:
        ssd = 6 * tokens * nh * s.head_dim * s.d_state
    else:
        cl = s.chunk
        intra = 2 * tokens * cl * (gn + nh + nh * s.head_dim)
        inter = 6 * tokens * nh * s.head_dim * s.d_state
        ssd = intra + inter
    return proj + conv + ssd


def _ffn_flops(cfg: ModelConfig, tokens: float, layer_moe: bool) -> float:
    d = cfg.d_model
    if layer_moe and cfg.moe is not None:
        mo = cfg.moe
        routed = 6 * tokens * mo.top_k * mo.capacity_factor * d * mo.d_ff
        shared = 6 * tokens * mo.n_shared * d * mo.d_ff
        router = 2 * tokens * d * mo.n_experts
        return routed + shared + router
    dff = cfg.dense_d_ff if cfg.moe is not None else cfg.d_ff
    return 6 * tokens * d * dff if dff else 0.0


def forward_flops(cfg: ModelConfig, tokens: float, seq: int,
                  kind: str) -> float:
    """Total forward FLOPs for `tokens` processed against context `seq`."""
    decode = kind == "decode"
    total = 0.0
    for i in range(cfg.n_layers):
        k = cfg.kinds[i]
        w = cfg.layer_windows[i]
        if decode:
            ctx = min(w, seq) if w else seq
        else:
            ctx = min(w, seq) if w else seq / 2          # causal average
        if k in ("attn", "hybrid"):
            total += _attn_layer_flops(cfg, tokens, ctx, decode)
        if k in ("ssm", "hybrid"):
            total += _ssm_layer_flops(cfg, tokens, decode)
        if k != "ssm":
            total += _ffn_flops(cfg, tokens, cfg.layer_moe[i])
    total += 2 * tokens * cfg.d_model * cfg.vocab * cfg.n_codebooks  # head
    if cfg.mtp_depth and kind == "train":
        total += cfg.mtp_depth * (
            _attn_layer_flops(cfg, tokens, seq / 2, False)
            + 6 * tokens * cfg.d_model * (cfg.dense_d_ff or cfg.d_ff
                                          or 4 * cfg.d_model)
            + 2 * tokens * cfg.d_model * cfg.vocab)
    return total


def model_flops(cfg: ModelConfig, tokens: float, kind: str) -> float:
    """The 6*N*D convention (6*N_active*D for MoE)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * cfg.n_active_params() * tokens


def cache_bytes_global(cfg: ModelConfig, batch: int, seq: int) -> float:
    total = 0.0
    bpe = 2
    for i in range(cfg.n_layers):
        k = cfg.kinds[i]
        w = cfg.layer_windows[i]
        cap = min(w, seq) if w else seq
        if k in ("attn", "hybrid"):
            if cfg.mla is not None:
                m = cfg.mla
                total += batch * seq * (m.kv_lora_rank + m.qk_rope_dim) * bpe
            else:
                total += 2 * batch * cap * cfg.n_kv_heads * cfg.head_dim * bpe
        if k in ("ssm", "hybrid"):
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh = d_in // s.head_dim
            total += batch * nh * s.head_dim * s.d_state * 4
            total += batch * (s.d_conv - 1) * (d_in + 2 * s.n_groups
                                               * s.d_state) * bpe
    return total


def cell_roofline(cfg: ModelConfig, shape: ShapeConfig, mesh: dict, *,
                  microbatches: int | None = None, hw: Hardware = H100,
                  overlap: float = 0.0) -> dict:
    """Three roofline terms for one cell, priced on ``hw`` (the H100 by
    default; ``V5E`` gives the reference's numbers).

    mesh: {"pod": p, "data": d, "model": m} (pod optional).
    ``overlap``: fraction of collective time hidden under compute (0 =
    fully exposed baseline; the §Perf overlap optimizations raise it).
    """
    chips = 1
    for v in mesh.values():
        chips *= v
    dp = mesh.get("data", 1) * mesh.get("pod", 1)
    tp = mesh.get("model", 1)
    mb = microbatches or (cfg.train_microbatches if shape.kind == "train" else 1)

    kind = shape.kind
    if kind == "decode":
        tokens = float(shape.global_batch)
        seq = shape.seq_len
    else:
        tokens = float(shape.global_batch * shape.seq_len)
        seq = shape.seq_len

    # ---------------- compute term -----------------------------------------
    fwd = forward_flops(cfg, tokens, seq, kind)
    if kind == "train":
        # fwd=1 + bwd=2 (+1 full-remat recompute; "dots" saves matmul
        # outputs so only ~0.4 of the forward is recomputed)
        mult = 3.0 if not cfg.remat else \
            (3.4 if cfg.remat_policy == "dots" else 4.0)
    else:
        mult = 1.0
    flops_total = fwd * mult
    compute_s = flops_total / (chips * hw.peak_flops)

    # ---------------- memory term (per-device HBM traffic) -----------------
    p_bytes = cfg.n_params() * 2.0
    p_shards = chips if cfg.param_sharding == "fsdp" else tp
    p_local = p_bytes / p_shards
    opt_mult = {"adamw": 8.0, "adafactor": 0.3}[cfg.optimizer] * \
        (0.5 if cfg.opt_dtype == "bfloat16" else 1.0)
    opt_local = cfg.n_params() * opt_mult / chips if cfg.param_sharding == "fsdp" \
        else cfg.n_params() * opt_mult / tp
    tokens_dev = tokens / dp
    act_traffic = 12.0 * tokens_dev * cfg.d_model * cfg.n_layers / \
        max(tp, 1) * (1.0 if kind != "train" else 3.0)
    if kind == "train":
        bytes_dev = p_local * (2 * mb + 1) + opt_local * 2 + act_traffic
    elif kind == "prefill":
        bytes_dev = p_local * 2 + act_traffic \
            + cache_bytes_global(cfg, shape.global_batch, seq) / chips
    else:
        bytes_dev = p_local if cfg.moe is None else \
            (cfg.n_active_params() * 2.0 / p_shards
             + (p_local - cfg.n_active_params() * 2.0 / p_shards) * 0.0
             + cfg.n_params() * 2.0 / p_shards * min(
                 1.0, shape.global_batch * cfg.moe.top_k
                 / cfg.moe.n_experts))
        bytes_dev += cache_bytes_global(cfg, shape.global_batch, seq) / chips
        bytes_dev += 4 * tokens_dev * cfg.d_model * cfg.n_layers / max(tp, 1)
    memory_s = bytes_dev / hw.hbm_bw

    # ---------------- collective term (per-device bytes over ICI) ----------
    coll = 0.0
    tok_rep = tokens / dp                       # tokens per data replica
    n_ar_layers = sum(1 for i in range(cfg.n_layers))
    if tp > 1:
        # Megatron-style activation all-reduces: 2/layer fwd, 2 bwd (+remat)
        per_layer = (6 if kind == "train" else 2)
        coll += per_layer * n_ar_layers * tok_rep * cfg.d_model * 2.0 \
            * 2 * (tp - 1) / tp
    if cfg.param_sharding == "fsdp" and dp > 1:
        if kind != "train":
            ag = 2.0
        else:
            # weight all-gathers per step: fwd once per microbatch, plus the
            # remat re-forward (full remat re-gathers; "dots" saves matmul
            # outputs so the re-forward skips most weight reads)
            refwd = 1.0 if (cfg.remat and cfg.remat_policy != "dots") else 0.5
            ag = (1.0 + refwd) * mb
        coll += ag * (p_bytes / tp) * (dp - 1) / dp
        if kind == "train":
            coll += mb * (p_bytes / tp) * (dp - 1) / dp   # grad reduce-scatter
    elif kind == "train" and dp > 1:
        coll += 2 * (p_bytes / tp) * (dp - 1) / dp        # DP grad all-reduce
    if cfg.moe is not None and kind != "decode":
        # dispatch all-gather + combine reduce-scatter of activations
        n_moe = sum(cfg.layer_moe)
        factor = 3 if kind == "train" else 1
        coll += factor * n_moe * 2 * tok_rep * cfg.d_model * 2.0 \
            * (dp - 1) / dp
    # `coll` is per-device bytes on the wire: ring all-reduce moves
    # 2*(g-1)/g * V per participant, all-gather/reduce-scatter (g-1)/g * V,
    # folded into the factors above.
    collective_s = coll / hw.link_bw * (1.0 - overlap)

    # ---------------- summary ----------------------------------------------
    mf = model_flops(cfg, tokens, kind)       # 6*N_active*D convention
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    hbm_need = p_local + opt_local + (
        cache_bytes_global(cfg, shape.global_batch, seq) / chips
        if kind != "train" else
        2.0 * tokens_dev / mb * cfg.d_model * cfg.n_layers)
    return {
        **terms,
        "dominant": dominant,
        "step_s": step_s,
        "flops_total": flops_total,
        "bytes_device": bytes_dev,
        "collective_bytes_device": coll,
        "model_flops": mf,
        "useful_ratio": mf / max(flops_total, 1.0),
        "mfu": (mf / (chips * hw.peak_flops * step_s)) if step_s else 0.0,
        "hbm_need_gib": hbm_need / 2**30,
        "fits": hbm_need < hw.hbm_cap,
        "chips": chips,
    }
