"""Per-(model, shape, dtype) kernel workloads extracted from the zoo.

Maps every ``configs/`` architecture x ``SHAPES`` cell to the concrete
kernel invocations its forward pass is made of -- the GEMMs behind
qkv/out/ffn projections (MoE uses the per-expert hidden dim, SSM its
in-projection) and the flash-attention call for attention layers -- as
:class:`repro_torch.kernels.timing.KernelCase` targets the measured autotuner
(``core/kerneltune.measure_cases``) can time and label.

Labels carry ``"{arch_id}/{shape_name}/{case_name}"`` provenance; the
measurement identity is the shape bucket, so architectures sharing a
projection shape (most of the zoo at d_model 4096) share measurements.
"""
from __future__ import annotations

from repro_torch.configs import ARCH_IDS, SHAPES, ModelConfig, get_config
from repro_torch.kernels.timing import KernelCase

#: shape cells the kernel eval sweeps (long_500k decode collapses to a
#: 1-token GEMM -- no tile decision left to make)
EVAL_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _tokens(shape) -> int:
    """GEMM row count for one device-step of the cell: the full sequence
    for train/prefill, the decode batch (one token per request) for
    decode."""
    return shape.seq_len if shape.kind in ("train", "prefill") \
        else shape.global_batch


def gemm_cases(cfg: ModelConfig, shape_name: str,
               *, arch_id: str = "") -> list[KernelCase]:
    """The projection GEMMs of one (arch, shape) cell."""
    shape = SHAPES[shape_name]
    t = _tokens(shape)
    d, hd = cfg.d_model, cfg.head_dim
    dtype = cfg.compute_dtype
    tag = f"{arch_id or cfg.name}/{shape_name}"
    cases = []

    def gemm(name, m, k, n):
        if min(m, k, n) >= 1:
            cases.append(KernelCase("matmul", int(m), int(k), int(n),
                                    dtype=dtype, label=f"{tag}/{name}"))

    kinds = set(cfg.kinds)
    if "attn" in kinds or "hybrid" in kinds:
        if cfg.mla is not None:
            # latent-attention path: low-rank down/up projections
            gemm("q_down", t, d, cfg.mla.q_lora_rank)
            gemm("q_up", t, cfg.mla.q_lora_rank,
                 cfg.n_heads * (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim))
            gemm("kv_up", t, cfg.mla.kv_lora_rank,
                 cfg.n_heads * (cfg.mla.qk_nope_dim + cfg.mla.v_head_dim))
            gemm("attn_out", t, cfg.n_heads * cfg.mla.v_head_dim, d)
        else:
            gemm("qkv", t, d, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd)
            gemm("attn_out", t, cfg.n_heads * hd, d)
    if "ssm" in kinds or "hybrid" in kinds:
        s = cfg.ssm
        if s is not None:
            d_in = s.expand * d
            gemm("ssm_in", t, d,
                 2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim)
            gemm("ssm_out", t, d_in, d)
    # ffn: per-expert hidden dim for MoE (what one expert's GEMM tiles
    # see), dense d_ff otherwise
    d_ff = cfg.moe.d_ff if cfg.moe is not None else cfg.d_ff
    if d_ff:
        gemm("ffn_up", t, d, d_ff)
        gemm("ffn_down", t, d_ff, d)
    return cases


def flash_case(cfg: ModelConfig, shape_name: str,
               *, arch_id: str = "") -> KernelCase | None:
    """The flash-attention call of one cell, or None when the cell has no
    attention score kernel to tile (SSM-only archs; decode's single-query
    attention is a different kernel family)."""
    shape = SHAPES[shape_name]
    kinds = set(cfg.kinds)
    if shape.kind not in ("train", "prefill"):
        return None
    if "attn" not in kinds and "hybrid" not in kinds:
        return None
    hd = cfg.mla.v_head_dim if cfg.mla is not None else cfg.head_dim
    tag = f"{arch_id or cfg.name}/{shape_name}"
    return KernelCase("flash", shape.seq_len, int(hd), shape.seq_len,
                      dtype=cfg.compute_dtype, batch=1, heads=cfg.n_heads,
                      causal=True, label=f"{tag}/flash")


def zoo_cases(arch_ids=None, shape_names=None,
              *, with_flash: bool = True) -> list[KernelCase]:
    """Every kernel case of the zoo cross-product, skipping cells each
    arch opts out of (``cfg.skip_shapes``).  ``None`` arguments mean the
    full zoo (all archs, all ``EVAL_SHAPES``)."""
    cases = []
    for arch_id in (arch_ids or ARCH_IDS):
        cfg = get_config(arch_id)
        for shape_name in (shape_names or EVAL_SHAPES):
            if shape_name in cfg.skip_shapes:
                continue
            cases.extend(gemm_cases(cfg, shape_name, arch_id=arch_id))
            if with_flash:
                fc = flash_case(cfg, shape_name, arch_id=arch_id)
                if fc is not None:
                    cases.append(fc)
    return cases
