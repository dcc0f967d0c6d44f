"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window GQA.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1]
32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, SWA 4096.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=0,                       # every FFN is MoE
        vocab=32000,
        windows=(4096,) * 32,         # sliding-window attention
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff=14336,
            # 8 experts < 16-way model axis: shard each expert's d_ff
            # tensor-parallel instead of expert-parallel.
            shard_mode="tp",
        ),
        rope_theta=1e6,
        long_context_ok=True,         # SWA bounds the KV cache
        # 47B params: fsdp + ZeRO-style opt-state sharding to fit 16 GB HBM
        param_sharding="fsdp",
        train_microbatches=16,
    )
