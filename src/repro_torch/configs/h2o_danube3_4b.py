"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA 4096.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_head=120,                   # 3840 / 32
        d_ff=10240,
        vocab=32000,
        windows=(4096,) * 24,
        rope_theta=10000.0,
        long_context_ok=True,         # SWA bounds the KV cache
        train_microbatches=8,
    )
