"""Yi-6B — llama-architecture dense decoder with GQA.

[arXiv:2403.04652; hf:01-ai/Yi-6B]
32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=11008,
        vocab=64000,
        rope_theta=5e6,
        skip_shapes=("long_500k",),   # pure full attention
        train_microbatches=8,
    )
