"""Mamba2-370M — attention-free SSD (state-space duality) decoder.

[arXiv:2405.21060; unverified]
48L d_model=1024 vocab=50280, d_state=128, expand=2 (d_inner=2048),
head_dim=64 (32 SSM heads), conv=4.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=1,                     # unused (attn-free)
        n_kv_heads=1,
        d_ff=0,                        # mamba block replaces attn+ffn
        vocab=50280,
        layer_kinds=("ssm",) * 48,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        tie_embeddings=True,
        long_context_ok=True,          # O(1)-state decode
        train_microbatches=2,
    )
