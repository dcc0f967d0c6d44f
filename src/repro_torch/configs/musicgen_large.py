"""MusicGen-Large — decoder-only transformer over EnCodec tokens (4 codebooks).

[arXiv:2306.05284; hf:facebook/musicgen-large]
48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 (per codebook).
The EnCodec frontend is a stub per the assignment: inputs are the 4 parallel
codebook token streams [B, K=4, T] (delay pattern applied upstream); the model
sums the K codebook embeddings and emits K parallel heads.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab=2048,
        frontend="audio",
        n_codebooks=4,
        act="gelu",
        rope_theta=10000.0,
        skip_shapes=("long_500k",),   # pure full attention
        train_microbatches=8,
    )
