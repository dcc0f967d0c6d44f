"""Phi-3-Vision-4.2B — phi3-mini backbone + CLIP vision frontend (STUB).

[hf:microsoft/Phi-3-vision-128k-instruct]
32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064.
Per the assignment the modality frontend is a stub: ``input_specs()`` provides
precomputed patch embeddings [B, image_tokens, d_model] (CLIP ViT-L/14@336
yields 576 patches) which are prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab=32064,
        frontend="vision",
        image_tokens=576,
        rope_theta=10000.0,
        skip_shapes=("long_500k",),   # pure full attention
        train_microbatches=8,
    )
