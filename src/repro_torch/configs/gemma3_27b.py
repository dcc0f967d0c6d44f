"""Gemma-3-27B — dense decoder with 5:1 local:global attention pattern.

[hf:google/gemma-3-27b-pt; gemma3 tech report]
62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
Pattern: 5 sliding-window (1024) layers per 1 global layer; head_dim=128 per
the tech report (q/k/v project to n_heads*128, out-proj back to d_model).
"""
from repro_torch.configs.base import ModelConfig

_L = 62


def get_config() -> ModelConfig:
    # layers 5, 11, 17, ... are global (every 6th), rest are local w=1024
    windows = tuple(0 if (i % 6 == 5) else 1024 for i in range(_L))
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=_L,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=21504,
        vocab=262144,
        windows=windows,
        act="gelu",                   # GeGLU
        rope_theta=1e6,               # global layers
        local_rope_theta=10000.0,     # sliding-window layers
        scale_embeddings=True,
        # mostly-local: global layers use a sequence-sharded KV cache for
        # the long_500k cell (see DESIGN.md §6)
        long_context_ok=True,
        param_sharding="fsdp",        # 27B params
        train_microbatches=16,
    )
