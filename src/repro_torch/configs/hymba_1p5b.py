"""Hymba-1.5B — hybrid heads: parallel attention + mamba in every layer.

[arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16,
128 learnable meta tokens.  Layers 0, 15, 31 use global attention; all other
layers use sliding-window (1024) attention.  The SSM and attention branches
run in parallel on the same input and their (normed) outputs are averaged.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

_L = 32
_GLOBAL = (0, 15, 31)


def get_config() -> ModelConfig:
    windows = tuple(0 if i in _GLOBAL else 1024 for i in range(_L))
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=_L,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        vocab=32001,
        layer_kinds=("hybrid",) * _L,
        windows=windows,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        meta_tokens=128,
        rope_theta=10000.0,
        long_context_ok=True,          # SSM + SWA (3 seq-sharded global layers)
        train_microbatches=4,
    )
