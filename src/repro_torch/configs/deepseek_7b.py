"""DeepSeek-LLM-7B — llama-architecture dense decoder (MHA).

[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-7b-base]
30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_head=128,
        d_ff=11008,
        vocab=102400,
        rope_theta=10000.0,
        skip_shapes=("long_500k",),   # pure full attention
        train_microbatches=8,
    )
