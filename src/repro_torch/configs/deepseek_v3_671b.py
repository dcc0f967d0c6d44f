"""DeepSeek-V3 671B — MLA + 256-expert top-8 MoE (1 shared) + MTP.

[arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]
61L d_model=7168 128H (MLA) routed-expert d_ff=2048 vocab=129280.
First 3 layers are dense FFN (d_ff=18432, per the tech report); the remaining
58 layers use 256 routed experts (top-8) + 1 shared expert.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

_L = 61
_DENSE = 3   # leading dense layers (tech report §2.1)


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=_L,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_head=128,
        d_ff=0,
        dense_d_ff=18432,
        vocab=129280,
        moe_layers=tuple(i >= _DENSE for i in range(_L)),
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            d_ff=2048,
            n_shared=1,
            shard_mode="ep",          # 256 experts / 16-way model axis = 16 clean
            router="sigmoid",         # DeepSeek-V3 sigmoid routing
        ),
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        mtp_depth=1,                  # multi-token prediction module
        rope_theta=10000.0,
        skip_shapes=("long_500k",),   # MLA is full attention: no sub-quadratic path
        # 671B params: Adafactor + bf16 state is mandatory to fit 512x16 GB
        optimizer="adafactor",
        opt_dtype="bfloat16",
        grad_accum_dtype="bfloat16",  # fp32 accum (10.5 GB/chip) cannot fit
        param_sharding="fsdp",
        train_microbatches=16,
    )
