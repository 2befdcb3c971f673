"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf].

128 experts top-2 with a dense residual FFN. The 128-expert EP axis is the
strongest stress of the paper's inter-filter load-imbalance story.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab=32000, act="swiglu",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864, every=1,
                  shared_dense_ff=4864),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=64, vocab=512, act="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, every=1,
                      shared_dense_ff=64, capacity_factor=4.0),
        dtype="float32",
    )
