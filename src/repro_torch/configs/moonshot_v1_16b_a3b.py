"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf].

MoE 64 experts top-6; expert placement uses BARISTA's greedy density
balancing (inter-filter load balance analogue) with round-robin rotation.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=163840, act="swiglu",
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, every=1),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=64, vocab=512, act="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, every=1,
                      capacity_factor=4.0),
        dtype="float32",
    )
