"""Qwen3-4B [hf:Qwen/Qwen3-4B]. Dense GQA with qk-norm, SwiGLU.

SwiGLU has no zero-producing nonlinearity, so the sparse FFN is one-sided
(pruned weights) on its in/gate projections; the two-sided skip acts on
the padded rows of a decode block.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab=151936, act="swiglu", qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, act="swiglu", qk_norm=True, dtype="float32",
    )
