"""H2O-Danube3-4B [arXiv:2401.16818; unverified].

Llama/Mistral-mix dense GQA with sliding-window attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
    d_ff=10240, vocab=32000, act="swiglu", window=4096,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, act="swiglu", window=32, dtype="float32",
    )
