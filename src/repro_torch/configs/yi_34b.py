"""Yi-34B [arXiv:2403.04652; hf]. Llama-architecture dense GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000, act="swiglu", rope_theta=5_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, act="swiglu", dtype="float32",
    )
