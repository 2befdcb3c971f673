"""Nemotron-4-340B [arXiv:2402.16819]. Dense GQA with a squared-ReLU FFN:
naturally sparse activations and prunable weights, so its FFN is two-sided
sparse. Only the smoke config runs in the port (the full one is 340B)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73728, vocab=256000, act="relu2", rope_theta=10_000.0,
    tie_embeddings=False, sparse_ffn=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512, act="relu2", tie_embeddings=False,
        sparse_ffn=True, dtype="float32",
    )
