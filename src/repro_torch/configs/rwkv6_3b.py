"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf].

Attention-free, data-dependent decay. The WKV recurrence has no sparse
matmul, but the channel-mix is squared ReLU, so the BARISTA two-sided
sparse path applies there: its hidden tensor has real zeros.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
    d_ff=8960, vocab=65536, act="relu2", block_pattern=("rwkv",),
    rwkv=True, sparse_ffn=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=512, act="relu2", block_pattern=("rwkv",),
        rwkv=True, sparse_ffn=True, dtype="float32",
    )
