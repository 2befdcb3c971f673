"""SeamlessM4T-medium backbone [arXiv:2308.11596; hf].

Encoder-decoder, multimodal; the speech frontend is a stub: the caller
passes precomputed frame embeddings (``src_embeds``). Classic ReLU FFNs
=> natural activation sparsity => the BARISTA two-sided sparse FFN applies
to every encoder and decoder FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=256206, act="relu", encoder_layers=12,
    frontend="audio", tie_embeddings=False, sparse_ffn=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=512, act="relu", encoder_layers=2,
        frontend="audio", tie_embeddings=False, sparse_ffn=True,
        dtype="float32",
    )
