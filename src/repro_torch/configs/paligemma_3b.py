"""PaliGemma-3B [arXiv:2407.07726; hf].

Gemma decoder backbone; the SigLIP vision frontend is a stub that supplies
256 precomputed patch embeddings as a prefix (``prefix_embeds``),
which attends bidirectionally.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab=257216, act="geglu",
    frontend="vision", frontend_len=256,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab=512, act="geglu",
        frontend="vision", frontend_len=16, dtype="float32",
    )
