"""Jamba-1.5-large 398B [arXiv:2403.19887; hf].

Hybrid Mamba + attention (1:7 attn:mamba interleave), MoE 16e top-2 every
other block. BARISTA applies to the MoE experts (greedy density balancing
-> expert placement, ``sparsity.expert_balance``); the Mamba recurrence
itself has no sparse matmul. One full period (4 MoE blocks of 16 experts
at d_ff 24576) is ~77 GB in bf16, more than one 80 GB card holds.
"""
from repro_torch.configs.base import (MambaConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    block_pattern=("attn",) + ("mamba",) * 7,
    act="swiglu", tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, every=2,
                      capacity_factor=4.0),
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
        block_pattern=("attn",) + ("mamba",) * 7,
        act="swiglu", tie_embeddings=False, dtype="float32",
    )
