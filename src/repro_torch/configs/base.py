"""Model configuration (port of ``repro.configs.base``).

Every architecture is a :class:`ModelConfig` in its own module
(``repro_torch/configs/<id>.py``) exposing ``CONFIG`` plus a ``smoke()``
reduced variant of the same family, field for field the reference's. All
ten of the reference's archs, in its order: dense GQA decoders (Qwen3-4B,
Yi-34B, H2O-Danube3-4B with a sliding window, Nemotron-4 with a squared-ReLU
FFN), MoE decoders (Moonlight-16B-A3B, Arctic-480B with a shared dense
FFN), the Mamba/attention/MoE hybrid Jamba-1.5-large, attention-free
RWKV6-3B, the vision-prefix PaliGemma-3B and the encoder-decoder
SeamlessM4T-medium.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch

ARCHS = [
    "seamless_m4t_medium", "jamba_1_5_large_398b", "nemotron_4_340b",
    "qwen3_4b", "h2o_danube_3_4b", "yi_34b", "moonshot_v1_16b_a3b",
    "arctic_480b", "rwkv6_3b", "paligemma_3b",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1              # MoE replaces FFN every N blocks
    shared_dense_ff: int = 0    # dense residual FFN alongside MoE
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    act: str = "swiglu"         # swiglu | geglu | relu2 | relu | gelu
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window attention
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # per-period block pattern, e.g. ("attn",) or ("attn",)+("mamba",)*7
    block_pattern: Tuple[str, ...] = ("attn",)
    encoder_layers: int = 0               # >0 => encoder-decoder
    frontend: Optional[str] = None        # audio | vision (stub embeddings)
    frontend_len: int = 0                 # prefix length contributed by stub
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # BARISTA sparse path: FFNs run through the packed two-sided kernels
    sparse_ffn: bool = False
    rwkv: bool = False

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 512 (the reference shards the embedding on a
        16/32-way axis; the port keeps its shape)."""
        return -(-self.vocab // 512) * 512

    @property
    def periods(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"repeat the pattern {self.block_pattern}")
        return self.n_layers // len(self.block_pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A workload's shape: sequence length, global batch and kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def load_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def load_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def _module(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r} (known: {', '.join(ARCHS)})")
    return importlib.import_module(f"repro_torch.configs.{name}")
