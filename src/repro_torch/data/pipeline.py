"""Deterministic synthetic data pipeline (port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step): any host can regenerate
any batch at any time, so a restart recomputes its data from the step
counter (which the checkpoint holds) with no data-loader state.

Synthetic text is a Zipf-ish token stream with a learnable "follow" rule
(the loss falls over steps). The draws come from numpy's Philox keyed on
(seed, step), not from ``jax.random``'s threefry: the construction is the
reference's, the tokens are not (tests feed both packages one numpy
batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

PERM_STEP = 2 ** 64 - 1        # the key word of the follow permutation


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(
        key=np.array([seed, step], dtype=np.uint64)))


def synth_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """[global_batch, seq_len + 1] int32 (inputs and shifted labels).

    A Zipf-ish marginal from a squared uniform; on a random half of the
    positions the next token follows a FIXED (per seed, step-independent)
    permutation of the current one, a rule the model learns over steps.
    """
    rng = _rng(cfg.seed, step)
    B, S = cfg.global_batch, cfg.seq_len + 1
    u = rng.random((B, S), dtype=np.float32)
    toks = (u * u * (cfg.vocab - 2)).astype(np.int32) + 1
    perm = _rng(cfg.seed, PERM_STEP).permutation(cfg.vocab)
    follow = rng.random((B, S - 1)) < 0.5
    nxt = np.where(follow, perm[toks[:, :-1]] % cfg.vocab, toks[:, 1:])
    return np.concatenate([toks[:, :1], nxt], axis=1).astype(np.int32)


def batch_for(model_cfg: ModelConfig, shape: ShapeConfig, step: int,
              seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """The train batch of ``step`` on ``device``: ``tokens`` and
    ``labels`` [B, S_text] int64, and the frontend's stub embeddings
    (``0.02 * N(0, 1)``, fp32, at d_model) where the config has one:
    ``prefix_embeds`` [B, frontend_len, D] (vision) or ``src_embeds`` [B,
    seq_len, D] (encoder-decoder)."""
    text_len = shape.seq_len
    if model_cfg.frontend == "vision":
        text_len = shape.seq_len - model_cfg.frontend_len
    dc = DataConfig(model_cfg.vocab, text_len, shape.global_batch, seed)
    full = torch.as_tensor(synth_tokens(dc, step).astype(np.int64))
    out = {"tokens": full[:, :-1], "labels": full[:, 1:]}
    B, D = shape.global_batch, model_cfg.d_model
    if model_cfg.frontend == "vision":
        out["prefix_embeds"] = torch.as_tensor(0.02 * _rng(seed, step)
            .standard_normal((B, model_cfg.frontend_len, D), np.float32))
    if model_cfg.encoder_layers:
        out["src_embeds"] = torch.as_tensor(0.02 * _rng(seed, step)
            .standard_normal((B, shape.seq_len, D), np.float32))
    return {k: v.contiguous().to(device) for k, v in out.items()}


def input_specs(model_cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors standing in for every model input (shapes and dtypes,
    no allocation)."""
    def spec(*shp, dtype=torch.int64):
        return torch.empty(shp, dtype=dtype, device="meta")

    B = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": spec(B, 1)}
    text_len = shape.seq_len
    if model_cfg.frontend == "vision":
        text_len -= model_cfg.frontend_len
    out = {"tokens": spec(B, text_len)}
    if shape.kind == "train":
        out["labels"] = spec(B, text_len)
    if model_cfg.frontend == "vision":
        out["prefix_embeds"] = spec(B, model_cfg.frontend_len,
                                    model_cfg.d_model, dtype=torch.float32)
    if model_cfg.encoder_layers:
        out["src_embeds"] = spec(B, shape.seq_len, model_cfg.d_model,
                                 dtype=torch.float32)
    return out
