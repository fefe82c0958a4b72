"""``train_inputs(cfg, seq, batch)``: the shape and dtype of every
training input; port of ``repro.launch.specs.train_inputs`` (JAX's
``ShapeDtypeStruct`` stand-ins become :class:`TensorSpec`, nothing is
allocated).  The prefill and decode specs, which only the reference's
dry-run reads, wait with the port of the dry-run (ROADMAP.md queue 1
item 11).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import LMConfig


@dataclass(frozen=True)
class TensorSpec:
    shape: tuple
    dtype: torch.dtype


def train_inputs(cfg: LMConfig, seq: int, batch: int) -> dict:
    """{tokens, labels} int32 [batch, seq] (the vlm family's seq counts
    its n_patches patch embeddings, bf16; the encdec family adds
    max(1, seq // enc_ratio) bf16 encoder frames)."""
    toks = seq
    out = {}
    if cfg.family == "vlm":
        toks = seq - cfg.n_patches
        out["patch_embeds"] = TensorSpec((batch, cfg.n_patches, cfg.d_model),
                                         torch.bfloat16)
    if cfg.family == "encdec":
        out["enc_embeds"] = TensorSpec(
            (batch, max(1, seq // cfg.enc_ratio), cfg.d_model),
            torch.bfloat16)
    out["tokens"] = TensorSpec((batch, toks), torch.int32)
    out["labels"] = TensorSpec((batch, toks), torch.int32)
    return out
