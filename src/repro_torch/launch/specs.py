"""``input_specs(arch, shape)``: the shape and dtype of every model input
of an (arch x shape) cell; port of ``repro.launch.specs`` (JAX's
``ShapeDtypeStruct`` stand-ins become :class:`TensorSpec`; nothing is
allocated).

For train: {tokens, labels} (+ the vlm family's patch_embeds, the
encdec family's enc_embeds).  For prefill: the prompt batch, the same
leaves.  For decode: a one-token batch and the KV / state cache of
seq_len positions, built by ``lm.init_decode_cache`` under
``FakeTensorMode`` (shapes and dtypes only: never allocated).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import tree as pt
from ..configs import get_config
from ..models import lm
from ..models.config import SHAPES, LMConfig, shape_applicable


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


def prefill_inputs(cfg: LMConfig, seq: int, batch: int) -> dict:
    return train_inputs(cfg, seq, batch)


def decode_inputs(cfg: LMConfig, seq: int, batch: int):
    """(cache, tokens): the cache's leaves for seq positions of history,
    and the one-token batch int32 [batch, 1]."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        cache = lm.init_decode_cache(cfg, batch, seq, device="cpu")
    cache = pt.tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                        cache)
    return cache, TensorSpec((batch, 1), torch.int32)


def input_specs(arch: str, shape_name: str):
    """(kind, {name: specs}) for the (arch x shape) cell: kind "train" or
    "prefill" with {"batch"}, "decode" with {"cache", "tokens"}.
    ``ValueError`` for a cell that :func:`shape_applicable` skips."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} skipped: {why}")
    if sh.kind == "train":
        return "train", {"batch": train_inputs(cfg, sh.seq_len,
                                               sh.global_batch)}
    if sh.kind == "prefill":
        return "prefill", {"batch": prefill_inputs(cfg, sh.seq_len,
                                                   sh.global_batch)}
    cache, tokens = decode_inputs(cfg, sh.seq_len, sh.global_batch)
    return "decode", {"cache": cache, "tokens": tokens}
