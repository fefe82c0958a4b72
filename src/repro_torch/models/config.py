"""Architecture config system (the port's copy of ``repro.models.config``,
data only, unchanged).

Every architecture is an :class:`LMConfig`; the model builder
(``models/lm.py``) consumes only this dataclass, so an architecture is a
config file under ``repro_torch/configs/``, nothing else.

Families:
  dense   — decoder-only transformer (GQA + RoPE [+ qk_norm])
  moe     — dense attention + mixture-of-experts FFN (shared + routed)
  ssm     — attention-free Mamba-2 (SSD) stack
  hybrid  — RecurrentGemma: RG-LRU blocks + local attention, 1:2 pattern
  vlm     — dense backbone; patch embeddings enter via input stub
  encdec  — encoder-decoder (audio frontend stubbed as frame embeddings)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    ffn_type: str = "swiglu"       # swiglu | geglu | gelu
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    rms_eps: float = 1e-6

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0             # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0             # N (state size per head)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (RecurrentGemma) ---------------------------------------------
    # layer pattern string, cycled over n_layers: 'r' = RG-LRU, 'a' = local attn
    layer_pattern: str = ""
    local_window: int = 2048
    lru_width: int = 0             # 0 -> d_model

    # --- enc-dec --------------------------------------------------------------
    n_enc_layers: int = 0          # 0 -> decoder-only
    enc_ratio: int = 4             # enc_len = dec_len // enc_ratio for specs

    # --- vlm -------------------------------------------------------------------
    n_patches: int = 0             # image soft tokens prepended (stub frontend)

    # --- numerics / padding ------------------------------------------------------
    dtype: str = "bfloat16"
    vocab_round: int = 256         # pad vocab so TP shards evenly

    # --- source annotation --------------------------------------------------------
    source: str = ""
    verified: str = ""             # hf | unverified

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def vocab_padded(self) -> int:
        r = self.vocab_round
        return ((self.vocab + r - 1) // r) * r

    @property
    def d_inner(self) -> int:      # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """May run the long_500k shape (sub-quadratic decode state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True                # all assigned archs autoregress

    def pattern_at(self, i: int) -> str:
        if not self.layer_pattern:
            return "u"              # uniform
        return self.layer_pattern[i % len(self.layer_pattern)]

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS = 6*N*D)."""
        d, hd, V = self.d_model, self.hd, self.vocab_padded
        def attn_params():
            return d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
        def ffn_params(ff):
            mults = 3 if self.ffn_type in ("swiglu", "geglu") else 2
            return mults * d * ff
        total = V * d                              # embed
        if not self.tie_embeddings:
            total += V * d                         # lm head
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn_params() + ffn_params(self.d_ff)
                                      + 2 * d)
        elif self.family == "moe":
            per_moe = ((self.n_experts + self.n_shared_experts)
                       * ffn_params(self.d_ff) + d * self.n_experts)
            total += self.n_layers * (attn_params() + per_moe + 2 * d)
        elif self.family == "ssm":
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            per = d * (2 * di + 2 * N + H) + di * d + self.conv_width * (
                di + 2 * N) + 2 * d
            total += self.n_layers * per
        elif self.family == "hybrid":
            lw = self.lru_width or d
            per_r = d * (2 * lw) + lw * d + 2 * lw + 2 * d   # gates+proj+lru
            per_a = attn_params() + 2 * d
            per_f = ffn_params(self.d_ff)
            n_r = sum(1 for i in range(self.n_layers)
                      if self.pattern_at(i) == "r")
            n_a = self.n_layers - n_r
            total += n_r * (per_r + per_f) + n_a * (per_a + per_f)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn_params() + ffn_params(self.d_ff)
                                       + 2 * d)
            dec = self.n_layers * (2 * attn_params()      # self + cross
                                   + ffn_params(self.d_ff) + 3 * d)
            total += enc + dec
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        mults = 3 if self.ffn_type in ("swiglu", "geglu") else 2
        expert = mults * self.d_model * self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return full - inactive


# ------------------------------------------------------------- shape grid

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: LMConfig, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (see DESIGN.md skips)."""
    if shape == "long_500k" and not cfg.is_subquadratic:
        return False, ("full-attention arch: 0.5M-token dense decode has no "
                       "sub-quadratic structure — skipped per brief")
    return True, ""
