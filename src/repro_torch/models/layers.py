"""Shared neural building blocks (plain PyTorch, functional).

Port of ``repro.models.layers``: the same numerics (normalisation in
fp32, cast back to the input dtype; products in the operands' dtype) and
the same parameter trees.  Initialisers draw from a ``torch.Generator``
and put every tensor on the generator's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    """Gemma-style RMS norm, ``y * (1 + scale)``, in fp32 inside."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def dense(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def gelu(x):
    """``jax.nn.gelu``'s default form (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def ffn_hidden(x, p, ffn_type: str):
    """The FFN's activation before ``wd`` (its columns are those of
    ``wg`` / ``wu``)."""
    if ffn_type == "swiglu":
        return F.silu(x @ p["wg"]) * (x @ p["wu"])
    if ffn_type == "geglu":
        return gelu(x @ p["wg"]) * (x @ p["wu"])
    if ffn_type == "gelu":
        return gelu(dense(x, p["wu"], p.get("bu")))
    raise ValueError(ffn_type)


def ffn(x, p, ffn_type: str):
    """p holds wg/wu/wd (+biases bu/bd optionally)."""
    return dense(ffn_hidden(x, p, ffn_type), p["wd"], p.get("bd"))


# --------------------------------------------------------------------- init

def normal(gen, shape, std, dtype):
    """fp32 normal draws times ``std``, cast to ``dtype``, on the
    generator's device."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


def zeros(gen, shape, dtype):
    return torch.zeros(tuple(shape), device=gen.device, dtype=dtype)


def _he(gen, shape, fan_in, dtype):
    return normal(gen, shape, 1.0 / math.sqrt(max(1, fan_in)), dtype)


def keep_whole(key, leaf):
    """The default ``cut`` of the init helpers: every leaf whole."""
    return leaf


def init_ffn(gen, d, ff, ffn_type, use_bias, dtype, stack=(),
             cut=keep_whole):
    """``cut(key, leaf)`` is applied to each leaf as soon as it is drawn
    (a rank's block of it), as in every init helper."""
    s = tuple(stack)
    p = {}
    if ffn_type in ("swiglu", "geglu"):
        p["wg"] = cut("wg", _he(gen, s + (d, ff), d, dtype))
        p["wu"] = cut("wu", _he(gen, s + (d, ff), d, dtype))
        p["wd"] = cut("wd", _he(gen, s + (ff, d), ff, dtype))
    else:
        p["wu"] = cut("wu", _he(gen, s + (d, ff), d, dtype))
        p["wd"] = cut("wd", _he(gen, s + (ff, d), ff, dtype))
        if use_bias:
            p["bu"] = cut("bu", zeros(gen, s + (ff,), dtype))
            p["bd"] = cut("bd", zeros(gen, s + (d,), dtype))
    return p


def init_attn(gen, d, n_heads, n_kv, hd, qk_norm, use_bias, dtype,
              stack=(), cut=keep_whole):
    s = tuple(stack)
    p = {}
    p["wq"] = cut("wq", _he(gen, s + (d, n_heads * hd), d, dtype))
    p["wk"] = cut("wk", _he(gen, s + (d, n_kv * hd), d, dtype))
    p["wv"] = cut("wv", _he(gen, s + (d, n_kv * hd), d, dtype))
    p["wo"] = cut("wo", _he(gen, s + (n_heads * hd, d), n_heads * hd,
                            dtype))
    if use_bias:
        p["bq"] = cut("bq", zeros(gen, s + (n_heads * hd,), dtype))
        p["bk"] = cut("bk", zeros(gen, s + (n_kv * hd,), dtype))
        p["bv"] = cut("bv", zeros(gen, s + (n_kv * hd,), dtype))
        p["bo"] = cut("bo", zeros(gen, s + (d,), dtype))
    if qk_norm:
        p["q_norm"] = cut("q_norm", zeros(gen, s + (hd,), dtype))
        p["k_norm"] = cut("k_norm", zeros(gen, s + (hd,), dtype))
    return p
