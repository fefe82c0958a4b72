"""RecurrentGemma blocks: RG-LRU recurrence + temporal conv + gating.

Port of ``repro.models.rglru``.  RG-LRU (De, Smith et al.,
arXiv:2402.19427):
    r_t = sigmoid(W_r x_t + b_r)            recurrence gate
    i_t = sigmoid(W_i x_t + b_i)            input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence with diagonal coefficients runs as a log-depth
(Hillis-Steele) scan over (a, b) pairs in fp32, as JAX's
``associative_scan`` does: ceil(log2 S) passes, never a running product
of a alone (``cumprod`` of a in (0, 1) underflows over long sequences).
Plain PyTorch on both devices: JAX computes this outside any Pallas
kernel.

On a model rank (tensor parallelism, ``ctx`` a layer's ``ParallelCtx``
that splits ``w_out``) the block runs the rank's block of the width
``W``: its columns of ``w_x``, ``w_gate``, ``w_conv``, ``b_r``, ``b_i``
and ``lam``, so the conv output is its block; that output is gathered
whole over the model ranks (its backward reduce-scatters), since
``w_r`` and ``w_i`` are dense ``[W, W]`` products whose columns the rank
holds; the scan runs on its block, and ``w_out`` is row-parallel.  Its
decode cache holds its block of ``hrec`` and of the conv tail, as the
reference's ``cache_specs`` split them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import gelu, keep_whole, normal, zeros

C_SCALE = 8.0


def _gates(r, i, lam, xf):
    log_a = -C_SCALE * F.softplus(lam.float()) * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    gated = torch.sigmoid(i.float()) * xf
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    return a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1,
    in ceil(log2 S) passes: pass j combines each element with the one
    2^j before it, (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rg_lru(x, r, i, lam, h0=None):
    """x, r, i: [B,S,W]; lam: [W].  Returns (y [B,S,W], h_last [B,W])."""
    a, b = _gates(r, i, lam, x.float())
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.float()
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(x, r, i, lam, h_prev):
    """One decode step: x,r,i: [B,W]; h_prev: [B,W] fp32."""
    a, b = _gates(r, i, lam, x.float())
    h = a * h_prev + b
    return h.to(x.dtype), h


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv width K.  cache: [B, K-1, W] tail or None."""
    k = w.shape[0]
    if cache is None:
        s = x.shape[1]
        y = x * w[-1]
        for j in range(1, k):
            shifted = F.pad(x, (0, 0, j, 0))[:, :s]
            y = y + shifted * w[-1 - j]
        return y, x[:, -(k - 1):, :]
    window = torch.cat([cache, x], dim=1)                    # [B,K,W]
    y = torch.einsum("bkw,kw->bw", window, w)[:, None]
    return y, window[:, 1:, :]


def recurrent_block(x, p, cfg, cache=None, ctx=None):
    """RG recurrent block.  Prefill: x [B,S,d], cache None.
    Decode: x [B,1,d], cache=(h [B,W] fp32, conv_tail [B,K-1,W]).
    Returns (out [B,S,d], (h_last fp32, conv tail)).  On a model rank
    (``ctx`` splits ``w_out``: the module's docstring) W is the rank's
    block."""
    tp = ctx is not None and ctx.split("w_out")
    if tp:
        from ..parallel import collectives as cl
        x = cl.enter(x, ctx.mesh, ctx.tp_axis)
    lru_in = x @ p["w_x"]                                    # [B,S,W]
    gate = gelu(x @ p["w_gate"])
    if cache is None:
        conv, tail = _causal_conv(lru_in, p["w_conv"])
    else:
        h_prev, conv_cache = cache
        conv, tail = _causal_conv(lru_in, p["w_conv"], conv_cache)
    whole = conv
    if tp and ctx.split("w_r"):
        whole, = cl.gather_blocks([conv], ctx.mesh, [2], ctx.tp_axis)
    if cache is None:
        r = whole @ p["w_r"] + p["b_r"]
        i = whole @ p["w_i"] + p["b_i"]
        y, h_last = rg_lru(conv, r, i, p["lam"])
    else:
        r = whole[:, 0] @ p["w_r"] + p["b_r"]
        i = whole[:, 0] @ p["w_i"] + p["b_i"]
        y1, h_last = rg_lru_step(conv[:, 0], r, i, p["lam"], h_prev)
        y = y1[:, None]
    out = (y * gate) @ p["w_out"]
    if tp:
        out = cl.sum_ranks(out, ctx.mesh, ctx.tp_axis)
    return out, (h_last, tail)


def init_recurrent(gen, cfg, dtype, stack=(), cut=keep_whole):
    """``cut(key, leaf)`` is applied to each leaf as soon as it is
    drawn."""
    d = cfg.d_model
    w = cfg.lru_width or d
    s = tuple(stack)
    p = {}
    p["w_x"] = cut("w_x", normal(gen, s + (d, w), d ** -0.5, dtype))
    p["w_gate"] = cut("w_gate", normal(gen, s + (d, w), d ** -0.5, dtype))
    p["w_conv"] = cut("w_conv", normal(gen, s + (cfg.conv_width, w), 0.1,
                                       dtype))
    p["w_r"] = cut("w_r", normal(gen, s + (w, w), w ** -0.5, dtype))
    p["w_i"] = cut("w_i", normal(gen, s + (w, w), w ** -0.5, dtype))
    p["b_r"] = cut("b_r", zeros(gen, s + (w,), dtype))
    p["b_i"] = cut("b_i", zeros(gen, s + (w,), dtype))
    # Lambda init so that a ~ U(0.9, 0.999)^(1/c) territory (paper App.)
    p["lam"] = cut("lam", torch.full(s + (w,), 0.7, dtype=torch.float32,
                                     device=gen.device))
    p["w_out"] = cut("w_out", normal(gen, s + (w, d), w ** -0.5, dtype))
    return p
