"""int8 gradient compression with error feedback; port of
``repro.optim.compress``.

Each gradient leaf plus its carried residual is quantized in flat blocks
of 256 (an fp32 scale per block, max |x| / 127), dequantized, and the
difference carried to the next step, as in JAX.  On one device nothing
crosses a wire: the round trip reproduces the numbers a multi-pod
reduction would see.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import tree as pt

BLOCK = 256


def _quant(x):
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return q, scale


def _dequant(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def compress_grads(grads, error=None):
    """Returns (a tree of {"q", "s"} per leaf, the new error-feedback
    tree of fp32 residuals)."""
    if error is None:
        error = pt.tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    flat_g, spec = pt.flatten(grads)
    pairs = []
    for g, e in zip(flat_g, pt.flatten_up_to(spec, error)):
        corrected = g.float() + e
        q, s = _quant(corrected)
        pairs.append(({"q": q, "s": s},
                      corrected - _dequant(q, s, tuple(g.shape))))
    return (pt.unflatten(spec, [p[0] for p in pairs]),
            pt.unflatten(spec, [p[1] for p in pairs]))


def decompress_grads(qtree, shapes_like):
    """fp32 gradients of ``shapes_like``'s structure and shapes from
    :func:`compress_grads`' blocks."""
    flat_s, spec = pt.flatten(shapes_like)
    qs = pt.flatten_up_to(spec, qtree)
    return pt.unflatten(spec, [_dequant(q["q"], q["s"], tuple(s.shape))
                               for q, s in zip(qs, flat_s)])

