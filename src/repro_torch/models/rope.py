"""Rotary position embeddings (applied on head_dim, half-rotation form),
with the angles in fp32; port of ``repro.models.rope``."""

from __future__ import annotations

import torch


def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                # [hd/2]
    ang = positions.float()[..., None] * inv             # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                   # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
