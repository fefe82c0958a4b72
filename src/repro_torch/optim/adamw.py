"""AdamW with memory-tiered optimizer state; port of
``repro.optim.adamw``.

State tiers (per-tensor, uniform across the tree), as in JAX:
  m: fp32 (default), bf16, or int8 signed blocks
  v: fp32 (default) or int8 blocks of sqrt(v) (128-wide blocks along the
     last axis, an fp32 scale per block; layout [*lead, nb, Q_BLOCK], so
     the state keeps the parameter's leading dims)

The arithmetic is JAX's, in fp32: the global norm over every gradient
leaf, summed in JAX's leaf order (sorted dict keys; over ranks the
expert blocks' partial sums all-reduced first), clipping, the bias
corrections, and weight decay on every leaf.  :func:`adamw_update`
updates the parameters and the state in place (JAX's is functional), a
leaf at a time and a large leaf in slices of its leading axis of at most
``SLICE`` elements (int8 blocks run along the last axis, so a slice holds
whole blocks), so a step never holds a second copy of the parameters or
of m and v, and its fp32 temporaries stay near 4 x ``SLICE`` bytes each
(Mamba2-2.7B's stacked input projection alone is 1.73 G parameters).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import tree as pt

Q_BLOCK = 128
SLICE = 1 << 26            # elements of a leaf updated at once


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    m_dtype: str = "float32"        # float32 | bfloat16 | int8 (signed blocks)
    v_mode: str = "float32"         # float32 | int8


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warmup, then a cosine from lr down to 0.1 lr, in fp32 (a
    0-d tensor on ``step``'s device)."""
    step = step.float()
    dev = step.device
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# --------------------------------------------------- int8 block quantization

def quantize_v(v, signed: bool = False):
    """signed=False (second moment): blocks of sqrt(v), scaled to
    [0, 127]; signed=True (first moment): symmetric linear blocks.
    Returns {"q": int8 [*lead, nb, Q_BLOCK], "scale": fp32 [*lead, nb, 1]}
    (the last axis zero-padded to a multiple of Q_BLOCK)."""
    v = v.float()
    if not signed:
        v = torch.sqrt(torch.clamp(v, min=0.0))
    *lead, last = v.shape
    pad = (-last) % Q_BLOCK
    if pad:
        v = F.pad(v, (0, pad))
    blocks = v.reshape(*lead, (last + pad) // Q_BLOCK, Q_BLOCK)
    mag = blocks.abs() if signed else blocks
    scale = mag.amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize_v(qv, shape, signed: bool = False):
    """The fp32 tensor of ``shape`` back from :func:`quantize_v`'s blocks;
    unsigned (sqrt-space) values are floored at a quarter step, so a
    small true value becomes a small denominator, never zero."""
    *lead, last = shape
    s = qv["q"].float() * qv["scale"]
    if signed:
        out = s
    else:
        floored = torch.maximum(s, 0.25 * qv["scale"])
        out = floored * floored
    return out.reshape(*lead, -1)[..., :last]


# ------------------------------------------------------------------ adamw

def adamw_init(params, cfg: AdamWConfig):
    """{"mu": a {"m", "v"} dict per parameter leaf, "step": int32 0},
    every tensor on its parameter's device."""
    def init_leaf(p):
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.m_dtype == "int8":
            m = quantize_v(zeros, signed=True)
        else:
            m = torch.zeros(p.shape, device=p.device, dtype=(
                torch.bfloat16 if cfg.m_dtype == "bfloat16"
                else torch.float32))
        v = quantize_v(zeros) if cfg.v_mode == "int8" else zeros
        return {"m": m, "v": v}
    dev = pt.leaves(params)[0].device
    return {"mu": pt.tree_map(init_leaf, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, mesh=None, ranked=None):
    """sqrt of the sum of squares of every leaf, in fp32, the leaves'
    sums stacked in JAX's leaf order.  Over a ranked ``mesh``,
    ``ranked`` (a bool a leaf, in that order) marks the leaves that a
    rank holds as its block: their sums are partial, and one
    ``all_reduce`` of their vector makes them whole before the same
    stack and sum, so every rank gets the same norm; a leaf every rank
    holds whole counts once."""
    sums = [x.float().square().sum() for x in pt.leaves(tree)]
    idx = [i for i, r in enumerate(ranked or ()) if r]
    if idx and mesh is not None and mesh.ranked:
        whole = mesh.all_reduce(torch.stack([sums[i] for i in idx]))
        for j, i in enumerate(idx):
            sums[i] = whole[j]
    return torch.sqrt(torch.stack(sums).sum())


def _copy_into(dst, src):
    """Write ``src`` into the state leaf (or {"q", "scale"} dict) dst."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


def _slices(p):
    """Slices of p's leading axis of at most SLICE elements each (one
    row at least); the whole leaf when it is small or 1-D."""
    if p.dim() < 2 or p.numel() <= SLICE:
        return [slice(None)]
    rows = max(1, SLICE // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _at(state, sl):
    """A state leaf (or {"q", "scale"} dict) at rows ``sl``."""
    if isinstance(state, dict):
        return {k: v[sl] for k, v in state.items()}
    return state[sl]


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, mesh=None,
                 ranked=None):
    """One AdamW step: ``params`` and ``state`` (from :func:`adamw_init`)
    are updated in place; ``grads`` is a tree of the params' structure.
    Over a ranked ``mesh`` the clip's norm is :func:`global_norm`'s over
    the whole gradient (``ranked``: the leaves held as rank blocks); the
    update itself stays local.  Returns (params, state, {"grad_norm",
    "lr"})."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads, mesh, ranked)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(_f32(cfg.b1, step.device), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, step.device), stepf)

    flat_p, spec = pt.flatten(params)
    flat_g = pt.flatten_up_to(spec, grads)
    mus = pt.flatten_up_to(spec, state["mu"])
    for p_leaf, g_leaf, mu in zip(flat_p, flat_g, mus):
        for sl in _slices(p_leaf):
            p, m_st, v_st = p_leaf[sl], _at(mu["m"], sl), _at(mu["v"], sl)
            g = g_leaf[sl].float() * scale
            if cfg.m_dtype == "int8":
                m = dequantize_v(m_st, p.shape, signed=True)
            else:
                m = m_st.float()
            v = dequantize_v(v_st, p.shape) if cfg.v_mode == "int8" \
                else v_st
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g.square()
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            _copy_into(m_st, quantize_v(m, signed=True)
                       if cfg.m_dtype == "int8" else m)
            _copy_into(v_st, quantize_v(v) if cfg.v_mode == "int8" else v)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

