"""Mixture-of-Experts FFN, capacity-based (Switch-style) dispatch.

Port of ``repro.models.moe`` on one device: ``_moe_local`` runs with a
single shard and the identity in place of the all-to-all, and
``moe_ffn`` with an expert-parallel context raises (the sharded stack
waits for ROADMAP.md queue 1 item 9).

Layout contract, as in JAX:
  tokens x        : [B, S, d]
  router          : [d, E]      fp32
  routed experts  : [E, d, ff]
  shared experts  : dense ffn params (``s_`` prefix), ff_total =
                    n_shared * d_ff

The router runs in fp32 (softmax, top-k by a stable descending sort so
that ties keep the lower expert index first, as ``jax.lax.top_k`` does,
then a renormalisation).  An assignment's slot is its rank among the
assignments to its expert in flat (token, k) order; slots past the
capacity drop.  The expert products are batched matmuls in the
parameters' dtype, as JAX leaves them to XLA: this module has no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers


def _capacity(tokens: int, k: int, n_experts: int, cf: float) -> int:
    c = int(tokens * k * cf / n_experts) + 1
    return max(4, (c + 3) // 4 * 4)


def _top_k(gates, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties in
    ascending index order (``torch.topk`` promises no order on ties)."""
    order = torch.sort(gates, dim=-1, descending=True, stable=True).indices
    top_e = order[..., :k]
    return gates.gather(-1, top_e), top_e


def _dispatch(x_tok, logits, k: int, n_experts: int, capacity: int):
    """Token -> (expert, slot) scatter.  x_tok:[T,d] logits fp32 [T,E].
    Returns the [E, C, d] buffer, the route (flat_tok, e_idx, s_idx,
    flat_w, keep; each [T*K]) and the load-balance aux loss."""
    t = x_tok.shape[0]
    gates = torch.softmax(logits, dim=-1)                       # [T,E]
    top_w, top_e = _top_k(gates, k)                             # [T,K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(-1)                                  # [T*K]
    flat_w = top_w.reshape(-1)
    flat_tok = torch.arange(t, device=x_tok.device).repeat_interleave(k)
    # slot index of each assignment within its expert (stable order)
    onehot = F.one_hot(flat_e, n_experts)                       # [T*K,E]
    pos_all = torch.cumsum(onehot, dim=0) - 1
    slot = pos_all.gather(1, flat_e[:, None])[:, 0]
    keep = slot < capacity
    # scatter tokens into [E, C, d]; a dropped assignment adds 0 at
    # [0, C-1], as JAX's scatter-add does
    buf = torch.zeros((n_experts, capacity, x_tok.shape[1]),
                      dtype=x_tok.dtype, device=x_tok.device)
    e_idx = torch.where(keep, flat_e, 0)
    s_idx = torch.where(keep, slot, capacity - 1)
    src = torch.where(keep[:, None], x_tok[flat_tok], 0).to(x_tok.dtype)
    buf.index_put_((e_idx, s_idx), src, accumulate=True)
    # load-balance aux (Switch): E * sum_e f_e * p_e
    f = onehot.float().mean(dim=0) * k
    p_mean = gates.mean(dim=0)
    aux = n_experts * (f * p_mean).sum() / k
    return buf, (flat_tok, e_idx, s_idx, flat_w, keep), aux


def _combine(y_buf, route, t: int):
    """Each token's kept expert outputs, weighted, added in the buffer's
    dtype in (token, k) order, as JAX's scatter-add adds them."""
    flat_tok, e_idx, s_idx, flat_w, keep = route
    vals = y_buf[e_idx, s_idx]                                  # [T*K,d]
    vals = vals * torch.where(keep, flat_w, 0.0)[:, None].to(vals.dtype)
    vals = vals.reshape(t, -1, y_buf.shape[-1])                 # [T,K,d]
    out = torch.zeros((t, y_buf.shape[-1]), dtype=y_buf.dtype,
                      device=y_buf.device)
    for j in range(vals.shape[1]):
        out = out + vals[:, j]
    return out


def _silu(x):
    """``jax.nn.silu`` as JAX evaluates it, ``x * (1 / (1 + exp(-x)))``
    with each step rounded to the input's dtype.  In bf16 that sigmoid
    lands up to 2.6 steps from the exact one, and ``F.silu`` (rounded
    once) differs from JAX by a bf16 step in a third of the elements;
    ``moe_ffn``'s direct bf16 comparison (2e-2 of max(1, |want|)) sees
    that, so the experts take JAX's steps.  Everywhere else the port
    keeps the one fused ``F.silu``: its whole-model tolerance absorbs
    the difference, and the dense FFN runs in every decode step."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _expert_ffn(xin, pg, pu, pd, ffn_type):
    if ffn_type in ("swiglu", "geglu"):
        act = _silu if ffn_type == "swiglu" else layers.gelu
        h = act(torch.bmm(xin, pg)) * torch.bmm(xin, pu)
    else:
        h = layers.gelu(torch.bmm(xin, pu))
    return torch.bmm(h, pd)


def _moe_local(x, p, cfg):
    """One shard's body with the identity all-to-all. x:[b, s, d]."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    cap = _capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    logits = xt.float() @ p["router"].float()
    buf, route, aux = _dispatch(xt, logits, cfg.top_k, cfg.n_experts, cap)
    y_buf = _expert_ffn(buf, p.get("we_g"), p.get("we_u"), p["we_d"],
                        cfg.ffn_type)
    out = _combine(y_buf, route, t)
    return out.reshape(b, s, d), aux


def moe_ffn(x, p, cfg, parallel=None):
    """x: [B,S,d].  ``parallel`` must be None: one device, one shard.
    Returns (y [B,S,d], aux)."""
    if parallel is not None:
        raise NotImplementedError(
            "expert parallelism waits for the sharded stack (ROADMAP.md "
            "queue 1 item 9)")
    routed = {k: p[k] for k in ("router", "we_g", "we_u", "we_d") if k in p}
    y, aux = _moe_local(x, routed, cfg)
    if cfg.n_shared_experts:
        shared = {k.replace("s_", ""): v for k, v in p.items()
                  if k.startswith("s_")}
        y = y + layers.ffn(x, shared, cfg.ffn_type)
    return y, aux


def init_moe(gen, cfg, dtype, stack=()):
    """Router (fp32, std 0.02), routed experts (He-scaled) and shared
    experts, on the generator's device.  Stacked expert leaves are drawn
    one leading index at a time, so no fp32 copy of a whole stack
    exists (deepseek-moe-16b's [28, 64, 2048, 1408] would need 20.7 GB)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = tuple(stack)

    def he(shape, fan):
        out = torch.empty(s + shape, dtype=dtype, device=gen.device)
        for leaf in out.view(-1, *shape):
            leaf.copy_(layers.normal(gen, shape, fan ** -0.5, dtype))
        return out

    p = {"router": layers.normal(gen, s + (d, e), 0.02, torch.float32)}
    if cfg.ffn_type in ("swiglu", "geglu"):
        p["we_g"] = he((e, d, ff), d)
    p["we_u"] = he((e, d, ff), d)
    p["we_d"] = he((e, ff, d), ff)
    if cfg.n_shared_experts:
        sh = layers.init_ffn(gen, d, ff * cfg.n_shared_experts,
                             cfg.ffn_type, cfg.use_bias, dtype, stack=stack)
        p.update({f"s_{k}": v for k, v in sh.items()})
    return p
