"""Train / serve step builders; port of ``repro.train.step``.

``build_train_step`` returns a step that takes one global batch through
micro-batch gradient accumulation (in ``accum_dtype``), the model's
remat, optional int8 gradient compression with error feedback, and the
AdamW update, as JAX's does.  There is no mesh: the port trains on one
device (dp = 1), and ``resolve_micro`` resolves the micro-batch count
for that.  The sharding specs of the state (JAX's ``state_specs`` and
``opt_specs``) stay with the sharded stack, ROADMAP.md queue 1 item 9.

Gradients come from ``torch.autograd.grad`` over the parameter leaves in
JAX's leaf order; a leaf that the loss does not reach gets zeros, as
JAX's ``grad`` gives, and the step counts such leaves in its metrics
(``grads_missing``), so a path that drops a gradient shows.  The AdamW
update changes the parameters and the optimizer state in place; the
step returns the state dict with them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import resolve_device
from .. import tree as pt
from ..models import lm
from ..models.config import LMConfig
from ..optim import (AdamWConfig, adamw_init, adamw_update, compress_grads,
                     decompress_grads)


@dataclass(frozen=True)
class TrainConfig:
    micro_batches: int | None = None   # None -> auto (1 seq row / device)
    remat: bool = True
    accum_dtype: str = "float32"       # grad-accumulator dtype
    compress_grads: bool = False       # int8 + error feedback (cross-pod)
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    aux_weight: float = 0.01
    loss_chunk: int = 512              # xent chunking


def resolve_micro(tcfg: TrainConfig, global_batch: int) -> int:
    """JAX's rule with one data-parallel row: the configured count, or
    else one sequence per micro-batch."""
    if tcfg.micro_batches is not None:
        return tcfg.micro_batches
    return max(1, global_batch)


def init_train_state(cfg: LMConfig, tcfg: TrainConfig,
                     generator: torch.Generator, device=None):
    """{"params", "opt"} (+ "err", fp32 zeros, with compression) on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), the parameters
    drawn from ``generator``."""
    params = lm.init_params(cfg, generator, device)
    state = {"params": params, "opt": adamw_init(params, tcfg.opt)}
    if tcfg.compress_grads:
        state["err"] = pt.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def value_and_grad(loss_fn, params, batch):
    """(loss, grads, missing): the loss, a gradient for every leaf of
    ``params`` (zeros where the loss does not reach it) and the number
    of such leaves."""
    leaves, spec = pt.flatten(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    missing = sum(g is None for g in grads)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), pt.unflatten(spec, grads), missing


def build_train_step(cfg: LMConfig, tcfg: TrainConfig | None = None,
                     global_batch: int | None = None, device=None):
    """Returns ``(train_step, ctx, n_micro)``; ``train_step(state,
    batch)`` -> (state, metrics {loss, grad_norm, lr, grads_missing}),
    the batch's tensors moved to ``device`` (``cuda`` unless ``"cpu"``
    is asked for), the state already there."""
    tcfg = tcfg or TrainConfig()
    dev = resolve_device(device)
    ctx = lm.NO_PARALLEL

    def loss_fn(params, mb):
        return lm.train_loss(params, mb, cfg, ctx, remat=tcfg.remat,
                             aux_weight=tcfg.aux_weight,
                             loss_chunk=tcfg.loss_chunk)

    n_micro = resolve_micro(tcfg, global_batch) if global_batch \
        else (tcfg.micro_batches or 1)
    acc_dt = torch.bfloat16 if tcfg.accum_dtype == "bfloat16" \
        else torch.float32

    def train_step(state, batch):
        params = state["params"]
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if n_micro > 1:
            gsum = pt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            missing = 0
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss, g, miss = value_and_grad(loss_fn, params, mb)
                gsum = pt.tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
                lsum = lsum + loss
                missing = max(missing, miss)
            grads = pt.tree_map(lambda g: g / n_micro, gsum)
            loss = lsum / n_micro
        else:
            loss, grads, missing = value_and_grad(loss_fn, params, batch)

        new_state = dict(state)
        if tcfg.compress_grads:
            q, new_err = compress_grads(grads, state.get("err"))
            grads = decompress_grads(q, grads)
            new_state["err"] = new_err

        new_params, new_opt, metrics = adamw_update(params, grads,
                                                    state["opt"], tcfg.opt)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, dict(metrics, loss=loss, grads_missing=missing)

    return train_step, ctx, n_micro


def build_serve_step(cfg: LMConfig, device=None):
    """Returns ``(serve_step, serve_prefill, ctx)`` for ``cfg`` on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for).  Token ids, and a
    prefill's ``patch_embeds`` and ``enc_embeds``, are moved to the
    device; parameters and caches must already live there.
    """
    dev = resolve_device(device)
    ctx = lm.NO_PARALLEL

    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cache, tokens.to(dev), cfg, ctx)

    def serve_prefill(params, batch):
        batch = {k: v.to(dev) if k in ("tokens", "patch_embeds",
                                        "enc_embeds") else v
                 for k, v in batch.items()}
        return lm.prefill(params, batch, cfg, ctx)

    return serve_step, serve_prefill, ctx
