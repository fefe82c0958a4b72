"""Train / serve step builders and the train state's sharding specs;
port of ``repro.train.step``.

``build_train_step(cfg, mesh, ...)`` returns a step that takes one
global batch through micro-batch gradient accumulation (in
``accum_dtype``), the model's remat, optional int8 gradient compression
with error feedback, and the AdamW update, as JAX's does, under the
context ``parallel.sharding.make_ctx`` builds for ``mesh`` (a
:mod:`repro_torch.launch.mesh` mesh, every shard on its one device;
the step runs there).  ``resolve_micro`` splits the global batch by the
mesh's data-parallel size, as the reference does, and
``state_specs`` / ``opt_specs`` give the state's specs (the int8 m and v
blocks' ``[*lead, nb, Q_BLOCK]`` rule included).  Only the exchanges
between cards wait for several cards (ROADMAP.md queue 1 item 9).

Gradients come from ``torch.autograd.grad`` over the parameter leaves in
JAX's leaf order; a leaf that the loss does not reach gets zeros, as
JAX's ``grad`` gives, and the step counts such leaves in its metrics
(``grads_missing``), so a path that drops a gradient shows.  The AdamW
update changes the parameters and the optimizer state in place; the
step returns the state dict with them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .. import tree as pt
from ..models import lm
from ..models.config import LMConfig
from ..optim import (AdamWConfig, adamw_init, adamw_update, compress_grads,
                     decompress_grads)
from ..optim.adamw import Q_BLOCK
from ..parallel import sharding as shard
from ..parallel.sharding import P


@dataclass(frozen=True)
class TrainConfig:
    micro_batches: int | None = None   # None -> auto (1 seq row / device)
    remat: bool = True
    accum_dtype: str = "float32"       # grad-accumulator dtype
    compress_grads: bool = False       # int8 + error feedback (cross-pod)
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    aux_weight: float = 0.01
    loss_chunk: int = 512              # xent chunking


def _dp_size(mesh, policy=None) -> int:
    dp_axes, _ = shard._axes(mesh, policy)
    return math.prod(mesh.shape[a] for a in dp_axes)


def resolve_micro(tcfg: TrainConfig, mesh, global_batch: int,
                  policy=None) -> int:
    """The configured count, or else one sequence per data-parallel row
    a micro-batch: the largest n <= global_batch // dp that splits the
    batch into micro-batches the data axes divide (1 if none does)."""
    if tcfg.micro_batches is not None:
        return tcfg.micro_batches
    dp = _dp_size(mesh, policy)
    n = max(1, global_batch // dp)
    while global_batch % n or (global_batch // n) % dp:
        n -= 1
        if n <= 1:
            return 1
    return n


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


def state_shapes(cfg: LMConfig, tcfg: TrainConfig):
    """:func:`init_train_state`'s tree as fake tensors (shapes, dtypes,
    no storage), for :func:`state_specs` of a full config."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return init_train_state(cfg, tcfg, torch.Generator(device="cpu"),
                                "cpu")


def opt_specs(param_specs_tree, params_shapes, tcfg: TrainConfig,
              mesh=None):
    """Optimizer-state specs mirror the parameter specs.  For int8 states
    the layout is [*lead, nb, Q_BLOCK]: the original last-dim sharding
    axis MOVES to the block-count dim, kept only where each shard's
    width is whole blocks."""
    def per_leaf(_, spec, p):
        def qspec():
            base = tuple(spec) + (None,) * (len(p.shape) - len(spec))
            lead = base[:-1] if base else ()
            last_ax = base[-1] if base else None
            width = p.shape[-1] if len(p.shape) else 1
            n = 1 if mesh is None else shard._axis_size(mesh, last_ax)
            nb_ax = last_ax if (last_ax is not None and
                                width % (n * Q_BLOCK) == 0) else None
            return {"q": P(*(lead + (nb_ax, None))),
                    "scale": P(*(lead + (nb_ax, None)))}
        m_spec = qspec() if tcfg.opt.m_dtype == "int8" else spec
        v_spec = qspec() if tcfg.opt.v_mode == "int8" else spec
        return {"m": m_spec, "v": v_spec}

    mu = shard._map(per_leaf, param_specs_tree, params_shapes)
    return {"mu": mu, "step": P()}


def state_specs(mesh, state_shapes, tcfg: TrainConfig,
                policy: shard.ShardingPolicy | None = None):
    """Specs of a train state (its tensors or :func:`state_shapes`)."""
    pspecs = shard.param_specs(mesh, state_shapes["params"], policy)
    out = {"params": pspecs,
           "opt": opt_specs(pspecs, state_shapes["params"], tcfg,
                            mesh=mesh)}
    if "err" in state_shapes:
        out["err"] = pspecs
    return out


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


def micro_batch(batch, i: int, n_micro: int) -> dict:
    """Micro-batch ``i`` of ``n_micro``: rows i*B/n .. (i+1)*B/n of every
    leaf."""
    return {k: v.reshape((n_micro, v.shape[0] // n_micro)
                         + tuple(v.shape[1:]))[i] for k, v in batch.items()}


def build_train_step(cfg: LMConfig, mesh, tcfg: TrainConfig | None = None,
                     policy: shard.ShardingPolicy | None = None,
                     global_batch: int | None = None):
    """Returns ``(train_step, ctx, n_micro)``; ``train_step(state,
    batch)`` -> (state, metrics {loss, grad_norm, lr, grads_missing}),
    the batch's tensors moved to the mesh's device, the state already
    there.  Its two halves are attributes of it: ``grads_of(state,
    batch, n_run=None)`` -> (loss, grads, missing), the mean over the
    micro-batches (only the first ``n_run`` run when given: the
    dry-run counts one and multiplies), and ``apply_grads(state, grads,
    loss, missing)``, compression and the AdamW update."""
    tcfg = tcfg or TrainConfig()
    dev = mesh.device
    ctx = shard.make_ctx(mesh, cfg, policy)

    def loss_fn(params, mb):
        return lm.train_loss(params, mb, cfg, ctx, remat=tcfg.remat,
                             aux_weight=tcfg.aux_weight,
                             loss_chunk=tcfg.loss_chunk)

    n_micro = resolve_micro(tcfg, mesh, global_batch, policy) \
        if global_batch else (tcfg.micro_batches or 1)
    acc_dt = torch.bfloat16 if tcfg.accum_dtype == "bfloat16" \
        else torch.float32

    def grads_of(state, batch, n_run=None):
        params = state["params"]
        if n_micro == 1:
            return value_and_grad(loss_fn, params, batch)
        gsum = pt.tree_map(lambda p: torch.zeros(
            p.shape, dtype=acc_dt, device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        missing = 0
        for i in range(n_micro if n_run is None else n_run):
            loss, g, miss = value_and_grad(loss_fn, params,
                                           micro_batch(batch, i, n_micro))
            gsum = pt.tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
            lsum = lsum + loss
            missing = max(missing, miss)
        grads = pt.tree_map(lambda g: g / n_micro, gsum)
        return lsum / n_micro, grads, missing

    def apply_grads(state, grads, loss, missing):
        new_state = dict(state)
        if tcfg.compress_grads:
            q, new_err = compress_grads(grads, state.get("err"))
            grads = decompress_grads(q, grads)
            new_state["err"] = new_err

        new_params, new_opt, metrics = adamw_update(state["params"], grads,
                                                    state["opt"], tcfg.opt)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, dict(metrics, loss=loss, grads_missing=missing)

    def train_step(state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads, missing = grads_of(state, batch)
        return apply_grads(state, grads, loss, missing)

    train_step.grads_of = grads_of
    train_step.apply_grads = apply_grads
    return train_step, ctx, n_micro


def build_serve_step(cfg: LMConfig, mesh,
                     policy: shard.ShardingPolicy | None = None):
    """Returns ``(serve_step, serve_prefill, ctx)`` for ``cfg`` on
    ``mesh``.  Token ids, and a prefill's ``patch_embeds`` and
    ``enc_embeds``, are moved to the mesh's device; parameters and
    caches must already live there.
    """
    dev = mesh.device
    ctx = shard.make_ctx(mesh, cfg, policy)

    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cache, tokens.to(dev), cfg, ctx)

    def serve_prefill(params, batch):
        batch = {k: v.to(dev) if k in ("tokens", "patch_embeds",
                                        "enc_embeds") else v
                 for k, v in batch.items()}
        return lm.prefill(params, batch, cfg, ctx)

    return serve_step, serve_prefill, ctx
