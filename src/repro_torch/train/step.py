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
blocks' ``[*lead, nb, Q_BLOCK]`` rule included).

Over ``torch.distributed`` ranks (a mesh with a ``group``) each rank
holds its block of every leaf that ``state_specs`` shards along a
ranked axis (``build_train_step``'s ``leaf_dims``; ``init_train_state(
..., mesh=)`` draws it, ``convert.rank_state`` cuts a whole state down):
along the model axis the routed experts (``experts=``, or
``convert.rank_experts``) and every other leaf whose spec names
``model`` (tensor parallelism, every family: the column-, row- and
vocab-parallel leaves, their m, v and error feedback; an int8 m or v
whole along the axis where a rank's width is not whole blocks),
along the data axis every leaf's ``fs`` dim (FSDP, as the reference's
``state_specs`` place the state), and everything else whole.  Along the
model axis every rank computes the same loss; the expert exchanges and
the tensor-parallel sums differentiate through
:mod:`repro_torch.parallel.collectives`, so a leaf replicated along it
gets the same gradient on every rank (``lm`` sums the share of a whole
leaf that acts on a rank's heads only).  Along the data
axis a rank takes its rows of the batch (``parallel.sharding.data_rows``;
micro-batches split them), gathers each layer's data blocks inside the
layer (``lm.train_loss``), and its loss is its share of the global one:
the gathers' backward reduce-scatters the blocks' gradients, one
``all_reduce`` over the data ranks sums the gradients of the leaves a
rank holds whole along data (norms, biases, the router, any dim that
``_div`` leaves unsharded), and the reported loss is all-reduced over
them.  The clip's global norm counts every distinct block once
(``optim.adamw.global_norm``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves in
JAX's leaf order; a leaf that the loss does not reach gets zeros, as
JAX's ``grad`` gives, and the step counts such leaves in its metrics
(``grads_missing``), so a path that drops a gradient shows.  The AdamW
update changes the parameters and the optimizer state in place; the
step returns the state dict with them.
"""

from __future__ import annotations

import dataclasses
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
                     generator: torch.Generator, device=None, experts=None,
                     mesh=None, policy: shard.ShardingPolicy | None = None):
    """{"params", "opt"} (+ "err", fp32 zeros, with compression) on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), the parameters
    drawn from ``generator``.  ``experts`` (``(first, stop)``) keeps
    only those routed experts, as :func:`lm.init_params` does (an
    expert-parallel rank's share, ``parallel.sharding.expert_block``); the
    optimizer state follows the parameters' shapes, so the state equals
    ``convert.rank_experts`` of the whole draw.  On a ``mesh`` with ranks
    along the data axis each leaf is cut to this rank's data block as
    soon as it is drawn (``lm.init_params(cut=)``: no whole copy of more
    than one stacked leaf at a time), and m and v follow the blocks, a
    leaf at a time; the state equals ``convert.rank_state`` of the whole
    draw under ``state_specs``, and so do the model blocks of the
    tensor-parallel leaves on ranks along the model axis."""
    axes = () if mesh is None else ranked_axes(cfg, mesh, policy)
    if not axes:
        params = lm.init_params(cfg, generator, device, experts=experts)
        state = {"params": params, "opt": adamw_init(params, tcfg.opt)}
    else:
        state = _init_blocks(cfg, tcfg, generator, device, experts, mesh,
                             policy, axes)
        params = state["params"]
    if tcfg.compress_grads:
        state["err"] = pt.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def ranked_axes(cfg, mesh, policy=None) -> tuple:
    """The axes along which a rank of ``mesh`` cuts ``cfg``'s leaves as it
    draws them: the data axes its ranks split, and the model axis where
    its ranks split it for tensor parallelism (the routed experts are
    drawn as the rank's share, ``experts=``); empty off ranks."""
    ctx = shard.make_ctx(mesh, cfg, policy)
    dp = ctx.dp_axis if isinstance(ctx.dp_axis, tuple) else (ctx.dp_axis,)
    axes = tuple(a for a in dp if mesh.n_ranks(a) > 1)
    return axes + ((ctx.tp_axis,) if ctx.tp is not None else ())


def rank_cut(cfg, mesh, axes, policy=None):
    """``lm.init_params``' ``cut``: each leaf cut to this rank's block
    along ``axes`` as soon as it is drawn (a routed expert never along
    the model axis: ``experts=`` drew the rank's share)."""
    from ..convert import rank_state

    def cut(key, leaf):
        spec = shard.param_specs(mesh, {key: leaf}, policy)[key]
        ax = tuple(a for a in axes if not (a == shard.EP_AXIS
                                           and key in shard.RANKED_KEYS))
        return rank_state(leaf, mesh, spec, axes=ax)
    return cut


def _init_blocks(cfg, tcfg, generator, device, experts, mesh, policy, axes):
    from ..convert import rank_state
    params = lm.init_params(cfg, generator, device, experts=experts,
                            cut=rank_cut(cfg, mesh, axes, policy))
    specs = state_specs(mesh, state_shapes(cfg, tcfg), tcfg, policy)
    flat, tree = pt.flatten(params)
    p_dims = pt.leaves(shard.rank_dims(mesh, specs["params"]))
    keys = pt.leaves(shard._map(lambda key, _: key, specs["params"]))
    mus = []
    for p, dims, key, ospec in zip(flat, p_dims, keys, pt.flatten_up_to(
            tree, specs["opt"]["mu"])):
        # the axes along which m and v are cut from their whole shape by
        # their own specs; along a ranked data axis they follow the
        # parameter's block, and a routed expert was drawn as the rank's
        # share along model
        ax = tuple(a for a in axes if a not in dims or (
            a == shard.EP_AXIS and key not in shard.RANKED_KEYS))
        shape = list(p.shape)               # the leaf whole along ax
        for a in ax:
            if a in dims:
                shape[dims[a]] *= mesh.n_ranks(a)
        mu = adamw_init(torch.zeros(shape, device=p.device), tcfg.opt)["mu"]
        mus.append(rank_state(mu, mesh, ospec, axes=ax))
        del mu
    return {"params": params, "opt": {
        "mu": pt.unflatten(tree, mus),
        "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}}


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
    """Specs of a train state, from the whole state's shapes (its
    tensors, or :func:`state_shapes`, as
    ``parallel.sharding.param_specs`` reads them)."""
    pspecs = shard.param_specs(mesh, state_shapes["params"], policy)
    out = {"params": pspecs,
           "opt": opt_specs(pspecs, state_shapes["params"], tcfg,
                            mesh=mesh)}
    if "err" in state_shapes:
        out["err"] = pspecs
    return out


def grad_digest(grads, ranked) -> dict:
    """sha256 digests (16 hex digits) of the gradient leaves' bytes, in
    JAX's leaf order: ``replicated``, one a leaf every rank holds whole
    (equal on every rank over ranks), and ``ranked``, one a rank's
    block."""
    import hashlib

    out = {"replicated": [], "ranked": []}
    for g, r in zip(pt.leaves(grads), ranked):
        t = g.detach().contiguous().cpu()
        raw = t.view(torch.uint8) if t.dim() else t.reshape(1).view(
            torch.uint8)
        out["ranked" if r else "replicated"].append(
            hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16])
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


def _data_dims(dims_tree):
    """A tree of each leaf's data dim (None where a rank holds it whole
    along data) from a tree of :class:`parallel.sharding.RankDims`."""
    if isinstance(dims_tree, dict):
        return {k: _data_dims(v) for k, v in dims_tree.items()}
    if isinstance(dims_tree, (list, tuple)):
        return [_data_dims(v) for v in dims_tree]
    return dims_tree.get("data")


def _sum_data_replicated(grads, dims, mesh, dp_axis):
    """``grads`` with every leaf summed over the ranked data axes that do
    not split it (``dims``: each leaf's RankDims, in JAX's leaf order):
    its shares of the global loss's gradient, in one fp32 ``all_reduce``
    for each set of such axes (a leaf held whole along data over the
    data ranks; with the model axis a data axis too,
    ``ShardingPolicy(tp_enable=False)``, a data block over the model
    ranks, its gather's reduce-scatter having summed the data ranks')."""
    flat, tree = pt.flatten(grads)
    dp = dp_axis if isinstance(dp_axis, tuple) else (dp_axis,)
    ranked = tuple(a for a in dp if mesh.n_ranks(a) > 1)
    groups = {}
    for i, d in enumerate(dims):
        over = tuple(a for a in ranked if a not in d)
        if over:
            groups.setdefault(over, []).append(i)
    out = list(flat)
    for over, idx in groups.items():
        buf = mesh.all_reduce(torch.cat([flat[i].float().reshape(-1)
                                         for i in idx]),
                              over if len(over) > 1 else over[0])
        at = 0
        for i in idx:
            n = flat[i].numel()
            out[i] = buf[at:at + n].view(flat[i].shape).to(flat[i].dtype)
            at += n
    return pt.unflatten(tree, out)


def _whole_states(dims) -> list:
    """Per parameter leaf, None, or ``(dim, axis, m_whole, v_whole)``
    where the rank holds the parameter as its block along ``axis`` (on
    its last dim ``dim``) but its m or v whole along it (``opt_specs``
    keeps an int8 state whole where a rank's width is not whole
    ``Q_BLOCK``s): that state is updated whole from the gathered
    gradient, and the parameter's block from its block."""
    def has(d, a):
        if isinstance(d, dict):
            return all(a in v for v in d.values())
        return a in d

    out = []
    for p, st in zip(dims["params"], dims["opt"]):
        got = None
        for a in p:
            m_whole, v_whole = (not has(st[k], a) for k in ("m", "v"))
            if m_whole or v_whole:
                got = (p[a], a, m_whole, v_whole)
        out.append(got)
    return out


def build_train_step(cfg: LMConfig, mesh, tcfg: TrainConfig | None = None,
                     policy: shard.ShardingPolicy | None = None,
                     global_batch: int | None = None):
    """Returns ``(train_step, ctx, n_micro)``; ``train_step(state,
    batch, grads_hook=None)`` -> (state, metrics {loss, grad_norm, lr,
    grads_missing}), the batch's tensors moved to the mesh's device, the
    state already there (``grads_hook(grads)``, when given, sees the
    step's gradients before the update).  Its two halves are attributes
    of it: ``grads_of(state, batch, n_run=None)`` -> (loss, grads,
    missing), the mean over the micro-batches (only the first ``n_run``
    run when given: the dry-run counts one and multiplies), and
    ``apply_grads(state, grads, loss, missing)``, compression and the
    AdamW update (over ranks with the clip's norm over every rank's
    blocks).  With ranks along the data axis ``batch`` is the global
    batch: ``grads_of`` keeps this rank's rows, returns the global loss
    and this rank's gradient blocks, the leaves it holds whole along
    data summed over the data ranks."""
    tcfg = tcfg or TrainConfig()
    dev = mesh.device
    ctx = shard.make_ctx(mesh, cfg, policy)
    data_ranked = ctx.data_ranks > 1
    n_micro = resolve_micro(tcfg, mesh, global_batch, policy) \
        if global_batch else (tcfg.micro_batches or 1)
    acc_dt = torch.bfloat16 if tcfg.accum_dtype == "bfloat16" \
        else torch.float32
    layout = {}                         # the leaves' rank blocks, lazily

    def leaf_dims():
        """{"params": each parameter leaf's RankDims, "tree": the
        parameters' data dims (``ctx.fsdp``), "opt": each leaf's m and
        v RankDims (a dict of them for int8 blocks)}, from the specs of
        the whole state (:func:`state_shapes`)."""
        if not layout:
            specs = state_specs(mesh, state_shapes(cfg, tcfg), tcfg,
                                policy)
            dims = shard.rank_dims(mesh, specs["params"])
            layout["params"], tree = pt.flatten(dims)
            layout["tree"] = _data_dims(dims)
            layout["opt"] = [{k: shard.rank_dims(mesh, mu[k])
                              for k in ("m", "v")}
                             for mu in pt.flatten_up_to(
                                 tree, specs["opt"]["mu"])]
        return layout

    if data_ranked:
        ctx = dataclasses.replace(ctx, fsdp=leaf_dims()["tree"])

    def loss_fn(params, mb, data_block=False):
        c = dataclasses.replace(ctx, data_block=True) if data_block else ctx
        return lm.train_loss(params, mb, cfg, c, remat=tcfg.remat,
                             aux_weight=tcfg.aux_weight,
                             loss_chunk=tcfg.loss_chunk)

    def grads_of(state, batch, n_run=None):
        params = state["params"]
        block = False
        if data_ranked:                 # this rank's rows
            b = next(iter(batch.values())).shape[0]
            rows = shard.data_rows(mesh, b, n_micro, policy)
            block = len(rows) < b
            if block:
                idx = torch.from_numpy(rows).to(dev)
                batch = {k: v.index_select(0, idx) for k, v in batch.items()}
        fn = lambda p, mb: loss_fn(p, mb, block)  # noqa: E731
        if n_micro == 1:
            loss, grads, missing = value_and_grad(fn, params, batch)
        else:
            gsum = pt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dt, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            missing = 0
            for i in range(n_micro if n_run is None else n_run):
                loss, g, miss = value_and_grad(fn, params,
                                               micro_batch(batch, i, n_micro))
                gsum = pt.tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
                lsum = lsum + loss
                missing = max(missing, miss)
            grads = pt.tree_map(lambda g: g / n_micro, gsum)
            loss = lsum / n_micro
        if data_ranked:
            grads = _sum_data_replicated(grads, leaf_dims()["params"], mesh,
                                         ctx.dp_axis)
            loss = mesh.all_reduce(loss.clone(), ctx.dp_axis)
        return loss, grads, missing

    def apply_grads(state, grads, loss, missing):
        new_state = dict(state)
        if tcfg.compress_grads:
            q, new_err = compress_grads(grads, state.get("err"))
            grads = decompress_grads(q, grads)
            new_state["err"] = new_err
        ranked = whole = None
        if getattr(mesh, "ranked", False):
            dims = leaf_dims()
            ranked = dims["params"]
            whole = _whole_states(dims)
        new_params, new_opt, metrics = adamw_update(
            state["params"], grads, state["opt"], tcfg.opt, mesh=mesh,
            ranked=ranked, whole_state=whole)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, dict(metrics, loss=loss, grads_missing=missing)

    def train_step(state, batch, grads_hook=None):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads, missing = grads_of(state, batch)
        if grads_hook is not None:
            grads_hook(grads)
        return apply_grads(state, grads, loss, missing)

    train_step.grads_of = grads_of
    train_step.apply_grads = apply_grads
    train_step.leaf_dims = leaf_dims
    return train_step, ctx, n_micro


def build_serve_step(cfg: LMConfig, mesh,
                     policy: shard.ShardingPolicy | None = None):
    """Returns ``(serve_step, serve_prefill, ctx)`` for ``cfg`` on
    ``mesh``.  Token ids, and a prefill's ``patch_embeds`` and
    ``enc_embeds``, are moved to the mesh's device; parameters and
    caches must already live there.  ``data_block=True`` (either step)
    says the rows are this data rank's block of the batch
    (``parallel.sharding.data_rows``), its cache rows its own.
    """
    dev = mesh.device
    ctx = shard.make_ctx(mesh, cfg, policy)
    rows_ctx = dataclasses.replace(ctx, data_block=True)

    def serve_step(params, cache, tokens, data_block=False):
        return lm.decode_step(params, cache, tokens.to(dev), cfg,
                              rows_ctx if data_block else ctx)

    def serve_prefill(params, batch, data_block=False):
        batch = {k: v.to(dev) if k in ("tokens", "patch_embeds",
                                        "enc_embeds") else v
                 for k, v in batch.items()}
        return lm.prefill(params, batch, cfg,
                          rows_ctx if data_block else ctx)

    return serve_step, serve_prefill, ctx
