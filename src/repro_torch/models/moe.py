"""Mixture-of-Experts FFN, capacity-based (Switch-style) dispatch, with
expert parallelism (EP); port of ``repro.models.moe``.

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

With no context (or ``ep`` 1) one shard routes every token.  Under an
expert-parallel context (:func:`moe_ffn`, ``parallel.ep > 1``) the
reference shards the tokens over (data, model) inside ``shard_map``:
each shard routes its own tokens against a capacity taken from its own
token count, and expert groups move between the model-axis shards
through two ``all_to_all``s.  On the port's one device the shards are a
leading group axis: every group routes at once through :func:`_dispatch`,
the first ``all_to_all`` is a transpose of the source and destination
shard axes (each destination gets its experts' slots source-major, as
the reference's ``recv.transpose(1, 0, 2, 3)`` orders them), every
expert's slots over every data row go through one batched product, and
the second ``all_to_all`` is the transpose back.  Where the tokens are
replicated along an axis (the batch when dp does not divide it, the
sequence when ep does not, as in a decode step) every shard along it
computes the same thing, so the port computes it once.

On a mesh whose model axis is split over ``torch.distributed`` ranks
(``Mesh(..., group=...)``), rank ``r`` holds the model shards ``[r*n/W,
(r+1)*n/W)`` and their experts (``n_experts / W`` of ``we_g``, ``we_u``
and ``we_d``; ``convert.rank_experts`` cuts a whole set down), the rest
of the layer on every rank.  Each rank routes its model shards' tokens,
the first ``all_to_all`` sends every destination rank the slots of its
experts (``all_to_all_single``), the experts run where they live, the
second sends the results back, and an all-gather of the token blocks
(and an ``all_reduce`` of ``aux``) gives every rank the whole output.
Where the sequence is replicated along the model axis, every rank
routes the same tokens, runs its own experts on their slots and
all-gathers the experts' results.  Every move across ranks (the block
slices of a replicated tensor included) is one of
:mod:`repro_torch.parallel.collectives`' autograd functions, so the
routed path's gradient reaches ``x``, the router and every layer below:
a replicated tensor's gradient is the same on every rank.
"""

from __future__ import annotations

import math

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
    """Token -> (expert, slot) scatter.  x_tok [..., T, d], logits fp32
    [..., T, E]: each leading index (a shard) routes its own T tokens.
    Returns the [..., E, C, d] buffer, the route (flat_tok [T*K];
    e_idx, s_idx, flat_w, keep [..., T*K]) and the load-balance aux
    loss [...]."""
    lead, (t, d) = x_tok.shape[:-2], x_tok.shape[-2:]
    gates = torch.softmax(logits, dim=-1)                       # [..,T,E]
    top_w, top_e = _top_k(gates, k)                             # [..,T,K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(*lead, t * k)                        # [..,T*K]
    flat_w = top_w.reshape(*lead, t * k)
    flat_tok = torch.arange(t, device=x_tok.device).repeat_interleave(k)
    # slot index of each assignment within its expert (stable order)
    onehot = F.one_hot(flat_e, n_experts)                       # [..,T*K,E]
    pos_all = torch.cumsum(onehot, dim=-2) - 1
    slot = pos_all.gather(-1, flat_e[..., None])[..., 0]
    keep = slot < capacity
    # scatter tokens into [E, C, d]; a dropped assignment adds 0 at
    # [0, C-1], as JAX's scatter-add does
    buf = torch.zeros((*lead, n_experts, capacity, d),
                      dtype=x_tok.dtype, device=x_tok.device)
    e_idx = torch.where(keep, flat_e, 0)
    s_idx = torch.where(keep, slot, capacity - 1)
    src = torch.where(keep[..., None], x_tok[..., flat_tok, :],
                      0).to(x_tok.dtype)
    buf.index_put_(_group_index(lead, x_tok.device) + (e_idx, s_idx), src,
                   accumulate=True)
    # load-balance aux (Switch): E * sum_e f_e * p_e
    f = onehot.float().mean(dim=-2) * k
    p_mean = gates.mean(dim=-2)
    aux = n_experts * (f * p_mean).sum(-1) / k
    return buf, (flat_tok, e_idx, s_idx, flat_w, keep), aux


def _group_index(lead, device):
    """Index tensors over at most one leading group axis, broadcastable
    against [G, T*K] (none for a single shard)."""
    if not lead:
        return ()
    (g,) = lead
    return (torch.arange(g, device=device)[:, None],)


def _combine(y_buf, route, t: int):
    """Each token's kept expert outputs, weighted, added in the buffer's
    dtype in (token, k) order, as JAX's scatter-add adds them.  y_buf
    [..., E, C, d] -> [..., T, d]."""
    flat_tok, e_idx, s_idx, flat_w, keep = route
    lead, d = y_buf.shape[:-3], y_buf.shape[-1]
    vals = y_buf[_group_index(lead, y_buf.device) + (e_idx, s_idx)]
    vals = vals * torch.where(keep, flat_w, 0.0)[..., None].to(vals.dtype)
    vals = vals.reshape(*lead, t, -1, d)                        # [..,T,K,d]
    out = torch.zeros((*lead, t, d), dtype=y_buf.dtype,
                      device=y_buf.device)
    for j in range(vals.shape[-2]):
        out = out + vals[..., j, :]
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


def ep_layout(x_shape, parallel):
    """(nb, ns, n): the data-axis and model-axis shard counts that hold
    distinct tokens of x [B, S, d] under ``parallel``, and the EP degree.
    The reference shards the batch over the data axes only where their
    size divides B, the sequence over the EP axis only where ep divides
    S; along an axis it does not shard, the tokens are replicated."""
    mesh, n = parallel.mesh, parallel.ep
    dp = parallel.dp_axis
    dp_size = math.prod(mesh.shape[a] for a in
                        (dp if isinstance(dp, tuple) else (dp,)))
    nb = dp_size if x_shape[0] % dp_size == 0 else 1
    ns = n if x_shape[1] % n == 0 else 1
    return nb, ns, n


def _moe_ep(x, p, cfg, parallel):
    """Expert-parallel body over every shard of this process at once.
    Returns (y, aux, route): route's e_idx, s_idx, flat_w and keep are
    [nb * ns_l, T_l*K] (shard (i, j) of the distinct ones held here at
    row i * ns_l + j; ``ns_l = ns`` in one process, a rank's block over
    ranks), with the shard-local capacity."""
    from ..parallel import collectives as cl   # (parallel imports models)
    nb, ns, n = ep_layout(x.shape, parallel)
    mesh = parallel.mesh
    ranked = getattr(mesh, "ranked", False)
    w = mesh.world if ranked else 1
    b, s, d = x.shape
    b_l, s_l = b // nb, s // ns
    t = b_l * s_l
    e_total = cfg.n_experts
    if e_total % n:
        raise ValueError(f"{e_total} experts do not split over {n} "
                         f"expert-parallel shards")
    if ranked and mesh.ranked_axis != parallel.ep_axis:
        raise ValueError(f"the mesh splits {mesh.ranked_axis!r} over its "
                         f"ranks, not the expert axis {parallel.ep_axis!r}")
    e_loc = e_total // n
    n_l = n // w                        # model shards on this process
    if p["we_d"].shape[0] != n_l * e_loc:
        raise ValueError(f"{p['we_d'].shape[0]} experts here; this rank "
                         f"holds {n_l * e_loc} (convert.rank_experts)")
    split = ranked and ns > 1           # sequence shards split over ranks
    ns_l = ns // w if split else ns
    cap = _capacity(t, cfg.top_k, e_total, cfg.capacity_factor)
    # shard (i, j) holds x[i*b_l:(i+1)*b_l, j*s_l:(j+1)*s_l]; the router
    # product runs over every shard's tokens, as one product in one
    # process (a rank's share alone would be another GEMM shape, whose
    # rounding can flip a route at a gate margin)
    xs = x.reshape(nb, b_l, ns, s_l, d).transpose(1, 2).reshape(
        nb * ns, t, d)
    logits = xs.float() @ p["router"].float()
    if split:                           # this rank's model shards
        xs = cl.block(xs.view(nb, ns, t, d), mesh, 1).reshape(
            nb * ns_l, t, d)
        logits = cl.block(logits.view(nb, ns, t, e_total), mesh, 1).reshape(
            nb * ns_l, t, e_total)
    buf, route, aux = _dispatch(xs, logits, cfg.top_k, e_total, cap)
    # all_to_all: [nb, src, dst, E_loc, C, d] -> [nb, dst, src, ...]
    send = buf.reshape(nb, ns_l, n, e_loc, cap, d)
    if split:
        # to rank q: the slots of its destinations [q*n_l, (q+1)*n_l)
        got = cl.all_to_all(
            send.reshape(nb, ns_l, w, n_l, e_loc, cap, d)
            .permute(2, 0, 1, 3, 4, 5, 6).reshape(-1, e_loc, cap, d), mesh)
        recv = got.view(w, nb, ns_l, n_l, e_loc, cap, d).permute(
            1, 3, 0, 2, 4, 5, 6).reshape(nb, n_l, ns, e_loc, cap, d)
    elif ranked:                        # every rank routed the same slots
        recv = cl.block(send, mesh, 2).transpose(1, 2)
    else:
        recv = send.transpose(1, 2)
    # each destination's experts take their slots source-major; every
    # expert's slots over every data row in one batched product
    xin = recv.permute(1, 3, 0, 2, 4, 5).reshape(n_l * e_loc,
                                                 nb * ns * cap, d)
    y = _expert_ffn(xin, p.get("we_g"), p.get("we_u"), p["we_d"],
                    cfg.ffn_type)
    back = y.reshape(n_l, e_loc, nb, ns, cap, d).permute(2, 0, 3, 1, 4, 5)
    # all_to_all back: [nb, dst, src, ...] -> [nb, src, dst, ...]
    if split:
        # to rank q: the results for its sources [q*ns_l, (q+1)*ns_l)
        got = cl.all_to_all(
            back.reshape(nb, n_l, w, ns_l, e_loc, cap, d)
            .permute(2, 0, 1, 3, 4, 5, 6).reshape(-1, e_loc, cap, d), mesh)
        y_buf = got.view(w, nb, n_l, ns_l, e_loc, cap, d).permute(
            1, 3, 0, 2, 4, 5, 6)
    elif ranked:                        # every rank needs every expert
        y_buf = cl.all_gather(back, mesh, 1).transpose(1, 2)
    else:
        y_buf = back.transpose(1, 2)
    y_buf = y_buf.reshape(nb * ns_l, e_total, cap, d)
    out = _combine(y_buf, route, t).reshape(nb, ns_l, b_l, s_l, d)
    if split:                           # the token blocks, on every rank
        out = cl.all_gather(out, mesh, 1)
    out = out.transpose(1, 2).reshape(b, s, d)
    # pmean over every mesh axis: each distinct shard is replicated
    # equally often
    if split:
        aux = cl.all_reduce(aux.sum().reshape(1), mesh)[0] / (nb * ns)
    else:
        aux = aux.mean()
    return out, aux, route


def moe_ffn(x, p, cfg, parallel=None):
    """x: [B,S,d] global.  parallel: a ``ParallelCtx`` with ``ep > 1``
    for expert parallelism, or None (one shard).  Returns (y, aux)."""
    routed = {k: p[k] for k in ("router", "we_g", "we_u", "we_d") if k in p}
    if parallel is not None and parallel.ep > 1:
        y, aux, _ = _moe_ep(x, routed, cfg, parallel)
    else:
        y, aux = _moe_local(x, routed, cfg)
    if cfg.n_shared_experts:
        shared = {k.replace("s_", ""): v for k, v in p.items()
                  if k.startswith("s_")}
        y = y + layers.ffn(x, shared, cfg.ffn_type)
    return y, aux


def init_moe(gen, cfg, dtype, stack=(), experts=None):
    """Router (fp32, std 0.02), routed experts (He-scaled) and shared
    experts, on the generator's device.  Stacked expert leaves are drawn
    one leading index at a time, so no fp32 copy of a whole stack
    exists (deepseek-moe-16b's [28, 64, 2048, 1408] would need 20.7 GB).
    ``experts`` (a ``(first, stop)`` pair) keeps only those routed
    experts, each layer drawn whole and cut: the same numbers as the
    whole set's, without ever holding it."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = tuple(stack)
    lo, hi = (0, e) if experts is None else experts

    def he(shape, fan):
        out = torch.empty(s + (hi - lo,) + shape[1:], dtype=dtype,
                          device=gen.device)
        for leaf in out.view(-1, hi - lo, *shape[1:]):
            leaf.copy_(layers.normal(gen, shape, fan ** -0.5, dtype)[lo:hi])
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
