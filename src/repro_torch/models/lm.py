"""Model assembly: init / train loss / prefill / decode, for the dense,
moe, ssm, hybrid, vlm and encdec families.

Port of ``repro.models.lm``.  Parameters are the
JAX package's tree of plain dicts with layer-stacked ``[L, ...]`` leaves,
and for the hybrid family a list of per-layer dicts
(``convert.lm_params_to_torch`` carries a JAX tree across); where JAX
scans over layers, a Python loop indexes layer ``l`` of each leaf.

Caches are plain dicts of tensors, as in JAX:
  attention : k, v [L, B, Smax, Hkv, hd], pos [B]
  encdec    : k, v as attention, cross_k, cross_v [L, B, Se, Hkv, hd]
              (the encoder's output projected per layer; decode attends
              to every one of its Se rows), pos [B]
  ssm       : state [L,B,H,P,N], conv [L,B,K-1,Cc], pos [B]
  hybrid    : hrec [Lr,B,W] fp32, conv [Lr,B,K-1,W], k,v [La,B,Wnd,Hkv,hd]
              (ring buffer of the local window), pos [B]
RoPE is applied to K at write time, so cached keys are position-baked.
In the ring, position p lives at slot ``p % Wnd`` after a prefill as
after a decode step.  (JAX's prefill keeps the last Wnd keys at slots
0..Wnd-1, which agrees only when S <= Wnd or S % Wnd == 0; ROADMAP.md,
"Semantics the port fixed".)
A vlm prefill puts the patch embeddings before the tokens, so its cache
holds n_patches + S positions and its ``pos`` is n_patches + S.
:func:`decode_step` updates the large leaves in place (the attention
k/v rows of the new token, the ssm state, the recurrent state) instead
of copying the whole cache each token, and returns the cache dict with
``pos`` advanced; the caller must not keep using the cache it passed in
as a snapshot.

Training (:func:`train_loss`): where JAX scans over layers under
``jax.checkpoint`` when ``remat``, the port runs each layer under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so a
layer's activations are recomputed in the backward pass (and its K4 or
K5 forward launched a second time on the card).  The stacked leaves are
split per layer with ``unbind``, whose backward stacks the layers'
gradients in one copy.  :func:`xent_loss` checkpoints each chunk of its
fp32 logits, so [B, S, V] is never held whole.  The blocks return the
moe aux loss (0.0 for the other families), as JAX's do.

Tensor parallelism (``ParallelCtx.tp``, set where ranks split the model
axis, every family): a model rank holds its block of every leaf the
reference's ``param_specs`` shard over ``model`` and computes its block
of each layer, as the reference's ``activation_rules`` place the
activations; a layer's code reads its own leaves' dims
(``ParallelCtx.at``: a stack's, a hybrid layer's, the decoder's
cross-attention's ``x_`` leaves).  The normed residual enters the
column-parallel products through ``collectives.enter`` (its backward
sums the ranks' partial gradients); q keeps the rank's heads where the
model axis divides Hq (``attn_q``), else is gathered whole; k and v
(and the decoder's cross K/V of the encoder output) are gathered whole
(``attn_kv``), normed and roped, and the rank keeps the KV heads its q
heads read (the decode cache holds only those); each row-parallel
product (``wo``, ``wd``, the shared experts' ``s_wd``, the cross
attention's ``x_wo``, Mamba2's and RG-LRU's ``w_out``) is a partial sum
the ranks add in fp32 in rank order (``collectives.sum_ranks``: the
same bits on every rank, so a moe router downstream routes alike); the
embedding is vocab-parallel (a masked lookup of the rank's vocab rows,
summed), and so are the head's logits: :func:`xent_loss` sums the
ranks' ``exp`` and target logits, the serve gathers them.  Mamba2 and
RG-LRU split by heads and channels (``ssm.mamba2_block``,
``rglru.recurrent_block``).  Inside a layer a rank's gradient of a
whole q, k or v is its share (the rank uses its heads only), so the
gathers' backward reduce-scatters, and a leaf held whole along model on
such a path (``q_norm``, ``k_norm``, a projection the spec's guard
leaves whole) is summed over the ranks once a step
(:func:`_enter_shared`).  A row-parallel sum reorders a reduction, so
the ranks agree with one process within rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import layers, moe, rglru, ssm
from .attention import attention, decode_attention
from .config import LMConfig
from .rope import apply_rope

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


@dataclass(frozen=True)
class ParallelCtx:
    """Everything the model knows about the mesh
    (``parallel.sharding.make_ctx`` builds it): the data and model axes,
    the expert-parallel degree (the model axis's size for the moe
    family: ``moe_ffn`` then routes each shard's tokens on its own) and
    an optional ``constrain`` (tensor, kind) -> tensor.  ``make_ctx``
    sets none, since on the port's one device a sharding constraint
    changes no value, so ``c`` is the identity there as it is under
    :data:`NO_PARALLEL`, which has no mesh."""
    mesh: Any = None
    dp_axis: Any = "data"
    tp_axis: str = "model"
    ep: int = 1                     # expert-parallel degree
    constrain: Callable = None      # (tensor, kind) -> tensor
    # over data ranks: whether a batch's rows are this data rank's block
    # of the global batch (else every data rank holds every row), and
    # the parameters' data dims (a tree of ints / None matching them:
    # the leaves a rank holds as its block, gathered where they are used)
    data_block: bool = False
    fsdp: Any = None
    # over model ranks: the model dims (a tree of ints / None: the
    # leaves a rank holds as its block, tensor parallelism) of the
    # parameters the code at hand reads, the whole tree's at the model's
    # entry points and a layer's inside it (:meth:`at`), else None
    tp: Any = None

    @property
    def ep_axis(self):
        return self.tp_axis

    def at(self, *path) -> "ParallelCtx":
        """This context for the parameters at ``path`` of :attr:`tp`'s
        tree (a stack's key, a hybrid layer's index, a sub-block's key),
        so a layer asks :meth:`split` of its own leaves' keys."""
        if self.tp is None:
            return self
        return dataclasses.replace(self, tp=_subtree(self.tp, path))

    def split(self, *path) -> bool:
        """Whether a model rank holds the parameter at ``path`` of
        :attr:`tp`'s tree (``"embed"``, or a layer's ``"wo"``) as its
        block (tensor parallelism)."""
        return _subtree(self.tp, path) is not None

    def c(self, t, kind):
        return self.constrain(t, kind) if self.constrain else t

    @property
    def data_ranks(self) -> int:
        """The ranks that split the data axes (1 off ranks)."""
        return moe.data_ranks(self) if self.mesh is not None else 1


NO_PARALLEL = ParallelCtx()


def _subtree(node, path):
    for k in path:
        if isinstance(node, dict):
            node = node.get(k)
        elif isinstance(node, (list, tuple)) and isinstance(k, int):
            node = node[k] if k < len(node) else None
        else:
            return None
    return node


def _dt(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


def _layers(blocks, n):
    """The n per-layer dicts of a stacked block tree, by ``unbind``; in
    training its backward stacks the per-layer gradients once, where
    indexing each layer would add a zero-filled copy of the whole stack
    per layer."""
    cols = {k: v.unbind(0) for k, v in blocks.items()}
    return [{k: cols[k][i] for k in cols} for i in range(n)]


def _maybe_remat(fn, remat, *args):
    """``fn(*args)``, under a non-reentrant activation checkpoint when
    ``remat`` (JAX's ``jax.checkpoint`` of the scanned body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _gather(p, dims, ctx):
    """``p`` (a layer's dict, a tree of them, or a leaf) with every leaf
    that ``dims`` (the matching subtree of ``ctx.fsdp``: an int where a
    rank holds the leaf as its data block, None where it holds it whole)
    names made whole over the data ranks, all in one
    ``collectives.gather_blocks`` (one all-gather a dtype); the backward
    reduce-scatters their gradients."""
    if dims is None:
        return p
    from ..parallel import collectives as cl   # (parallel imports models)
    held = []

    def collect(node, d):
        if d is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                collect(v, d.get(k))
        elif isinstance(node, (list, tuple)):
            for v, di in zip(node, d):
                collect(v, di)
        else:
            held.append((node, d))
    collect(p, dims)
    whole = iter(cl.gather_blocks([x for x, _ in held], ctx.mesh,
                                  [d for _, d in held], "data"))

    def rebuild(node, d):
        if d is None:
            return node
        if isinstance(node, dict):
            return {k: rebuild(v, d.get(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, di) for v, di in zip(node, d)]
        return next(whole)
    return rebuild(p, dims)


def _fsdp(ctx, key, stacked=False, skip=()):
    """``ctx.fsdp``'s dims of the params' ``key`` subtree (None without
    data blocks), a stacked leaf's dim shifted past the layer axis
    (``stacked``: a layer's dict of ``_layers``), ``skip``'s keys left
    out."""
    dims = None if ctx.fsdp is None else ctx.fsdp.get(key)
    if dims is None or not (stacked or skip):
        return dims
    return {k: (None if d is None else d - 1) if stacked else d
            for k, d in dims.items() if k not in skip}


def _row_parallel(h, w, ctx, split):
    """``h @ w``; where ``split`` (this model rank holds its block ``h``
    of a replicated input and its block ``w`` of the weight's rows) the
    ranks' partial products summed in fp32 in rank order
    (``collectives.sum_ranks``)."""
    y = h @ w
    if not split:
        return y
    from ..parallel import collectives as cl   # (parallel imports models)
    return cl.sum_ranks(y, ctx.mesh, ctx.tp_axis)


def _enter(x, ctx, split):
    """``x`` (replicated) as it is; where ``split`` (it enters this
    model rank's column blocks) its gradient's partials are summed over
    the model ranks."""
    if not split:
        return x
    from ..parallel import collectives as cl
    return cl.enter(x, ctx.mesh, ctx.tp_axis)


def _kv_select(cfg, first, count):
    """The KV heads that q heads ``first .. first + count - 1`` read, as
    ``(kv_first, kv_count)`` where they are a contiguous run that the q
    heads divide into equal groups (what GQA attention takes), else as
    a list of one KV head per q head."""
    g = cfg.n_heads // cfg.n_kv_heads
    idx = [(first + j) // g for j in range(count)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if count % n == 0 and idx == [lo + j // (count // n)
                                  for j in range(count)]:
        return lo, n
    return idx


def _q_heads(cfg, ctx):
    """(first, count): the q heads a model rank computes: its block where
    the model axis divides Hq (the reference's ``attn_q``), else every
    head."""
    mesh = ctx.mesh
    hq = cfg.n_heads
    if not ctx.split("wq") or hq % mesh.shape[ctx.tp_axis]:
        return 0, hq
    n = hq // mesh.n_ranks(ctx.tp_axis)
    return mesh.coord(ctx.tp_axis) * n, n


# ============================================================ param init

def init_params(cfg: LMConfig, generator: torch.Generator, device=None,
                experts=None, cut=layers.keep_whole):
    """Random parameters with the JAX package's distributions, drawn from
    ``generator`` on ``device`` (``cuda`` unless ``"cpu"`` is asked for;
    the generator must live there).  Not the same numbers as JAX's.
    ``experts`` (``(first, stop)``) keeps only those routed experts of a
    moe config, drawn as the whole set draws them (an expert-parallel
    rank's share).  ``cut(key, leaf)`` is applied to every leaf as soon
    as it is drawn, before the next one is (a data rank's block of it:
    the same numbers, and never a whole copy of more than one stacked
    leaf at a time)."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, "
                         f"the parameters go to {dev}")
    _check_family(cfg)
    dt = _dt(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    gen = generator
    params = {"embed": cut("embed", layers.normal(gen, (v, d), 0.02, dt)),
              "final_norm": cut("final_norm", layers.zeros(gen, (d,), dt))}
    if not cfg.tie_embeddings:
        params["head"] = cut("head", layers.normal(gen, (d, v), d ** -0.5,
                                                   dt))
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        params["blocks"] = _init_dense_stack(gen, cfg, dt, L, cut=cut)
    elif cfg.family == "moe":
        blk = _init_dense_stack(gen, cfg, dt, L, ffn=False, cut=cut)
        blk.update(moe.init_moe(gen, cfg, dt, stack=(L,), experts=experts,
                                cut=cut))
        params["blocks"] = blk
    elif cfg.family == "ssm":
        blk = {"ln1": cut("ln1", layers.zeros(gen, (L, d), dt))}
        blk.update(ssm.init_mamba2(gen, cfg, dt, stack=(L,), cut=cut))
        params["blocks"] = blk
    elif cfg.family == "encdec":
        params["enc_blocks"] = _init_dense_stack(gen, cfg, dt,
                                                 cfg.n_enc_layers, cut=cut)
        dec = _init_dense_stack(gen, cfg, dt, L, cut=cut)
        dec.update({f"x_{k}": t for k, t in layers.init_attn(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qk_norm,
            cfg.use_bias, dt, stack=(L,),
            cut=lambda k, t: cut(f"x_{k}", t)).items()})
        dec["ln3"] = cut("ln3", layers.zeros(gen, (L, d), dt))
        params["dec_blocks"] = dec
        params["enc_norm"] = cut("enc_norm", layers.zeros(gen, (d,), dt))
    else:                                              # hybrid
        params["blocks"] = []
        for i in range(L):
            p = {"ln1": cut("ln1", layers.zeros(gen, (d,), dt)),
                 "ln2": cut("ln2", layers.zeros(gen, (d,), dt))}
            if cfg.pattern_at(i) == "r":
                p["rec"] = rglru.init_recurrent(gen, cfg, dt, cut=cut)
            else:
                p["attn"] = layers.init_attn(gen, d, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.hd,
                                             cfg.qk_norm, cfg.use_bias, dt,
                                             cut=cut)
            p["ffn"] = layers.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type,
                                       cfg.use_bias, dt, cut=cut)
            params["blocks"].append(p)
    return params


def _init_dense_stack(gen, cfg, dt, L, ffn=True, cut=layers.keep_whole):
    d = cfg.d_model
    blk = {"ln1": cut("ln1", layers.zeros(gen, (L, d), dt)),
           "ln2": cut("ln2", layers.zeros(gen, (L, d), dt))}
    blk.update(layers.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.qk_norm, cfg.use_bias, dt,
                                stack=(L,), cut=cut))
    if ffn:
        blk.update(layers.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type,
                                   cfg.use_bias, dt, stack=(L,), cut=cut))
    return blk


# ============================================================ sub-blocks

def _project_qkv(x, p, cfg, ctx, positions):
    """q of the heads this rank computes (every head, or a model rank's
    block of them) and k and v of the KV heads those read.  On a model
    rank (tensor parallelism) they come from its column blocks, the
    blocks of whole tensors gathered over the model ranks in one
    collective (the backward reduce-scatters: a rank's gradient of them
    is its share), then the norms and rope on whole heads."""
    from ..parallel import collectives as cl
    b, s, _ = x.shape
    keys = ("wq", "wk", "wv")
    split = [ctx.split(key) for key in keys]
    x = _enter(x, ctx, any(split))
    first, count = _q_heads(cfg, ctx)
    qkv = [layers.dense(x, p[key], p.get("b" + key[1])) for key in keys]
    whole = [i for i in range(3)
             if split[i] and not (i == 0 and count < cfg.n_heads)]
    got = cl.gather_blocks([qkv[i] for i in whole], ctx.mesh,
                           [2] * len(whole), ctx.tp_axis)
    for i, t in zip(whole, got):
        qkv[i] = t
    q = qkv[0].reshape(b, s, count, cfg.hd)
    k = qkv[1].reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = qkv[2].reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k, v = _keep_kv(k, v, _kv_select(cfg, first, count))
    return q, k, v


def _keep_kv(k, v, sel):
    """k and v [B, S, Hkv, hd] at the KV heads ``sel`` names
    (:func:`_kv_select`)."""
    if isinstance(sel, tuple):
        return k.narrow(2, *sel), v.narrow(2, *sel)
    idx = torch.tensor(sel, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _cross_q(x, p, cfg, ctx):
    """The cross-attention's q [B, S, count, hd] of the heads this rank
    computes (no rope, no qk norm): a model rank's column block of
    ``wq``, gathered whole where the model axis does not divide Hq."""
    from ..parallel import collectives as cl
    b, s, _ = x.shape
    x = _enter(x, ctx, ctx.split("wo"))
    first, count = _q_heads(cfg, ctx)
    q = layers.dense(x, p["wq"], p.get("bq"))
    if ctx.split("wq") and count == cfg.n_heads:
        q, = cl.gather_blocks([q], ctx.mesh, [2], ctx.tp_axis)
    return q.reshape(b, s, count, cfg.hd)


def _attn_out(o, p, ctx):
    """``o`` [B, S, H, hd] through ``wo``, plus ``bo``.  On a model rank
    that holds its rows of ``wo``: ``o``'s rank block of features (a
    plain slice where ``o`` holds every head, so its gradient is the
    rank's share) through them, summed over the model ranks."""
    b, s = o.shape[:2]
    o = o.reshape(b, s, -1)
    rows = p["wo"].shape[0]
    if o.shape[-1] != rows:
        o = o.narrow(-1, ctx.mesh.coord(ctx.tp_axis) * rows, rows)
    y = _row_parallel(o, p["wo"], ctx, ctx.split("wo"))
    return y + p["bo"] if "bo" in p else y


def _attn_sub(x, p, cfg, ctx, *, causal=True, window=None, cache=None,
              pos=None, cross_kv=None):
    """Attention sub-block (no residual): self-attention, causal unless
    asked, over the last ``window`` positions when one is given; or,
    with ``cross_kv`` = (k, v) [B, Se, Hkv, hd], cross-attention of x's
    queries (no rope, no qk norm, not causal) over every row of them.
    cache: (k_l, v_l) for decode, written in place at ``pos`` (at
    ``pos % Wnd`` in the ring of a windowed layer).  On a model rank
    (tensor parallelism) the rank's heads, as the module's docstring
    says; its cache (and ``cross_kv``) holds the KV heads they read."""
    b, s, _ = x.shape
    if cross_kv is not None:                          # cross-attention (dec)
        q = _cross_q(x, p, cfg, ctx)
        k, v = cross_kv
        o = ctx.c(attention(q, k, v, causal=False), "attn_out")
        return _attn_out(o, p, ctx), None
    if cache is None:
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = _project_qkv(x, p, cfg, ctx, positions)
        q = ctx.c(q, "attn_q")
        k = ctx.c(k, "attn_kv")
        v = ctx.c(v, "attn_kv")
        o = attention(q, k, v, causal=causal, window=window)
        return _attn_out(ctx.c(o, "attn_out"), p, ctx), (k, v)
    k_l, v_l = cache                                  # [B, Smax, Hkv, hd]
    q, k_new, v_new = _project_qkv(x, p, cfg, ctx, pos[:, None])
    slot = pos.long() if window is None else pos.long() % k_l.shape[1]
    bidx = torch.arange(b, device=x.device)
    k_l[bidx, slot] = k_new[:, 0].to(k_l.dtype)
    v_l[bidx, slot] = v_new[:, 0].to(v_l.dtype)
    kv_len = pos + 1 if window is None else \
        torch.clamp(pos + 1, max=k_l.shape[1])       # the ring bounds it
    o = decode_attention(q, k_l, v_l, kv_len)
    return _attn_out(o, p, ctx), (k_l, v_l)


def _ffn_sub(x, p, cfg, ctx, prefix=""):
    """The FFN (the shared experts' with ``prefix="s_"``); on a model
    rank its column blocks of ``wg``/``wu``, its rows of ``wd``, the
    partial products summed over the ranks, then ``bd``."""
    fp = {k: p[prefix + k] for k in ("wg", "wu", "wd", "bu", "bd")
          if prefix + k in p}
    split = ctx.split(prefix + "wd")
    h = layers.ffn_hidden(_enter(ctx.c(x, "ffn_in"), ctx, split), fp,
                          cfg.ffn_type)
    y = _row_parallel(h, fp["wd"], ctx, split)
    return ctx.c(y + fp["bd"] if "bd" in fp else y, "ffn_out")


# ============================================================ block bodies

def dense_block(x, p, cfg, ctx, cache=None, pos=None):
    h, kv = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, ctx,
                      cache=cache, pos=pos)
    x = x + h
    x = x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p, cfg, ctx)
    return x, kv, 0.0


def moe_block(x, p, cfg, ctx, cache=None, pos=None):
    h, kv = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, ctx,
                      cache=cache, pos=pos)
    x = x + h
    xn = layers.rms_norm(x, p["ln2"], cfg.rms_eps)
    # the routed experts expert-parallel; the shared ones as the dense
    # FFN (column / row parallel on a model rank)
    y, aux = moe.moe_ffn(xn, p, cfg, ctx if ctx.ep > 1 else None,
                         shared=False)
    if cfg.n_shared_experts:
        y = y + _ffn_sub(xn, p, cfg, ctx, prefix="s_")
    return x + y, kv, aux


def ssm_block(x, p, cfg, ctx, cache=None):
    h, new_cache = ssm.mamba2_block(
        layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, cache=cache,
        ctx=ctx)
    return x + h, new_cache, 0.0


def hybrid_block(x, p, cfg, ctx, kind, cache=None, pos=None):
    """A hybrid layer (``ctx`` at the layer: ``ParallelCtx.at("blocks",
    i)``): the RG-LRU block or windowed attention, then the FFN."""
    if kind == "r":
        h, new_cache = rglru.recurrent_block(
            layers.rms_norm(x, p["ln1"], cfg.rms_eps), p["rec"], cfg,
            cache=cache, ctx=ctx.at("rec"))
    else:
        h, new_cache = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps),
                                 p["attn"], cfg, ctx.at("attn"),
                                 window=cfg.local_window, cache=cache,
                                 pos=pos)
    x = x + h
    x = x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p["ffn"],
                     cfg, ctx.at("ffn"))
    return x, new_cache


_BLOCK = {"dense": dense_block, "vlm": dense_block, "moe": moe_block}
_TRAIN_BLOCK = dict(_BLOCK, ssm=ssm_block)


# ============================================================ enc-dec

def _xattn_params(p):
    """The cross-attention weights of a decoder layer (its ``x_`` leaves,
    prefix dropped), or their dims."""
    return {k[2:]: v for k, v in p.items() if k.startswith("x_")}


def _xattn_ctx(ctx):
    """A decoder layer's context (``ctx.at("dec_blocks")``) for its
    cross-attention's ``x_`` leaves."""
    if ctx.tp is None:
        return ctx
    return dataclasses.replace(ctx, tp=_xattn_params(ctx.tp))


def _enc_layer(x, p, cfg, ctx):
    h, _ = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, ctx,
                     causal=False)
    x = x + h
    return x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p, cfg,
                        ctx)


def _enc_forward(params, enc_embeds, cfg, ctx, remat=False):
    """The encoder over the frame embeddings [B, Se, d]: per layer a
    non-causal self-attention (rope over arange(Se)) and the FFN (each
    layer checkpointed when ``remat``, its data blocks gathered inside),
    then ``enc_norm``."""
    x = enc_embeds
    dims = _fsdp(ctx, "enc_blocks", stacked=True)
    ectx = ctx.at("enc_blocks")
    for p in _layers(params["enc_blocks"], cfg.n_enc_layers):
        x = _maybe_remat(lambda x, p=p: _enc_layer(
            x, _gather(p, dims, ctx), cfg, ectx), remat, x)
    return layers.rms_norm(x, params["enc_norm"], cfg.rms_eps)


def _dec_block(x, p, cfg, ctx, cross_kv, cache=None, pos=None):
    """Decoder layer (``ctx`` at ``"dec_blocks"``): causal
    self-attention, cross-attention over the encoder's K/V (the ``x_``
    weights, after ``ln3``), then the FFN."""
    h, kv = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, ctx,
                      cache=cache, pos=pos)
    x = x + h
    h, _ = _attn_sub(layers.rms_norm(x, p["ln3"], cfg.rms_eps),
                     _xattn_params(p), cfg, _xattn_ctx(ctx),
                     cross_kv=cross_kv)
    x = x + h
    x = x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p, cfg, ctx)
    return x, kv


_CROSS_KV = ("x_wk", "x_wv", "x_bk", "x_bv")


def _cross_kv(params, enc_out, cfg, ctx=NO_PARALLEL):
    """Every decoder layer's cross K/V of the encoder output:
    ([L, B, Se, Hkv, hd], [L, B, Se, Hkv, hd]); the projections' data
    blocks gathered layer by layer.  On a model rank (tensor
    parallelism) its column blocks of ``x_wk`` and ``x_wv`` project the
    encoder output, gathered whole over the model ranks (one collective
    a layer), and it keeps the KV heads its cross-attention's q heads
    read (``Hkv`` is then theirs)."""
    from ..parallel import collectives as cl
    b, se, _ = enc_out.shape
    ks, vs = [], []
    dims = _fsdp(ctx, "dec_blocks", stacked=True)
    if dims is not None:
        dims = {k: d for k, d in dims.items() if k in _CROSS_KV}
    xctx = _xattn_ctx(ctx.at("dec_blocks"))
    whole = [i for i, key in enumerate(("wk", "wv")) if xctx.split(key)]
    enc_out = _enter(enc_out, ctx, xctx.split("wo"))
    sel = _kv_select(cfg, *_q_heads(cfg, xctx))
    for p in _layers(params["dec_blocks"], cfg.n_layers):
        xp = _xattn_params(_gather({k: v for k, v in p.items()
                                    if k in _CROSS_KV}, dims, ctx))
        kv = [layers.dense(enc_out, xp["wk"], xp.get("bk")),
              layers.dense(enc_out, xp["wv"], xp.get("bv"))]
        got = cl.gather_blocks([kv[i] for i in whole], ctx.mesh,
                               [2] * len(whole), ctx.tp_axis)
        for i, t in zip(whole, got):
            kv[i] = t
        k, v = _keep_kv(*(t.reshape(b, se, cfg.n_kv_heads, cfg.hd)
                          for t in kv), sel)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


# ============================================================ training

def _run_stack(x, blocks, cfg, ctx, remat=False):
    """The decoder stack for training: a loop over layers (each under an
    activation checkpoint when ``remat``; the hybrid family's unrolled
    layers never, as in JAX), each layer's data blocks gathered inside
    its body, so under remat they are gathered again in the backward
    and one layer's whole weights live at a time.  Returns (x, summed
    moe aux)."""
    if cfg.family == "hybrid":
        dims = _fsdp(ctx, "blocks")
        for i, p in enumerate(blocks):
            p = _gather(p, None if dims is None else dims[i], ctx)
            x, _ = hybrid_block(x, p, cfg, ctx.at("blocks", i),
                                cfg.pattern_at(i))
        return x, 0.0
    block = _TRAIN_BLOCK[cfg.family]
    dims = _fsdp(ctx, "blocks", stacked=True)
    lctx = ctx.at("blocks")

    def body(x, p):
        x, _, a = block(ctx.c(x, "resid"), _gather(p, dims, ctx), cfg, lctx)
        return x, a

    aux = 0.0
    for p in _layers(blocks, cfg.n_layers):
        x, a = _maybe_remat(body, remat, x, p)
        aux = aux + a
    return x, aux


# a model rank's leaves that it may hold whole along model though it
# uses them for its heads or channels only, by the row-parallel leaf
# that says a layer is tensor parallel: self-attention's, the decoder's
# cross-attention's and Mamba2's (RG-LRU's leaves all split by ``W``)
_SHARED = {"wo": ("wq", "wk", "wv", "bq", "bk", "bv", "q_norm", "k_norm"),
           "x_wo": ("x_wq", "x_wk", "x_wv", "x_bq", "x_bk", "x_bv"),
           "w_out": ("w_in", "w_conv", "a_log", "dt_bias", "d_skip")}


def _enter_shared(params, ctx):
    """``params`` with every leaf of :data:`_SHARED` that a model rank
    holds whole in a tensor-parallel layer entered (``collectives.
    enter_many``: identity forward; its gradient, the rank's share, is
    summed over the model ranks), all in one collective."""
    if ctx.tp is None:
        return params
    from ..parallel import collectives as cl

    def shared(node, dims):
        return {k for row, keys in _SHARED.items()
                if dims.get(row) is not None
                for k in keys if k in node and dims.get(k) is None}

    picked = []

    def collect(node, dims):
        if isinstance(node, list):
            for n, d in zip(node, dims):
                collect(n, d)
        elif isinstance(node, dict):
            keys = shared(node, dims)
            for k, v in node.items():
                if k in keys:
                    picked.append(v)
                elif isinstance(v, (dict, list)):
                    collect(v, dims[k])
    collect(params, ctx.tp)
    if not picked:
        return params
    got = iter(cl.enter_many(picked, ctx.mesh, ctx.tp_axis))

    def rebuild(node, dims):
        if isinstance(node, list):
            return [rebuild(n, d) for n, d in zip(node, dims)]
        if not isinstance(node, dict):
            return node
        keys = shared(node, dims)
        return {k: next(got) if k in keys else rebuild(v, dims.get(k))
                for k, v in node.items()}
    return rebuild(params, ctx.tp)


def forward_hidden(params, tokens, cfg, ctx, *, patch_embeds=None,
                   remat=False):
    """Token ids -> final hidden states [B, S, d] and the moe aux."""
    x = embed_tokens(params, tokens, cfg, ctx)
    if cfg.family == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    x = ctx.c(x, "resid")
    x, aux = _run_stack(x, params["blocks"], cfg, ctx, remat=remat)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, aux


def xent_loss(h, head_w, labels, mask, ctx, chunk: int = 512,
              vocab_ranks: bool = False):
    """Chunked softmax cross-entropy, as JAX's: the chunk is the largest
    divisor of S not above ``chunk``, each chunk's logits are fp32 and
    each chunk runs under an activation checkpoint, so its [B, chunk, V]
    logits are recomputed in the backward pass and [B, S, V] is never
    held.  h [B,S,d], labels/mask [B,S].  Over data ranks it returns
    this data rank's share: its masked sum over the global mask count
    (all-reduced over the data ranks, outside autograd) where its rows
    are its block of the batch (``ctx.data_block``), else its mean over
    the data ranks' count, so the shares sum to the global mean.  With
    ``vocab_ranks`` (a model rank's block ``head_w`` [d, V / n] of the
    vocab, tensor parallelism) a chunk's log-sum-exp is taken over the
    ranks' blocks: the max over the ranks' maxima (no gradient), the
    ranks' ``exp`` sums and target logits summed in fp32 in rank order
    (``collectives.sum_ranks``), so the loss is the same on every rank."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    while s % chunk:            # largest divisor of s not above the target
        chunk -= 1
    if vocab_ranks:
        from ..parallel import collectives as cl
        mesh, ax = ctx.mesh, ctx.tp_axis
        h = _enter(h, ctx, True)
        n_v = head_w.shape[-1]
        first = mesh.coord(ax) * n_v

    def body(hs, ls, ms):
        logits = ctx.c(hs.float() @ head_w.float(), "logits")
        if not vocab_ranks:
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, ls[..., None].long())[..., 0]
            return ((lse - ll) * ms).sum()
        m = mesh.all_gather(logits.detach().amax(-1)[None], 0,
                            axis=ax).amax(0)
        local = ls.long() - first
        mine = (local >= 0) & (local < n_v)
        ll = logits.gather(-1, local.clamp(0, n_v - 1)[..., None])[..., 0]
        se, ll = cl.sum_ranks(torch.stack([
            torch.exp(logits - m[..., None]).sum(-1),
            torch.where(mine, ll, 0.0)]), mesh, ax).unbind(0)
        return ((m + torch.log(se) - ll) * ms).sum()

    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        loss_sum = loss_sum + checkpoint(body, h[:, sl], labels[:, sl],
                                         mask[:, sl], use_reentrant=False)
        cnt = cnt + mask[:, sl].sum()
    if ctx.data_ranks > 1:              # this data rank's share
        cnt = (ctx.mesh.all_reduce(cnt.detach().clone(), ctx.dp_axis)
               if ctx.data_block else cnt * ctx.data_ranks)
    return loss_sum / torch.clamp(cnt, min=1.0)


def train_loss(params, batch, cfg, ctx, *, remat=True, aux_weight=0.01,
               loss_chunk=512):
    """batch: tokens [B,S] and labels [B,S] (a label < 0 is masked out);
    the vlm family's optional patch_embeds [B, n_patches, d] (their
    positions carry no loss), the encdec family's enc_embeds [B, Se, d].
    Returns the mean cross-entropy plus ``aux_weight`` times the summed
    moe aux; over data ranks this data rank's share of it (the shares
    sum to the global loss: its share of the cross-entropy,
    :func:`xent_loss`, and ``1 / data_ranks`` of the aux, which the moe
    all-reduces).  The leaves a rank holds as data blocks
    (``ctx.fsdp``) are gathered where they are used: ``embed``, the head
    and the norms once, each layer's inside its body."""
    _check_family(cfg)
    if ctx.fsdp is not None:
        top = {k: v for k, v in params.items()
               if k not in ("blocks", "enc_blocks", "dec_blocks")}
        params = dict(params, **_gather(
            top, {k: ctx.fsdp.get(k) for k in top}, ctx))
    params = _enter_shared(params, ctx)
    if cfg.family == "encdec":
        return _encdec_loss(params, batch, cfg, ctx, remat=remat,
                            loss_chunk=loss_chunk)
    labels = batch["labels"]
    h, aux = forward_hidden(params, batch["tokens"], cfg, ctx,
                            patch_embeds=batch.get("patch_embeds"),
                            remat=remat)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        h = h[:, batch["patch_embeds"].shape[1]:]
    mask = (labels >= 0).float()
    loss = xent_loss(h, _head(params, cfg), torch.clamp(labels, min=0),
                     mask, ctx, chunk=loss_chunk,
                     vocab_ranks=_vocab_split(ctx, cfg))
    return loss + aux_weight * aux / ctx.data_ranks


def _encdec_loss(params, batch, cfg, ctx, remat=True, loss_chunk=512):
    """The encoder over ``enc_embeds``, every layer's cross K/V of its
    output, then the decoder over the tokens (each layer checkpointed
    when ``remat``) and the chunked cross-entropy."""
    enc_out = _enc_forward(params, batch["enc_embeds"], cfg, ctx,
                           remat=remat)
    x = embed_tokens(params, batch["tokens"], cfg, ctx)
    cross_k, cross_v = _cross_kv(params, enc_out, cfg, ctx)
    dims = _fsdp(ctx, "dec_blocks", stacked=True, skip=_CROSS_KV)
    dctx = ctx.at("dec_blocks")

    def body(x, p, ck, cv):
        p = _gather({k: v for k, v in p.items() if k not in _CROSS_KV},
                    dims, ctx)
        x, _ = _dec_block(ctx.c(x, "resid"), p, cfg, dctx, (ck, cv))
        return x

    for p, ck, cv in zip(_layers(params["dec_blocks"], cfg.n_layers),
                         cross_k.unbind(0), cross_v.unbind(0)):
        x = _maybe_remat(body, remat, x, p, ck, cv)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    return xent_loss(x, _head(params, cfg), torch.clamp(labels, min=0),
                     mask, ctx, chunk=loss_chunk,
                     vocab_ranks=_vocab_split(ctx, cfg))


def train_launches(cfg) -> dict:
    """Each kernel's launches in one :func:`train_loss` step under remat
    and its backward, {wrapper name: n}: the forward kernel once in every
    layer that runs it and once more where remat recomputes that layer,
    its backward kernel once.  K4 (``flash_attention``) runs in every
    layer of the dense, moe and vlm families, in the encdec family's
    encoder layers and twice in each decoder layer (self- and
    cross-attention), and in the hybrid family's attention layers
    (``pattern_at(i) == "a"``), which no checkpoint recomputes
    (:func:`_run_stack` never checkpoints the hybrid stack, as in JAX);
    K5 (``ssd_intra``) in every layer of the ssm family."""
    if cfg.family == "ssm":
        return {"ssd_intra": 2 * cfg.n_layers, "ssd_intra_bwd": cfg.n_layers}
    if cfg.family == "hybrid":
        n = sum(cfg.pattern_at(i) == "a" for i in range(cfg.n_layers))
        return {"flash_attention": n, "flash_attention_bwd": n}
    n = cfg.n_enc_layers + 2 * cfg.n_layers if cfg.family == "encdec" \
        else cfg.n_layers
    return {"flash_attention": 2 * n, "flash_attention_bwd": n}


# ============================================================ serving paths

def embed_tokens(params, tokens, cfg, ctx=NO_PARALLEL):
    """The token embeddings; on a model rank that holds its vocab rows
    (tensor parallelism) a lookup of the ids in its range, zeros
    elsewhere, summed over the ranks (exact: one rank holds each id);
    the hybrid family's then scaled by sqrt(d_model)."""
    if ctx.split("embed"):
        emb = params["embed"]
        local = tokens.long() - ctx.mesh.coord(ctx.tp_axis) * emb.shape[0]
        mine = (local >= 0) & (local < emb.shape[0])
        x = torch.where(mine[..., None], emb[local.clamp(0,
                                                         emb.shape[0] - 1)],
                        0)
        from ..parallel import collectives as cl
        x = cl.sum_ranks(x, ctx.mesh, ctx.tp_axis)
    else:
        x = params["embed"][tokens]
    if cfg.family == "hybrid":                        # gemma-style scaling
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _vocab_split(ctx, cfg) -> bool:
    """Whether a model rank holds its block of the head's vocab."""
    return ctx.split("embed" if cfg.tie_embeddings else "head")


def _logits(params, x, cfg, ctx=NO_PARALLEL):
    # fp32 head product, as the JAX package computes it: with tied
    # embeddings this copies the [V, d] table to fp32 on every call; a
    # model rank's vocab block gathered over the ranks
    logits = layers.dense(x.float(), _head(params, cfg).float())
    if not _vocab_split(ctx, cfg):
        return logits
    from ..parallel import collectives as cl
    return cl.all_gather(logits, ctx.mesh, logits.dim() - 1, ctx.tp_axis)


def init_decode_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None, kv_heads: int | None = None):
    """Zeroed decode cache (bf16 unless asked, whatever ``cfg.dtype``, as
    in JAX) on ``device`` (``cuda`` unless ``"cpu"`` is asked for);
    ``kv_heads`` of the attention leaves (every one unless given: a
    model rank's, those its q heads read).  The ssm and hybrid leaves
    are one process's (a model rank's prefill gives its heads' state and
    channels)."""
    dev = resolve_device(device)
    _check_family(cfg)
    L = cfg.n_layers
    hkv = kv_heads or cfg.n_kv_heads
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        shape = (L, batch, max_len, hkv, cfg.hd)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev),
                 "pos": pos}
        if cfg.family == "encdec":    # JAX's size; a serve keeps the
            # prefill's own cross leaves (launch.serve.grow_cache)
            shape = (L, batch, max(1, max_len // cfg.enc_ratio), hkv,
                     cfg.hd)
            cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache
    if cfg.family == "hybrid":
        w = cfg.lru_width or cfg.d_model
        n_r = sum(1 for i in range(L) if cfg.pattern_at(i) == "r")
        shape = (L - n_r, batch, min(cfg.local_window, max_len), hkv,
                 cfg.hd)
        return {"hrec": torch.zeros((n_r, batch, w), dtype=torch.float32,
                                    device=dev),
                "conv": torch.zeros((n_r, batch, cfg.conv_width - 1, w),
                                    dtype=dtype, device=dev),
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "pos": pos}
    cc = cfg.d_inner + 2 * cfg.ssm_state
    return {"state": torch.zeros((L, batch, cfg.n_ssm_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
            "conv": torch.zeros((L, batch, cfg.conv_width - 1, cc),
                                dtype=dtype, device=dev),
            "pos": pos}


def decode_step(params, cache, tokens, cfg, ctx):
    """One token for every sequence.  tokens [B,1] -> logits [B, V]."""
    _check_family(cfg)
    x = ctx.c(embed_tokens(params, tokens, cfg, ctx), "resid_decode")
    pos = cache["pos"]
    blocks = params.get("blocks")
    lctx = ctx.at("blocks")
    if cfg.family in _BLOCK:
        block = _BLOCK[cfg.family]
        for i, p in enumerate(_layers(blocks, cfg.n_layers)):
            x, _, _ = block(x, p, cfg, lctx,
                            cache=(cache["k"][i], cache["v"][i]), pos=pos)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    elif cfg.family == "encdec":
        dctx = ctx.at("dec_blocks")
        for i, p in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
            x, _ = _dec_block(x, p, cfg, dctx,
                              (cache["cross_k"][i], cache["cross_v"][i]),
                              cache=(cache["k"][i], cache["v"][i]), pos=pos)
        new_cache = dict(cache, pos=pos + 1)
    elif cfg.family == "hybrid":
        tails = []
        ir = ia = 0
        for i in range(cfg.n_layers):
            kind = cfg.pattern_at(i)
            if kind == "r":
                x, (h_new, tail) = hybrid_block(
                    x, blocks[i], cfg, ctx.at("blocks", i), kind,
                    cache=(cache["hrec"][ir], cache["conv"][ir]))
                cache["hrec"][ir].copy_(h_new)
                tails.append(tail)
                ir += 1
            else:
                x, _ = hybrid_block(x, blocks[i], cfg, ctx.at("blocks", i),
                                    kind,
                                    cache=(cache["k"][ia], cache["v"][ia]),
                                    pos=pos)
                ia += 1
        new_cache = {"hrec": cache["hrec"], "conv": torch.stack(tails),
                     "k": cache["k"], "v": cache["v"], "pos": pos + 1}
    else:
        tails = []
        for i, p in enumerate(_layers(blocks, cfg.n_layers)):
            x, (st, tail), _ = ssm_block(
                x, p, cfg, lctx, cache=(cache["state"][i], cache["conv"][i]))
            cache["state"][i].copy_(st)
            tails.append(tail)
        # a fresh conv leaf: its dtype follows the window's, as in JAX
        new_cache = {"state": cache["state"], "conv": torch.stack(tails),
                     "pos": pos + 1}
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return ctx.c(_logits(params, x[:, 0], cfg, ctx), "logits"), new_cache


def prefill(params, batch, cfg, ctx):
    """Process the full prompt; returns last-token logits + a decode
    cache sized to the prompt (``launch.serve.grow_cache`` makes room
    for the tokens to come).  ``batch`` holds ``tokens`` [B, S] and, for
    the vlm family, optionally ``patch_embeds`` [B, n_patches, d]
    (prepended to the token embeddings in their dtype), for the encdec
    family ``enc_embeds`` [B, Se, d] (the encoder's input, taken in the
    embedding table's dtype)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg, ctx)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    x = ctx.c(x, "resid")
    blocks = params.get("blocks")
    lctx = ctx.at("blocks")
    if cfg.family == "encdec":
        enc_out = _enc_forward(
            params, batch["enc_embeds"].to(params["embed"].dtype), cfg, ctx)
        cross_k, cross_v = _cross_kv(params, enc_out, cfg, ctx)
        ks, vs = [], []
        dctx = ctx.at("dec_blocks")
        for i, p in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
            x, (k, v) = _dec_block(x, p, cfg, dctx, (cross_k[i], cross_v[i]))
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "cross_k": cross_k, "cross_v": cross_v}
    elif cfg.family in _BLOCK:
        block = _BLOCK[cfg.family]
        ks, vs = [], []
        for p in _layers(blocks, cfg.n_layers):
            x, (k, v), _ = block(ctx.c(x, "resid"), p, cfg, lctx)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif cfg.family == "hybrid":
        hrec, conv, ks, vs = [], [], [], []
        wnd = min(cfg.local_window, s)
        for i in range(cfg.n_layers):
            kind = cfg.pattern_at(i)
            x, c = hybrid_block(x, blocks[i], cfg, ctx.at("blocks", i), kind)
            if kind == "r":
                hrec.append(c[0])
                conv.append(c[1])
            else:
                # the last wnd positions, position p at ring slot p % wnd
                ks.append(torch.roll(c[0][:, -wnd:], s % wnd, dims=1))
                vs.append(torch.roll(c[1][:, -wnd:], s % wnd, dims=1))
        cache = {"hrec": torch.stack(hrec), "conv": torch.stack(conv),
                 "k": torch.stack(ks), "v": torch.stack(vs)}
    else:
        states, tails = [], []
        for p in _layers(blocks, cfg.n_layers):
            x, (st, tail), _ = ssm_block(ctx.c(x, "resid"), p, cfg, lctx)
            states.append(st)
            tails.append(tail)
        cache = {"state": torch.stack(states), "conv": torch.stack(tails)}
    cache["pos"] = torch.full((b,), x.shape[1], dtype=torch.int32,
                              device=x.device)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(params, x[:, -1], cfg, ctx), cache
