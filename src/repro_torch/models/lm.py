"""Model assembly for serving: init / prefill / decode, for the dense,
moe, ssm, hybrid, vlm and encdec families.

Port of the serving half of ``repro.models.lm``.  Parameters are the
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
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import resolve_device
from . import layers, moe, rglru, ssm
from .attention import attention, decode_attention
from .config import LMConfig
from .rope import apply_rope

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


@dataclass(frozen=True)
class ParallelCtx:
    """What the model knows about sharding.  On one device there is none:
    ``c(tensor, kind)`` is the identity.  The sharded stack, whose
    context constrains, waits for ROADMAP.md queue 1 item 9."""

    def c(self, t, kind):
        return t


NO_PARALLEL = ParallelCtx()


def _dt(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


def _layer(blocks, i):
    return {k: v[i] for k, v in blocks.items()}


# ============================================================ param init

def init_params(cfg: LMConfig, generator: torch.Generator, device=None):
    """Random parameters with the JAX package's distributions, drawn from
    ``generator`` on ``device`` (``cuda`` unless ``"cpu"`` is asked for;
    the generator must live there).  Not the same numbers as JAX's."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, "
                         f"the parameters go to {dev}")
    _check_family(cfg)
    dt = _dt(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    gen = generator
    params = {"embed": layers.normal(gen, (v, d), 0.02, dt),
              "final_norm": layers.zeros(gen, (d,), dt)}
    if not cfg.tie_embeddings:
        params["head"] = layers.normal(gen, (d, v), d ** -0.5, dt)
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        params["blocks"] = _init_dense_stack(gen, cfg, dt, L)
    elif cfg.family == "moe":
        blk = _init_dense_stack(gen, cfg, dt, L, ffn=False)
        blk.update(moe.init_moe(gen, cfg, dt, stack=(L,)))
        params["blocks"] = blk
    elif cfg.family == "ssm":
        blk = {"ln1": layers.zeros(gen, (L, d), dt)}
        blk.update(ssm.init_mamba2(gen, cfg, dt, stack=(L,)))
        params["blocks"] = blk
    elif cfg.family == "encdec":
        params["enc_blocks"] = _init_dense_stack(gen, cfg, dt,
                                                 cfg.n_enc_layers)
        dec = _init_dense_stack(gen, cfg, dt, L)
        dec.update({f"x_{k}": t for k, t in layers.init_attn(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qk_norm,
            cfg.use_bias, dt, stack=(L,)).items()})
        dec["ln3"] = layers.zeros(gen, (L, d), dt)
        params["dec_blocks"] = dec
        params["enc_norm"] = layers.zeros(gen, (d,), dt)
    else:                                              # hybrid
        params["blocks"] = []
        for i in range(L):
            p = {"ln1": layers.zeros(gen, (d,), dt),
                 "ln2": layers.zeros(gen, (d,), dt)}
            if cfg.pattern_at(i) == "r":
                p["rec"] = rglru.init_recurrent(gen, cfg, dt)
            else:
                p["attn"] = layers.init_attn(gen, d, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.hd,
                                             cfg.qk_norm, cfg.use_bias, dt)
            p["ffn"] = layers.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type,
                                       cfg.use_bias, dt)
            params["blocks"].append(p)
    return params


def _init_dense_stack(gen, cfg, dt, L, ffn=True):
    d = cfg.d_model
    blk = {"ln1": layers.zeros(gen, (L, d), dt),
           "ln2": layers.zeros(gen, (L, d), dt)}
    blk.update(layers.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.qk_norm, cfg.use_bias, dt,
                                stack=(L,)))
    if ffn:
        blk.update(layers.init_ffn(gen, d, cfg.d_ff, cfg.ffn_type,
                                   cfg.use_bias, dt, stack=(L,)))
    return blk


# ============================================================ sub-blocks

def _project_qkv(x, p, cfg, positions):
    b, s, _ = x.shape
    q = layers.dense(x, p["wq"], p.get("bq")).reshape(
        b, s, cfg.n_heads, cfg.hd)
    k = layers.dense(x, p["wk"], p.get("bk")).reshape(
        b, s, cfg.n_kv_heads, cfg.hd)
    v = layers.dense(x, p["wv"], p.get("bv")).reshape(
        b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_sub(x, p, cfg, ctx, *, causal=True, window=None, cache=None,
              pos=None, cross_kv=None):
    """Attention sub-block (no residual): self-attention, causal unless
    asked, over the last ``window`` positions when one is given; or,
    with ``cross_kv`` = (k, v) [B, Se, Hkv, hd], cross-attention of x's
    queries (no rope, no qk norm, not causal) over every row of them.
    cache: (k_l, v_l) for decode, written in place at ``pos`` (at
    ``pos % Wnd`` in the ring of a windowed layer)."""
    b, s, _ = x.shape
    if cross_kv is not None:                          # cross-attention (dec)
        q = layers.dense(x, p["wq"], p.get("bq")).reshape(
            b, s, cfg.n_heads, cfg.hd)
        k, v = cross_kv
        o = ctx.c(attention(q, k, v, causal=False), "attn_out")
        return layers.dense(o.reshape(b, s, -1), p["wo"], p.get("bo")), None
    if cache is None:
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = _project_qkv(x, p, cfg, positions)
        q = ctx.c(q, "attn_q")
        k = ctx.c(k, "attn_kv")
        v = ctx.c(v, "attn_kv")
        o = attention(q, k, v, causal=causal, window=window)
        o = ctx.c(o, "attn_out")
        return layers.dense(o.reshape(b, s, -1), p["wo"], p.get("bo")), (k, v)
    k_l, v_l = cache                                  # [B, Smax, Hkv, hd]
    q, k_new, v_new = _project_qkv(x, p, cfg, pos[:, None])
    slot = pos.long() if window is None else pos.long() % k_l.shape[1]
    bidx = torch.arange(b, device=x.device)
    k_l[bidx, slot] = k_new[:, 0].to(k_l.dtype)
    v_l[bidx, slot] = v_new[:, 0].to(v_l.dtype)
    kv_len = pos + 1 if window is None else \
        torch.clamp(pos + 1, max=k_l.shape[1])       # the ring bounds it
    o = decode_attention(q, k_l, v_l, kv_len)
    return (layers.dense(o.reshape(b, 1, -1), p["wo"], p.get("bo")),
            (k_l, v_l))


def _ffn_sub(x, p, cfg, ctx):
    fp = {k: p[k] for k in ("wg", "wu", "wd", "bu", "bd") if k in p}
    return ctx.c(layers.ffn(ctx.c(x, "ffn_in"), fp, cfg.ffn_type), "ffn_out")


# ============================================================ block bodies

def dense_block(x, p, cfg, ctx, cache=None, pos=None):
    h, kv = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, ctx,
                      cache=cache, pos=pos)
    x = x + h
    x = x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p, cfg, ctx)
    return x, kv


def moe_block(x, p, cfg, ctx, cache=None, pos=None):
    h, kv = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, ctx,
                      cache=cache, pos=pos)
    x = x + h
    y, _ = moe.moe_ffn(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p, cfg)
    return x + y, kv


def ssm_block(x, p, cfg, ctx, cache=None):
    h, new_cache = ssm.mamba2_block(
        layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, cache=cache)
    return x + h, new_cache


def hybrid_block(x, p, cfg, ctx, kind, cache=None, pos=None):
    if kind == "r":
        h, new_cache = rglru.recurrent_block(
            layers.rms_norm(x, p["ln1"], cfg.rms_eps), p["rec"], cfg,
            cache=cache)
    else:
        h, new_cache = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps),
                                 p["attn"], cfg, ctx,
                                 window=cfg.local_window, cache=cache,
                                 pos=pos)
    x = x + h
    x = x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p["ffn"],
                     cfg, ctx)
    return x, new_cache


_BLOCK = {"dense": dense_block, "vlm": dense_block, "moe": moe_block}


# ============================================================ enc-dec

def _xattn_params(p):
    """The cross-attention weights of a decoder layer (its ``x_`` leaves,
    prefix dropped)."""
    return {k[2:]: v for k, v in p.items() if k.startswith("x_")}


def _enc_forward(params, enc_embeds, cfg, ctx):
    """The encoder over the frame embeddings [B, Se, d]: per layer a
    non-causal self-attention (rope over arange(Se)) and the FFN, then
    ``enc_norm``."""
    x = enc_embeds
    blocks = params["enc_blocks"]
    for i in range(cfg.n_enc_layers):
        p = _layer(blocks, i)
        h, _ = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg,
                         ctx, causal=False)
        x = x + h
        x = x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p, cfg,
                         ctx)
    return layers.rms_norm(x, params["enc_norm"], cfg.rms_eps)


def _dec_block(x, p, cfg, ctx, cross_kv, cache=None, pos=None):
    """Decoder layer: causal self-attention, cross-attention over the
    encoder's K/V (the ``x_`` weights, after ``ln3``), then the FFN."""
    h, kv = _attn_sub(layers.rms_norm(x, p["ln1"], cfg.rms_eps), p, cfg, ctx,
                      cache=cache, pos=pos)
    x = x + h
    h, _ = _attn_sub(layers.rms_norm(x, p["ln3"], cfg.rms_eps),
                     _xattn_params(p), cfg, ctx, cross_kv=cross_kv)
    x = x + h
    x = x + _ffn_sub(layers.rms_norm(x, p["ln2"], cfg.rms_eps), p, cfg, ctx)
    return x, kv


def _cross_kv(params, enc_out, cfg):
    """Every decoder layer's cross K/V of the encoder output:
    ([L, B, Se, Hkv, hd], [L, B, Se, Hkv, hd])."""
    b, se, _ = enc_out.shape
    dec = params["dec_blocks"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        xp = _xattn_params(_layer(dec, i))
        ks.append(layers.dense(enc_out, xp["wk"], xp.get("bk")).reshape(
            b, se, cfg.n_kv_heads, cfg.hd))
        vs.append(layers.dense(enc_out, xp["wv"], xp.get("bv")).reshape(
            b, se, cfg.n_kv_heads, cfg.hd))
    return torch.stack(ks), torch.stack(vs)


# ============================================================ serving paths

def embed_tokens(params, tokens, cfg):
    x = params["embed"][tokens]
    if cfg.family == "hybrid":                        # gemma-style scaling
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _logits(params, x, cfg):
    # fp32 head product, as the JAX package computes it: with tied
    # embeddings this copies the [V, d] table to fp32 on every call
    return x.float() @ _head(params, cfg).float()


def init_decode_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None):
    """Zeroed decode cache (bf16 unless asked, whatever ``cfg.dtype``, as
    in JAX) on ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    _check_family(cfg)
    L = cfg.n_layers
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev),
                 "pos": pos}
        if cfg.family == "encdec":    # JAX's size; a serve keeps the
            # prefill's own cross leaves (launch.serve.grow_cache)
            shape = (L, batch, max(1, max_len // cfg.enc_ratio),
                     cfg.n_kv_heads, cfg.hd)
            cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache
    if cfg.family == "hybrid":
        w = cfg.lru_width or cfg.d_model
        n_r = sum(1 for i in range(L) if cfg.pattern_at(i) == "r")
        shape = (L - n_r, batch, min(cfg.local_window, max_len),
                 cfg.n_kv_heads, cfg.hd)
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
    x = ctx.c(embed_tokens(params, tokens, cfg), "resid_decode")
    pos = cache["pos"]
    blocks = params.get("blocks")
    if cfg.family in _BLOCK:
        block = _BLOCK[cfg.family]
        for i in range(cfg.n_layers):
            x, _ = block(x, _layer(blocks, i), cfg, ctx,
                         cache=(cache["k"][i], cache["v"][i]), pos=pos)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    elif cfg.family == "encdec":
        blocks = params["dec_blocks"]
        for i in range(cfg.n_layers):
            x, _ = _dec_block(x, _layer(blocks, i), cfg, ctx,
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
                    x, blocks[i], cfg, ctx, kind,
                    cache=(cache["hrec"][ir], cache["conv"][ir]))
                cache["hrec"][ir].copy_(h_new)
                tails.append(tail)
                ir += 1
            else:
                x, _ = hybrid_block(x, blocks[i], cfg, ctx, kind,
                                    cache=(cache["k"][ia], cache["v"][ia]),
                                    pos=pos)
                ia += 1
        new_cache = {"hrec": cache["hrec"], "conv": torch.stack(tails),
                     "k": cache["k"], "v": cache["v"], "pos": pos + 1}
    else:
        tails = []
        for i in range(cfg.n_layers):
            x, (st, tail) = ssm_block(
                x, _layer(blocks, i), cfg, ctx,
                cache=(cache["state"][i], cache["conv"][i]))
            cache["state"][i].copy_(st)
            tails.append(tail)
        # a fresh conv leaf: its dtype follows the window's, as in JAX
        new_cache = {"state": cache["state"], "conv": torch.stack(tails),
                     "pos": pos + 1}
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return ctx.c(_logits(params, x[:, 0], cfg), "logits"), new_cache


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
    x = embed_tokens(params, tokens, cfg)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    x = ctx.c(x, "resid")
    blocks = params.get("blocks")
    if cfg.family == "encdec":
        enc_out = _enc_forward(
            params, batch["enc_embeds"].to(params["embed"].dtype), cfg, ctx)
        cross_k, cross_v = _cross_kv(params, enc_out, cfg)
        dec = params["dec_blocks"]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, (k, v) = _dec_block(x, _layer(dec, i), cfg, ctx,
                                   (cross_k[i], cross_v[i]))
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "cross_k": cross_k, "cross_v": cross_v}
    elif cfg.family in _BLOCK:
        block = _BLOCK[cfg.family]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, (k, v) = block(ctx.c(x, "resid"), _layer(blocks, i), cfg, ctx)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif cfg.family == "hybrid":
        hrec, conv, ks, vs = [], [], [], []
        wnd = min(cfg.local_window, s)
        for i in range(cfg.n_layers):
            kind = cfg.pattern_at(i)
            x, c = hybrid_block(x, blocks[i], cfg, ctx, kind)
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
        for i in range(cfg.n_layers):
            x, (st, tail) = ssm_block(ctx.c(x, "resid"), _layer(blocks, i),
                                      cfg, ctx)
            states.append(st)
            tails.append(tail)
        cache = {"state": torch.stack(states), "conv": torch.stack(tails)}
    cache["pos"] = torch.full((b,), x.shape[1], dtype=torch.int32,
                              device=x.device)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _logits(params, x[:, -1], cfg), cache
