"""Mamba-2 SSD (state-space duality) block — chunked scan + O(1) decode.

Port of ``repro.models.ssm``.  Math (Dao & Gu, arXiv:2405.21060): per
head h with state size N and head dim P, the recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t (B_t ⊗ x_t), y_t = C_t · h_t + D x_t is
evaluated in chunks of Q tokens:

  intra-chunk:  Y_intra = ((C Bᵀ) ∘ L) (dt ∘ X)  with L the causal
                exp-segsum matrix — kernel K5 (``kernels.ssd_intra``) on
                the card, its plain version on the CPU;
  inter-chunk:  chunk states S_c are passed through a short scan (a
                Python loop over chunks) and applied as
                Y_inter = (C ∘ exp(cumsum dA)) H_{c-1}.

Every exp of a cumsum difference is taken in fp32.

On a model rank (tensor parallelism, ``ctx`` a layer's
``ParallelCtx`` that splits ``w_out``) the block runs the rank's heads.
The rank holds the reference's even column block of ``w_in`` (which does
not fall on heads: z, x, B, C and dt share its one column dim) and of
``w_conv``: it projects its block, gathers the ``[B, S, 2di+2N+H]``
output and ``w_conv`` whole over the model ranks (one collective; the
backward reduce-scatters its share), then keeps z, x and dt of its heads
and B and C whole (one group, read by every head); the depthwise conv
runs on the channels it reads (its heads' x, B, C), so its decode conv
tail holds those, not the reference's even split of the channels.
``a_log``, ``dt_bias``, ``d_skip``, ``norm`` and ``w_out``'s rows fall on
heads; K5 runs on the rank's heads, the gated RMS norm's per-row sum of
squares over all ``di`` features is the ranks' sums added in fp32 in
rank order (``collectives.sum_ranks``, its gradient summed back over
them), and ``w_out`` is row-parallel.  Where the model axis does not
divide the heads the rank computes every head and keeps its block of
features from the norm on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssd_intra import ssd_intra
from .layers import keep_whole, normal, rms_norm, zeros


def _depthwise_causal_conv(x, w):
    """x: [B,S,C], w: [K,C] causal depthwise conv via K shifted adds."""
    k = w.shape[0]
    s = x.shape[1]
    y = x * w[-1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        y = y + shifted * w[-1 - i]
    return y


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int):
    """x:[B,S,H,P] dt:[B,S,H] a_log:[H] b,c:[B,S,N] -> y:[B,S,H,P], final
    state [B,H,P,N].  fp32 internal."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    assert s % chunk == 0, f"seq {s} % chunk {chunk} != 0"
    nc, q = s // chunk, chunk

    xf = x.reshape(bsz, nc, q, h, p).float()
    dtf = dt.reshape(bsz, nc, q, h).float()
    bf = b.reshape(bsz, nc, q, n).float()
    cf = c.reshape(bsz, nc, q, n).float()
    a = -torch.exp(a_log.float())                            # [H], negative
    da = dtf * a                                             # [B,nc,Q,H]
    cs = torch.cumsum(da, dim=2)                             # [B,nc,Q,H]

    # --- intra-chunk (dual quadratic form, causal-masked): kernel K5 ------
    cb = torch.matmul(cf, bf.transpose(-1, -2))              # [B,nc,Q,Q]
    w_in = dtf[..., None] * xf                               # dt ∘ x
    y_intra = ssd_intra(cb.reshape(bsz * nc, q, q),
                        cs.reshape(bsz * nc, q, h),
                        w_in.reshape(bsz * nc, q, h, p)
                        ).reshape(bsz, nc, q, h, p)

    # --- chunk states + inter-chunk scan ----------------------------------
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)          # [B,nc,Q,H]
    states = torch.einsum("bckn,bckhp->bchpn", bf,
                          (dtf * decay_to_end)[..., None] * xf)  # [B,nc,H,P,N]
    chunk_decay = torch.exp(cs[:, :, -1, :])                 # [B,nc,H]

    h_prev = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
    before = []
    for ci in range(nc):
        before.append(h_prev)
        h_prev = h_prev * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_before = torch.stack(before, dim=1)                    # [B,nc,H,P,N]

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cf, h_before) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y, h_prev


def ssd_decode_step(x, dt, a_log, b, c, d_skip, state):
    """One token: x:[B,H,P] dt:[B,H] b,c:[B,N] state:[B,H,P,N]."""
    xf = x.float()
    dtf = dt.float()
    a = -torch.exp(a_log.float())
    decay = torch.exp(dtf * a)                               # [B,H]
    upd = (dtf[:, :, None] * xf)[..., None] * b.float()[:, None, None, :]
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c.float(), state)
    y = y + d_skip.float()[None, :, None] * xf
    return y, state


def _heads(cfg, ctx, tp):
    """(first, count): the heads a model rank computes, its block where
    it holds its block of ``a_log`` (the model axis divides H), else
    every head."""
    h = cfg.n_ssm_heads
    if not (tp and ctx.split("a_log")):
        return 0, h
    n = h // ctx.mesh.n_ranks(ctx.tp_axis)
    return ctx.mesh.coord(ctx.tp_axis) * n, n


def _gated_norm(y, z, scale, cfg, ctx, tp, split_heads):
    """``rms_norm(y * silu(z), scale)`` over all ``d_inner`` features.
    On a model rank (``tp``) with its heads' features
    (``split_heads``) the per-row sum of squares is the ranks' summed in
    fp32 in rank order (its gradient, the rank's share, summed back
    over them: ``enter`` then ``sum_ranks``); with every head's it is
    taken here and the rank keeps its block of features (``scale``'s)."""
    y = y.to(z.dtype) * F.silu(z)
    if not tp:
        return rms_norm(y, scale, cfg.rms_eps)
    from ..parallel import collectives as cl
    mesh, ax = ctx.mesh, ctx.tp_axis
    yf = y.float()
    ss = yf.square().sum(-1, keepdim=True)
    if split_heads:
        ss = cl.sum_ranks(cl.enter(ss, mesh, ax), mesh, ax)
    yf = yf * torch.rsqrt(ss / cfg.d_inner + cfg.rms_eps)
    rows = scale.shape[-1]
    if yf.shape[-1] != rows:
        yf = yf.narrow(-1, mesh.coord(ax) * rows, rows)
    return (yf * (1.0 + scale.float())).to(y.dtype)


def mamba2_block(x, p, cfg, cache=None, ctx=None):
    """Full block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    Prefill: x [B,S,d], cache None -> (y, (ssm_state, conv_tail)).
    Decode: x [B,1,d] with cache=(ssm_state [B,H,P,N], conv_tail
    [B,K-1,Cc]) -> (y, new_cache).  On a model rank (``ctx`` splits
    ``w_out``: the module's docstring) H is the rank's heads and Cc the
    channels its conv reads.
    """
    bsz, s, _ = x.shape
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    p_dim = cfg.ssm_head_dim
    tp = ctx is not None and ctx.split("w_out")
    first, count = _heads(cfg, ctx, tp)
    w_conv = p["w_conv"]
    if tp:
        from ..parallel import collectives as cl
        x = cl.enter(x, ctx.mesh, ctx.tp_axis)

    zxbcdt = x @ p["w_in"]                                   # [B,S,2di+2N+H]
    if tp:
        whole = [(t, d) for t, d, key in ((zxbcdt, 2, "w_in"),
                                          (w_conv, 1, "w_conv"))
                 if ctx.split(key)]
        got = iter(cl.gather_blocks([t for t, _ in whole], ctx.mesh,
                                    [d for _, d in whole], ctx.tp_axis))
        zxbcdt = next(got) if ctx.split("w_in") else zxbcdt
        w_conv = next(got) if ctx.split("w_conv") else w_conv
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [d_in, d_in, n, n, h],
                                        dim=-1)
    if count < h:                                  # the rank's heads
        lo, k = first * p_dim, count * p_dim
        z, xc = z.narrow(-1, lo, k), xc.narrow(-1, lo, k)
        dt = dt.narrow(-1, first, count)
        w_conv = torch.cat([w_conv[:, lo:lo + k], w_conv[:, d_in:]], -1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)            # [B,S,Cc]
    d_in = count * p_dim

    if cache is None:
        conv = _depthwise_causal_conv(conv_in, w_conv)
        conv_tail = conv_in[:, -(cfg.conv_width - 1):, :]
    else:
        ssm_state, prev_tail = cache
        wdt = torch.promote_types(prev_tail.dtype, conv_in.dtype)
        window = torch.cat([prev_tail.to(wdt), conv_in.to(wdt)],
                           dim=1)                            # [B,K,Cc]
        conv = torch.einsum("bkc,kc->bc", window,
                            w_conv.to(wdt))[:, None]
        conv_tail = window[:, 1:, :]
    conv = F.silu(conv)
    xs, bs, cs = torch.split(conv, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    if cache is None:
        y, state = ssd_chunked(
            xs.reshape(bsz, s, count, p_dim), dt, p["a_log"], bs, cs,
            p["d_skip"], min(cfg.ssm_chunk, s))
        y = y.reshape(bsz, s, d_in)
    else:
        y, state = ssd_decode_step(
            xs[:, 0].reshape(bsz, count, p_dim), dt[:, 0], p["a_log"],
            bs[:, 0], cs[:, 0], p["d_skip"], ssm_state)
        y = y.reshape(bsz, 1, d_in)

    y = _gated_norm(y.to(x.dtype), z, p["norm"], cfg, ctx, tp, count < h)
    out = y @ p["w_out"]
    if tp:
        out = cl.sum_ranks(out, ctx.mesh, ctx.tp_axis)
    return out, (state, conv_tail)


def init_mamba2(gen, cfg, dtype, stack=(), cut=keep_whole):
    """``cut(key, leaf)`` is applied to each leaf as soon as it is
    drawn."""
    d, d_in, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    s = tuple(stack)
    proj_out = 2 * d_in + 2 * n + h
    p = {}
    p["w_in"] = cut("w_in", normal(gen, s + (d, proj_out),
                                   1.0 / math.sqrt(d), dtype))
    p["w_conv"] = cut("w_conv", normal(
        gen, s + (cfg.conv_width, d_in + 2 * n), 0.1, dtype))
    p["a_log"] = cut("a_log", zeros(gen, s + (h,), torch.float32))
    p["dt_bias"] = cut("dt_bias", zeros(gen, s + (h,), torch.float32))
    p["d_skip"] = cut("d_skip", torch.ones(s + (h,), dtype=torch.float32,
                                           device=gen.device))
    p["norm"] = cut("norm", zeros(gen, s + (d_in,), dtype))
    p["w_out"] = cut("w_out", normal(gen, s + (d_in, d),
                                     1.0 / math.sqrt(d_in), dtype))
    return p
