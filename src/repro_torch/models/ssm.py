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


def mamba2_block(x, p, cfg, cache=None):
    """Full block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    Prefill: x [B,S,d], cache None -> (y, (ssm_state, conv_tail)).
    Decode: x [B,1,d] with cache=(ssm_state [B,H,P,N], conv_tail
    [B,K-1,Cc]) -> (y, new_cache).
    """
    bsz, s, _ = x.shape
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    p_dim = cfg.ssm_head_dim

    zxbcdt = x @ p["w_in"]                                   # [B,S,2di+2N+H]
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [d_in, d_in, n, n, h],
                                        dim=-1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)            # [B,S,Cc]

    if cache is None:
        conv = _depthwise_causal_conv(conv_in, p["w_conv"])
        conv_tail = conv_in[:, -(cfg.conv_width - 1):, :]
    else:
        ssm_state, prev_tail = cache
        wdt = torch.promote_types(prev_tail.dtype, conv_in.dtype)
        window = torch.cat([prev_tail.to(wdt), conv_in.to(wdt)],
                           dim=1)                            # [B,K,Cc]
        conv = torch.einsum("bkc,kc->bc", window,
                            p["w_conv"].to(wdt))[:, None]
        conv_tail = window[:, 1:, :]
    conv = F.silu(conv)
    xs, bs, cs = torch.split(conv, [d_in, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    if cache is None:
        y, state = ssd_chunked(
            xs.reshape(bsz, s, h, p_dim), dt, p["a_log"], bs, cs,
            p["d_skip"], min(cfg.ssm_chunk, s))
        y = y.reshape(bsz, s, d_in)
    else:
        y, state = ssd_decode_step(
            xs[:, 0].reshape(bsz, h, p_dim), dt[:, 0], p["a_log"],
            bs[:, 0], cs[:, 0], p["d_skip"], ssm_state)
        y = y.reshape(bsz, 1, d_in)

    y = y.to(x.dtype) * F.silu(z)                            # gated
    y = rms_norm(y, p["norm"], cfg.rms_eps)
    out = y @ p["w_out"]
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
