"""GQA attention: dense, block-wise (flash-style), and decode.

Port of ``repro.models.attention``.  On the CPU, :func:`attention`
dispatches as the JAX module does: ``dense_attention`` at or below
``dense_threshold`` tokens, ``blockwise_attention`` above.  On the card
every call runs kernel K4 (``kernels.flash_attention``): self-attention
with or without a window, a query offset, and cross-attention (Sq !=
Sk); it never falls back to the plain paths.  A call in which some query
row sees no key (a window past the keys) raises ``ValueError`` there,
where JAX's dense path returns the mean of all V rows.
``blockwise_attention`` visits the (q block, k block) pairs that hold a
visible key, counted in token positions: JAX's ``_block_pairs``
compares block indices of two sizes and with a window drops pairs it
needs whenever ``block_q != block_k`` (its defaults are 512 and 1024),
so the port does not copy it (ROADMAP.md, "Semantics the port fixed").
``decode_attention`` is plain PyTorch on both devices, as the JAX
package computes it outside any Pallas kernel.  Training differentiates
:func:`attention` on both devices: on the card through K4's autograd
Function and its backward kernel, on the CPU through autograd.
"""

from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import flash_attention

NEG_INF = -1e30


def _group(q, n_kv):
    """[B,S,Hq,hd] -> [B,S,Hkv,G,hd]"""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def _mask(qpos, kpos, causal, window):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def dense_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    kv_len=None):
    """Reference / small-S path.  q:[B,Sq,Hq,hd] k,v:[B,Sk,Hkv,hd]."""
    b, sq, hq, hd = q.shape
    n_kv = k.shape[2]
    qg = _group(q, n_kv).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    logits = logits * (1.0 / math.sqrt(hd))                  # [B,Hkv,G,Sq,Sk]
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    if kv_len is not None:                                   # [B] valid length
        mask = mask[None] & (kpos[None, None, :] < kv_len[:, None, None])
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    else:
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def _block_pairs(n_q: int, n_k: int, block_q: int, block_k: int,
                 causal: bool, window, q_offset: int = 0):
    """Static list of (iq, ik) block pairs inside the attention footprint:
    a pair is skipped only when every key of block ik is masked for every
    query of block iq (a skipped pair would have added exactly 0)."""
    pairs = []
    for iq in range(n_q):
        q_lo = q_offset + iq * block_q
        q_hi = q_lo + block_q - 1
        for ik in range(n_k):
            k_lo, k_hi = ik * block_k, (ik + 1) * block_k - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi <= q_lo - window:
                continue
            pairs.append((iq, ik))
    return pairs


def blockwise_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                        block_q: int = 512, block_k: int = 1024):
    """Flash-style attention, a loop over the static causal block list.

    q:[B,Sq,Hq,hd]  k,v:[B,Sk,Hkv,hd]  (Sq % block_q == 0, Sk % block_k == 0)
    """
    b, sq, hq, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    g = hq // n_kv
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    assert sq % block_q == 0 and sk % block_k == 0
    n_q, n_k = sq // block_q, sk // block_k
    pairs = _block_pairs(n_q, n_k, block_q, block_k, causal, window,
                         q_offset)

    qg = _group(q, n_kv) * (1.0 / math.sqrt(hd))
    acc = torch.zeros((b, sq, n_kv, g, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, sq, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, n_kv, g), dtype=torch.float32, device=q.device)
    qpos_base = q_offset + torch.arange(block_q, device=q.device)
    kpos_base = torch.arange(block_k, device=q.device)

    for iq, ik in pairs:
        qsl = slice(iq * block_q, (iq + 1) * block_q)
        ksl = slice(ik * block_k, (ik + 1) * block_k)
        s = torch.einsum("bqkgh,bskh->bqkgs", qg[:, qsl].float(),
                         k[:, ksl].float())                  # [B,bq,Hkv,G,bk]
        msk = _mask(qpos_base + iq * block_q, kpos_base + ik * block_k,
                    causal, window)
        s = torch.where(msk[None, :, None, None, :], s, NEG_INF)
        m_blk = s.amax(dim=-1)                               # [B,bq,Hkv,G]
        m_old, l_old, a_old = m[:, qsl], l[:, qsl], acc[:, qsl]
        m_new = torch.maximum(m_old, m_blk)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l[:, qsl] = l_old * corr + p.sum(dim=-1)
        acc[:, qsl] = a_old * corr[..., None] + torch.einsum(
            "bqkgs,bskh->bqkgh", p, v[:, ksl].float())
        m[:, qsl] = m_new

    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, *, window=None):
    """Single-token decode: q:[B,1,Hq,hd], caches:[B,Smax,Hkv,hd],
    kv_len:[B] number of valid cache slots (the new token already written)."""
    b, _, hq, hd = q.shape
    n_kv = k_cache.shape[2]
    qg = _group(q, n_kv).float()[:, 0]                      # [B,Hkv,G,hd]
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     k_cache.float()) * (1.0 / math.sqrt(hd))  # [B,Hkv,G,S]
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, :] < kv_len[:, None]                  # [B,S]
    if window is not None:
        mask &= kpos[None, :] >= kv_len[:, None] - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    # fp32 softmax over the (possibly huge) cache axis
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, q_offset=0,
              dense_threshold: int = 2048, block_q: int = 512,
              block_k: int = 1024):
    """q:[B,Sq,Hq,hd] k,v:[B,Sk,Hkv,hd] -> [B,Sq,Hq,hd].  On the card:
    kernel K4; on the CPU: dense for small S, blockwise beyond."""
    if q.device.type == "cuda":
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window,
                               q_offset=q_offset).transpose(1, 2)
    if q.shape[1] <= dense_threshold and k.shape[1] <= dense_threshold:
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, block_q=block_q,
                               block_k=block_k)
