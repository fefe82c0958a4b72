"""Forward GQA flash attention (kernel K4) and its plain version.

Counterpart of ``repro/kernels/flash_attention/flash_attention.py``.
On CUDA tensors :func:`flash_attention` launches
``csrc/flash_attention.cu`` (it replaces the TPU kernel
``flash_attention``, the ``pallas_call`` at line 90): bf16 inputs go
through its tensor-core kernel, which rounds the probabilities to bf16
before the P.V product, fp32 inputs through its fp32 FMA kernel.  On
CPU tensors it runs :func:`flash_attention_plain`.
``flash_attention.launches`` counts kernel launches.

q [B, Hq, Sq, hd]; k, v [B, Hkv, Sk, hd] with Hq a multiple of Hkv (the
kv head of q head h is h // (Hq // Hkv)).  Any strides are taken as long
as the last dimension is contiguous, so ``x.transpose(1, 2)`` of the
model's [B, S, H, hd] tensors goes in without a copy.  Scores, softmax
and accumulation are fp32, the scale is 1/sqrt(hd), the output has q's
dtype and the [B, Sq, Hq, hd] memory layout (returned as its
[B, Hq, Sq, hd] view).  Any Sq and Sk: unlike the Pallas kernel, neither
need be a multiple of a block size, and they may differ.  Query row i
sits at position ``q_offset + i`` (JAX's ``_mask`` in
``repro/models/attention.py`` with ``qpos = q_offset + i``): with
``causal`` it sees the keys j <= q_offset + i, and ``window=W`` limits
it to the keys j > q_offset + i - W.  The Pallas kernel has neither a
window nor an Sk of its own nor an offset, so these are the port's own
routes: the hybrid family's local attention, and the encoder-decoder's
cross-attention (not causal, Sq != Sk), the same function as JAX's
``dense_attention`` that its model calls.  Key tiles wholly outside a
q tile's window or causal bound are not visited.  A call in which some
query row sees no key (only a window can cause it, with Sk >= 1 and
``q_offset >= 0``) raises ``ValueError`` on every device: JAX's dense
path would return the mean of all V rows there.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30


def _check_window(window):
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be a positive integer, got {window}")


def _check_offset(q_offset):
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be an integer >= 0, got {q_offset}")


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_offset: int = 0):
    """Plain PyTorch version (the JAX ``ref.py``, with JAX's mask over
    query positions ``q_offset + arange(Sq)`` and key positions
    ``arange(Sk)``): fp32 logits for every (query, key) pair, the mask as
    -1e30, softmax, cast back."""
    _check_window(window)
    _check_offset(q_offset)
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal or window is not None:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(b, hq, sq, hd).to(q.dtype)


_SIGNATURES = {"flash_attention_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])}


def _check(q, k, v, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, Hq, Sq, hd] and k, v "
                         "[B, Hkv, Sk, hd] of one shape")
    b, hq, sq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or hq % k.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)} (one B and hd; Hq a "
                         f"multiple of Hkv)")
    _check_window(window)
    _check_offset(q_offset)
    sk = k.shape[2]
    if sq and (sk == 0 or window is not None
               and q_offset + sq - window >= sk):
        raise ValueError(f"a query row sees no key: Sq {sq} at offset "
                         f"{q_offset}, Sk {sk}, window {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must all be float32 or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0):
    """Attention of every query row (at position ``q_offset`` + its
    index) over the keys (up to its position when ``causal``; the last
    ``window`` positions up to it when ``window`` is given): returns
    [B, Hq, Sq, hd] in q's dtype."""
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported on the GPU "
                         f"(supported: {HEAD_DIMS})")
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the last dimension of q, k and v must be "
                         "contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start 16-byte aligned with "
                         "strides of multiples of 8 (the kernel copies "
                         "16-byte vectors)")
    out = torch.empty((b, sq, hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[
        st for t in (q, k, v, out) for st in t.stride()[:3]])
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, hq, hkv, sq, sk, int(q_offset),
            hd, 1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(min(window, q_offset + sq)),
            int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
