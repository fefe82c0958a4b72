"""Forward GQA flash attention (kernel K4) and its plain version.

Counterpart of ``repro/kernels/flash_attention/flash_attention.py``.
On CUDA tensors :func:`flash_attention` launches
``csrc/flash_attention.cu`` (it replaces the TPU kernel
``flash_attention``, the ``pallas_call`` at line 90): bf16 inputs go
through its tensor-core kernel, which rounds the probabilities to bf16
before the P.V product, fp32 inputs through its fp32 FMA kernel.  On
CPU tensors it runs :func:`flash_attention_plain`.
``flash_attention.launches`` counts kernel launches.

q [B, Hq, S, hd]; k, v [B, Hkv, S, hd] with Hq a multiple of Hkv (the kv
head of q head h is h // (Hq // Hkv)).  Any strides are taken as long as
the last dimension is contiguous, so ``x.transpose(1, 2)`` of the
model's [B, S, H, hd] tensors goes in without a copy.  Scores, softmax
and accumulation are fp32, the scale is 1/sqrt(hd), the output has q's
dtype and the [B, S, Hq, hd] memory layout (returned as its
[B, Hq, S, hd] view).  Any S: unlike the Pallas kernel, S need not be a
multiple of a block size.  ``window=W`` limits each query i to the keys
j > i - W (JAX's ``_mask`` in ``repro/models/attention.py``: with
``causal``, the W positions i - W + 1 .. i); the Pallas kernel has no
window, so this one is the port's own route for the hybrid family's
local attention.  Key tiles wholly outside the window are not visited.
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


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """Plain PyTorch version (the JAX ``ref.py``, with JAX's window mask):
    fp32 logits for every (query, key) pair, the mask as -1e30, softmax,
    cast back."""
    _check_window(window)
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal or window is not None:
        pos = torch.arange(s, device=q.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pos[:, None] >= pos[None, :]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(b, hq, s, hd).to(q.dtype)


_SIGNATURES = {"flash_attention_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])}


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, Hq, S, hd] and k, v "
                         "[B, Hkv, S, hd] of one shape")
    b, hq, s, hd = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd \
            or hq % k.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)} (self-attention: one S; "
                         f"Hq a multiple of Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must all be float32 or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention of every query row over the keys of its sequence (the
    last ``window`` positions up to it when ``window`` is given): returns
    [B, Hq, S, hd] in q's dtype."""
    _check(q, k, v)
    _check_window(window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
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
    out = torch.empty((b, s, hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[
        st for t in (q, k, v, out) for st in t.stride()[:3]])
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, hq, hkv, s, hd,
            1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(min(window, s)),
            int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
