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

Gradients.  The Pallas kernel is forward-only (JAX differentiates its
jnp attention), so the port gives K4 a backward of its own.  On the
card, a call that needs a gradient (grad mode on and an input that
requires one) goes through :class:`_FlashAttentionFn`: its forward
launches K4 with a log-sum-exp output (``flash_attention_lse_launch``),
saves q, k, v, the output and the log-sum-exp, and its backward calls
:func:`flash_attention_bwd`, which launches ``csrc/flash_attention_bwd.cu``
(a dQ pass, then a dK/dV pass, on ``wgmma`` with TMA rings; hd 64 and
128) and counts one launch in ``flash_attention_bwd.launches`` a call.
Gradients come back in the memory layout of the model's [B, S, H, hd]
tensors.  A call that needs
no gradient (the serve) launches K4 without the log-sum-exp.  On the
CPU, the plain forward is differentiated by autograd;
:func:`flash_attention_bwd_plain` is the same backward from the
log-sum-exp, in fp32, that the tests and ``chip_smoke.py`` hold the
kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128)
_BWD_ROWS = 64      # q rows of csrc/flash_attention_bwd.cu's tiles
_DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30


def _check_window(window):
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be a positive integer, got {window}")


def _check_offset(q_offset):
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be an integer >= 0, got {q_offset}")


def _visible(sq, sk, causal, window, q_offset, device):
    """[Sq, Sk] bool: key j visible to query row i (JAX's ``_mask`` at
    query positions ``q_offset + arange(Sq)``), or None when every pair
    is."""
    if not causal and window is None:
        return None
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _logits(q, k, causal, window, q_offset):
    """fp32 scaled logits [B, Hkv, G, Sq, Sk] with masked pairs at -1e30,
    and the mask."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    mask = _visible(sq, sk, causal, window, q_offset, q.device)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return logits, mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_offset: int = 0, return_lse: bool = False):
    """Plain PyTorch version (the JAX ``ref.py``, with JAX's mask over
    query positions ``q_offset + arange(Sq)`` and key positions
    ``arange(Sk)``): fp32 logits for every (query, key) pair, the mask as
    -1e30, softmax, cast back.  With ``return_lse`` also each row's fp32
    log-sum-exp [B, Hq, Sq] of the scaled logits (what the kernel's
    forward saves for the backward)."""
    _check_window(window)
    _check_offset(q_offset)
    b, hq, sq, hd = q.shape
    logits, _ = _logits(q, k, causal, window, q_offset)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    o = o.reshape(b, hq, sq, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)
    return o


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=None, q_offset: int = 0):
    """Plain PyTorch version of the backward, FlashAttention-2's formulas
    from the saved log-sum-exp, in fp32: P = exp(s - lse) over the
    visible pairs, D = rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T -
    D), dQ = scale dS K, dK = scale dS^T Q (dK and dV summed over each
    kv head's q heads).  Returns (dq, dk, dv) in the inputs' dtype."""
    _check_window(window)
    _check_offset(q_offset)
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    logits, mask = _logits(q, k, causal, window, q_offset)
    p = torch.exp(logits - lse.float().reshape(b, hkv, g, sq)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dog = dout.reshape(b, hkv, g, sq, hd).float()
    delta = (dog * out.reshape(b, hkv, g, sq, hd).float()).sum(-1)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dog)
    ds = p * (torch.einsum("bkgqh,bksh->bkgqs", dog, v.float())
              - delta[..., None])
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds,
                      q.reshape(b, hkv, g, sq, hd).float()) * scale
    return (dq.reshape(b, hq, sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


_SIGNATURES = {"flash_attention_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "flash_attention_lse_launch": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])}
_BWD_SIGNATURES = {"flash_attention_bwd_launch": (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
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


def _check_card(ts, head_dims, what):
    """The kernels' own limits on CUDA tensors (head dim, grid, last
    dimension contiguous, bf16 vectors aligned)."""
    b, hq, _, hd = ts[0].shape
    if hd not in head_dims:
        raise ValueError(f"head_dim {hd} not supported by the {what} on "
                         f"the GPU (supported: {head_dims})")
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("the last dimension of every tensor must be "
                         "contiguous")
    if ts[0].dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in ts):
        raise ValueError("bf16 tensors must start 16-byte aligned with "
                         "strides of multiples of 8 (the kernels copy "
                         "16-byte vectors)")


def _empty_like_rows(t):
    """An empty tensor of t's [B, H, S, hd] shape in the [B, S, H, hd]
    memory layout (the model's), as its transposed view."""
    b, h, s, hd = t.shape
    return torch.empty((b, s, h, hd), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _launch_fwd(q, k, v, causal, window, q_offset, with_lse):
    """Launch K4 on CUDA tensors; returns the output and, with
    ``with_lse``, each row's fp32 log-sum-exp [B, Hq, Sq]."""
    _check_card((q, k, v), HEAD_DIMS, "forward")
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = _empty_like_rows(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    strides = (ctypes.c_longlong * 12)(*[
        st for t in (q, k, v, out) for st in t.stride()[:3]])
    lib = _build.load("flash_attention", _SIGNATURES)
    args = (ctypes.addressof(strides), b, hq, hkv, sq, sk, int(q_offset),
            hd, 1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(min(window, q_offset + sq)),
            int(q.dtype == torch.bfloat16), _build.stream_of(q))
    with torch.cuda.device(q.device):
        if with_lse:
            rc = lib.flash_attention_lse_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *args)
        else:
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


class _FlashAttentionFn(torch.autograd.Function):
    """K4 with its backward kernel, for CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _launch_fwd(q, k, v, causal, window, q_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal, window=window,
            q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0):
    """Attention of every query row (at position ``q_offset`` + its
    index) over the keys (up to its position when ``causal``; the last
    ``window`` positions up to it when ``window`` is given): returns
    [B, Hq, Sq, hd] in q's dtype, differentiable on both devices."""
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _launch_fwd(q, k, v, causal, window, q_offset, False)[0]


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window=None, q_offset: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at (q, k, v)
    with output ``out``, its rows' log-sum-exp ``lse`` (fp32 [B, Hq,
    Sq]) and the output's gradient ``dout``, in the inputs' dtype and
    the [B, S, H, hd] memory layout.  CUDA tensors launch
    ``csrc/flash_attention_bwd.cu`` (hd 64 and 128; hd 256 raises); CPU
    tensors run :func:`flash_attention_bwd_plain`."""
    _check(q, k, v, window, q_offset)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError("out and dout must have q's shape and lse "
                         "[B, Hq, Sq]")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(
            f"head_dim {q.shape[3]}: the backward kernel takes hd "
            f"{BWD_HEAD_DIMS}; hd 256 (recurrentgemma-2b) waits for "
            f"ROADMAP.md queue 1 item 4 (hybrid training on the card)")
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            out.device != q.device or dout.device != q.device:
        raise ValueError("out and dout must have q's dtype and device")
    if dout.stride(3) != 1 or (q.dtype == torch.bfloat16 and (
            dout.data_ptr() % 16 or any(st % 8 for st in dout.stride()[:3]))):
        dout = dout.contiguous()
    lse = lse.float().contiguous()
    dq, dk, dv = (_empty_like_rows(t) for t in (q, k, v))
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b == 0 or sq == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _check_card((q, k, v, out, dout), BWD_HEAD_DIMS, "backward")
    # the first launch's D and lse * log2 e, each [B * Hq] rows padded to
    # whole 64-row tiles, which the second launch's TMA reads as tiles
    delta = torch.empty(2 * b * hq * -(-sq // _BWD_ROWS) * _BWD_ROWS,
                        dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[
        st for t in (q, k, v, out, dout, dq, dk, dv) for st in t.stride()[:3]])
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            ctypes.addressof(strides), b, hq, hkv, sq, sk, int(q_offset),
            hd, 1.0 / math.sqrt(hd), int(causal),
            0 if window is None else int(min(window, q_offset + sq)),
            int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
