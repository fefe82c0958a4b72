"""Mamba-2 SSD intra-chunk product (kernel K5) and its plain version.

Counterpart of ``repro/kernels/ssd_intra/ssd_intra.py``.  On CUDA
tensors :func:`ssd_intra` launches ``csrc/ssd_intra.cu`` (it replaces
the TPU kernel ``ssd_intra``, the ``pallas_call`` at line 52); on CPU
tensors it runs :func:`ssd_intra_plain`.  ``ssd_intra.launches`` counts
kernel launches and ``ssd_intra.flops`` their operations
(:func:`kernel_flops`; ``ssd_intra_bwd`` counts its own alike).

cb [B, Q, Q] (= C @ B^T per chunk), cs [B, Q, H] (the chunk's cumsum of
dt * A), win [B, Q, H, P] (= dt * x); B folds batch and chunks.
Returns Y [B, Q, H, P] in win's dtype with

    Y[b, q, h, :] = sum_{k <= q} cb[b, q, k] * exp(cs[b, q, h] - cs[b, k, h])
                    * win[b, k, h, :]

computed in fp32.  No single PyTorch call computes this function.

Gradients.  The Pallas kernel is forward-only (JAX differentiates the
einsum of its model), so the port gives K5 a backward of its own.  On
the card, a call that needs a gradient goes through :class:`_SsdIntraFn`:
its forward launches K5 and saves cb, cs, win and the output; its
backward calls :func:`ssd_intra_bwd`, which launches
``csrc/ssd_intra_bwd.cu`` (fp32 on the tensor cores in 3xTF32, Q <= 256,
P in {16, 32, 64, 128}) and counts ``ssd_intra_bwd.launches``.  On the
CPU, the plain forward is differentiated by autograd;
:func:`ssd_intra_bwd_plain` is the same backward, which the tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_Q = 256
MAX_P = 128
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_intra_plain(cb, cs, win):
    """Plain PyTorch version (the JAX ``ref.py`` and the einsum branch of
    ``models/ssm.ssd_chunked``): the masked decay matrix by select, then
    one fp32 einsum.  The select comes before the exp as well as after
    it, so autograd's gradient stays finite where exp overflows above the
    diagonal (JAX's ``where(mask, exp(seg), 0)`` gives NaN there: 0 times
    the derivative inf)."""
    l_mat = _decay(cs, cb.shape[1])
    return torch.einsum("bqk,bqkh,bkhp->bqhp", cb.float(), l_mat,
                        win.float()).to(win.dtype)


def _decay(cs, q):
    """L [B, Q, Q, H] = exp(cs[q] - cs[k]) for k <= q, else 0, in fp32;
    masked entries never reach the exp."""
    seg = cs.float()[:, :, None, :] - cs.float()[:, None, :, :]   # [B,Q,Q,H]
    mask = torch.ones((q, q), dtype=torch.bool, device=cs.device).tril()
    mask = mask[None, :, :, None]
    return torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)


def ssd_intra_bwd_plain(cb, cs, win, dy):
    """Plain PyTorch version of the backward, in fp32, with L the masked
    decay matrix (selected before it multiplies, as the forward):
    G = dY . Win, dWin = (cb o L)^T dY, dcb = sum_h L o G, and with
    dS = cb o L o G, dcs = rowsum(dS) - colsum(dS).  Returns (dcb, dcs,
    dwin) in the inputs' dtype."""
    l_mat = _decay(cs, cb.shape[1])
    g = torch.einsum("bqhp,bkhp->bqkh", dy.float(), win.float())
    cbl = cb.float()[..., None] * l_mat
    dwin = torch.einsum("bqkh,bqhp->bkhp", cbl, dy.float())
    dcb = (l_mat * g).sum(-1)
    ds = cbl * g
    dcs = ds.sum(2) - ds.sum(1)
    return dcb.to(cb.dtype), dcs.to(cs.dtype), dwin.to(win.dtype)


_SIGNATURES = {"ssd_intra_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])}
_BWD_SIGNATURES = {"ssd_intra_bwd_launch": (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])}
BWD_P = (16, 32, 64, 128)
# csrc/ssd_intra_bwd.cu's tiling: a block owns 64 keys and 8 heads, and
# leaves a [Q, 64] dCB strip in the scratch for its key tile's last block
# to sum
_BWD_KT, _BWD_HPB = 64, 8
# the kernel's per-key-tile counters, by (device, stream): zero on the
# first call, and every call leaves them zero (the key tile's last block
# resets its own), so no call needs a zeroing launch; calls on one
# stream run in order and share them
_done_counters: dict = {}


def _counters(device, n: int):
    """A zeroed int32 buffer of at least ``n`` counters for the current
    stream of ``device``; under CUDA-graph capture a fresh one, whose
    zero fill the graph replays."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _done_counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _done_counters[key] = buf
    return buf


def kernel_flops(b, q, h, p, backward=False) -> int:
    """The products' operations of one launch, 2 a multiply-add, over
    the q(q+1)/2 causal (q, k) pairs of each of the b chunks and h heads:
    the forward's sum over k of CB L Win, 2 x p a pair; the backward's G
    = dY Win^T and dWin = (CB L)^T dY, 4 x p a pair."""
    return (4 if backward else 2) * p * b * h * (q * (q + 1) // 2)


def bwd_buffers(cb, cs, win):
    """The backward's outputs dcb, dcs, dwin and its fp32 scratch of
    [Q, 64] dCB strips, one for each (key tile, head group)."""
    b, q, h, _ = win.shape
    part = torch.empty(b * -(-q // _BWD_KT) * -(-h // _BWD_HPB) * q
                       * _BWD_KT, dtype=torch.float32, device=win.device)
    return (*(torch.empty_like(t) for t in (cb, cs, win)), part)


def _check(cb, cs, win):
    if cb.dim() != 3 or cs.dim() != 3 or win.dim() != 4:
        raise ValueError("cb must be [B, Q, Q], cs [B, Q, H] and win "
                         "[B, Q, H, P]")
    b, q, q2 = cb.shape
    if q2 != q or cs.shape[:2] != (b, q) or win.shape[:3] != cs.shape:
        raise ValueError(f"shape mismatch: cb {tuple(cb.shape)}, cs "
                         f"{tuple(cs.shape)}, win {tuple(win.shape)}")
    if win.dtype not in _DTYPES or cb.dtype != win.dtype \
            or cs.dtype != win.dtype:
        raise ValueError("cb, cs and win must all be float32 or all "
                         "bfloat16")
    if cb.device != win.device or cs.device != win.device:
        raise ValueError("cb, cs and win must be on one device")


def _launch_fwd(cb, cs, win):
    b, q, h, p = win.shape
    if q > MAX_Q or p > MAX_P:
        raise ValueError(f"chunk {q} or head dim {p} too large for the "
                         f"kernel (at most {MAX_Q} and {MAX_P})")
    if b > 65535:
        raise ValueError(f"{b} chunks exceed the grid's 65535")
    if not (cb.is_contiguous() and cs.is_contiguous()
            and win.is_contiguous()):
        raise ValueError("cb, cs and win must be contiguous")
    out = torch.empty_like(win)
    lib = _build.load("ssd_intra", _SIGNATURES)
    with torch.cuda.device(win.device):
        rc = lib.ssd_intra_launch(
            cb.data_ptr(), cs.data_ptr(), win.data_ptr(), out.data_ptr(),
            b, q, h, p, int(win.dtype == torch.bfloat16),
            _build.stream_of(win))
    _build.check(rc, "ssd_intra")
    ssd_intra.launches += 1
    ssd_intra.flops += kernel_flops(b, q, h, p)
    return out


class _SsdIntraFn(torch.autograd.Function):
    """K5 with its backward kernel, for CUDA tensors."""

    @staticmethod
    def forward(ctx, cb, cs, win):
        out = _launch_fwd(cb, cs, win)
        ctx.save_for_backward(cb, cs, win, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        cb, cs, win, y = ctx.saved_tensors
        return ssd_intra_bwd(cb, cs, win, dy, y)


def ssd_intra(cb, cs, win):
    """The intra-chunk term of the SSD scan: returns [B, Q, H, P] in
    win's dtype, differentiable on both devices."""
    _check(cb, cs, win)
    if win.device.type == "cpu":
        return ssd_intra_plain(cb, cs, win)
    if win.device.type != "cuda":
        raise ValueError(f"unsupported device {win.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (cb, cs, win)):
        return _SsdIntraFn.apply(cb, cs, win)
    return _launch_fwd(cb, cs, win)


ssd_intra.launches = 0
ssd_intra.flops = 0


def ssd_intra_bwd(cb, cs, win, dy, y):
    """Gradients (dcb, dcs, dwin) of :func:`ssd_intra` at (cb, cs, win)
    for the output's gradient ``dy``, given the forward's output ``y``.
    CUDA tensors launch ``csrc/ssd_intra_bwd.cu``, which reads ``y`` and
    takes fp32 only; CPU tensors run :func:`ssd_intra_bwd_plain`, which
    does not need it."""
    _check(cb, cs, win)
    if dy.shape != win.shape or y.shape != win.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and y {tuple(y.shape)} must "
                         f"have win's shape {tuple(win.shape)}")
    if win.device.type == "cpu":
        return ssd_intra_bwd_plain(cb, cs, win, dy)
    if win.device.type != "cuda":
        raise ValueError(f"unsupported device {win.device}")
    b, q, h, p = win.shape
    if win.dtype != torch.float32:
        raise ValueError("the K5 backward kernel takes fp32 only (the "
                         "model calls K5 on fp32 tensors)")
    if q > MAX_Q or p not in BWD_P:
        raise ValueError(f"chunk {q} or head dim {p} not taken by the "
                         f"backward kernel (Q <= {MAX_Q}, P in {BWD_P})")
    if b > 65535:
        raise ValueError(f"{b} chunks exceed the grid's 65535")
    cb, cs, win, y, dy = (t.contiguous() for t in (cb, cs, win, y, dy))
    dcb, dcs, dwin, part = bwd_buffers(cb, cs, win)
    done = _counters(win.device, b * -(-q // _BWD_KT))
    lib = _build.load("ssd_intra_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(win.device):
        rc = lib.ssd_intra_bwd_launch(
            cb.data_ptr(), cs.data_ptr(), win.data_ptr(), y.data_ptr(),
            dy.data_ptr(), dcb.data_ptr(), dcs.data_ptr(), dwin.data_ptr(),
            part.data_ptr(), done.data_ptr(), b, q, h, p,
            _build.stream_of(win))
    _build.check(rc, "ssd_intra_bwd")
    ssd_intra_bwd.launches += 1
    ssd_intra_bwd.flops += kernel_flops(b, q, h, p, backward=True)
    return dcb, dcs, dwin


ssd_intra_bwd.launches = 0
ssd_intra_bwd.flops = 0
