"""Mamba-2 SSD intra-chunk product (kernel K5) and its plain version.

Counterpart of ``repro/kernels/ssd_intra/ssd_intra.py``.  On CUDA
tensors :func:`ssd_intra` launches ``csrc/ssd_intra.cu`` (it replaces
the TPU kernel ``ssd_intra``, the ``pallas_call`` at line 52); on CPU
tensors it runs :func:`ssd_intra_plain`.  ``ssd_intra.launches`` counts
kernel launches.

cb [B, Q, Q] (= C @ B^T per chunk), cs [B, Q, H] (the chunk's cumsum of
dt * A), win [B, Q, H, P] (= dt * x); B folds batch and chunks.
Returns Y [B, Q, H, P] in win's dtype with

    Y[b, q, h, :] = sum_{k <= q} cb[b, q, k] * exp(cs[b, q, h] - cs[b, k, h])
                    * win[b, k, h, :]

computed in fp32.  No single PyTorch call computes this function.
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
    one fp32 einsum."""
    q = cb.shape[1]
    seg = cs.float()[:, :, None, :] - cs.float()[:, None, :, :]   # [B,Q,Q,H]
    mask = torch.ones((q, q), dtype=torch.bool, device=cb.device).tril()
    l_mat = torch.where(mask[None, :, :, None], torch.exp(seg), 0.0)
    return torch.einsum("bqk,bqkh,bkhp->bqhp", cb.float(), l_mat,
                        win.float()).to(win.dtype)


_SIGNATURES = {"ssd_intra_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])}


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


def ssd_intra(cb, cs, win):
    """The intra-chunk term of the SSD scan: returns [B, Q, H, P] in
    win's dtype."""
    _check(cb, cs, win)
    if win.device.type == "cpu":
        return ssd_intra_plain(cb, cs, win)
    if win.device.type != "cuda":
        raise ValueError(f"unsupported device {win.device}")
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
    return out


ssd_intra.launches = 0
