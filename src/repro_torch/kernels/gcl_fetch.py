"""Fetch-on-grant: latch verdict + payload gather (kernel K2) and its
plain version.

Counterpart of ``repro/kernels/gcl_fetch/ops.py:fetch``.  On a CUDA
tensor :func:`fetch` launches ``csrc/gcl_fetch.cu`` (it replaces the
TPU kernel ``repro/kernels/gcl_fetch/gcl_fetch.py:gcl_fetch``); on a CPU
tensor it runs :func:`gcl_fetch_plain`.  ``fetch.launches`` counts
kernel launches.

Duplicate requests for one page OR their reader bits into
``new_words`` — what the reference's docstring promises.  The JAX
implementation writes with ``.at[].set``, whose result for duplicate
indices is implementation-defined, so the two agree whenever duplicate
requests carry equal bits; the round engine passes zero bits, so no
caller of the port sees a difference.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .latch_ops import chain_rank

WRITER_MASK_HI = -16777216      # int32 view of 0xFF000000


def gcl_fetch_plain(pages, words, req_page, bit_hi, bit_lo):
    """Plain PyTorch version; the OR merge runs rank by rank so that
    duplicate requests combine instead of overwriting each other."""
    valid = req_page >= 0
    idx = req_page.long().clamp(min=0)
    payload = torch.where(valid.view(-1, *([1] * (pages.dim() - 1))),
                          pages[idx], 0).to(pages.dtype)
    old = words[idx]
    old_hi = torch.where(valid, old[:, 0], 0)
    old_lo = torch.where(valid, old[:, 1], 0)
    granted = (valid & ((old_hi & WRITER_MASK_HI) == 0)).to(torch.int32)
    new_words = words.clone()
    if req_page.shape[0]:
        rank = chain_rank(req_page, valid)
        for k in range(int(torch.where(valid, rank, -1).max()) + 1):
            sel = torch.nonzero(valid & (rank == k)).squeeze(1)
            i = idx[sel]
            new_words[i, 0] = new_words[i, 0] | bit_hi[sel]
            new_words[i, 1] = new_words[i, 1] | bit_lo[sel]
    return payload, old_hi, old_lo, granted, new_words


_SIGNATURES = {"gcl_fetch_launch": (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p])}


def _check(pages, words, req_page, bit_hi, bit_lo):
    if pages.dim() != 2 or not pages.is_contiguous():
        raise ValueError("pages must be a contiguous [P, E] tensor")
    if words.dtype != torch.int32 or words.shape != (pages.shape[0], 2) \
            or not words.is_contiguous():
        raise ValueError("words must be a contiguous [P, 2] int32 tensor")
    r = req_page.shape[0]
    for name, t in (("req_page", req_page), ("bit_hi", bit_hi),
                    ("bit_lo", bit_lo)):
        if t.dtype != torch.int32 or t.shape != (r,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [R] int32 "
                             f"tensor")
    for t in (words, req_page, bit_hi, bit_lo):
        if t.device != pages.device:
            raise ValueError("all inputs must be on one device")


def fetch(pages, words, req_page, bit_hi, bit_lo):
    """pages [P, E] (any dtype), words [P, 2] int32, req_page / bit_hi /
    bit_lo [R] int32.  Returns (payload [R, E], old_hi [R], old_lo [R],
    granted [R], new_words [P, 2])."""
    _check(pages, words, req_page, bit_hi, bit_lo)
    if pages.device.type == "cpu":
        return gcl_fetch_plain(pages, words, req_page, bit_hi, bit_lo)
    if pages.device.type != "cuda":
        raise ValueError(f"unsupported device {pages.device}")
    r, (p, e) = req_page.shape[0], pages.shape
    dev = pages.device
    payload = torch.empty((r, e), dtype=pages.dtype, device=dev)
    new_words = torch.empty_like(words)
    old_hi, old_lo, granted = (torch.empty(r, dtype=torch.int32,
                                           device=dev) for _ in range(3))
    row_bytes = e * pages.element_size()
    vec16 = int(row_bytes % 16 == 0 and pages.data_ptr() % 16 == 0
                and payload.data_ptr() % 16 == 0)
    lib = _build.load("gcl_fetch", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.gcl_fetch_launch(
            pages.data_ptr(), row_bytes, p, words.data_ptr(),
            new_words.data_ptr(), req_page.data_ptr(), bit_hi.data_ptr(),
            bit_lo.data_ptr(), payload.data_ptr(), old_hi.data_ptr(),
            old_lo.data_ptr(), granted.data_ptr(), r, vec16,
            _build.stream_of(pages))
    _build.check(rc, "gcl_fetch")
    fetch.launches += 1
    return payload, old_hi, old_lo, granted, new_words


fetch.launches = 0
