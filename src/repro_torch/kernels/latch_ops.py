"""Batched latch-word CAS/FAA (kernel K1) and its plain version.

Counterpart of ``repro/kernels/latch_ops/ops.py:apply_batch``.  On a
CUDA tensor :func:`apply_batch` launches the hand-written kernel
``csrc/latch_ops.cu`` (it replaces the TPU kernel
``repro/kernels/latch_ops/latch_ops.py:latch_apply``); on a CPU tensor
it runs :func:`latch_apply_plain`.  ``apply_batch.launches`` counts
kernel launches.

Semantics: requests apply in request order per word; each returns the
word as it was before it; CAS compares all 64 bits; FAA carries lo into
hi and wraps mod 2**64; ``line = -1`` is an empty slot (zeros, not ok).
A line at or past N is an empty slot too, in the kernel and in the plain
version alike.  Here the port differs from the JAX package, whose
reference clamps such a read to the last word and drops the write; no
caller passes one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

OP_CAS = 0
OP_FAA = 1
REQ_KEYS = ("line", "op", "arg_hi", "arg_lo", "cmp_hi", "cmp_lo")

_U32 = 0xFFFFFFFF


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    return (((x + 2**31) & _U32) - 2**31).to(torch.int32)


def chain_rank(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Position of each valid slot among the earlier valid slots with
    the same key (0 = first).  Slots of one rank name distinct keys, so
    a rank's scatters never collide."""
    r = key.shape[0]
    same = (key[:, None] == key[None, :]) & valid[:, None] & valid[None, :]
    earlier = torch.ones((r, r), dtype=torch.bool,
                         device=key.device).tril(-1)
    return (same & earlier).sum(dim=1)


def latch_apply_plain(words, line, op, arg_hi, arg_lo, cmp_hi, cmp_lo):
    """Plain PyTorch version: same-line requests are applied rank by
    rank (one rank = one request per line), the FAA carry is computed
    in int64 and masked to 32 bits."""
    new = words.clone()
    r = line.shape[0]
    dev = words.device
    old_hi = torch.zeros(r, dtype=torch.int32, device=dev)
    old_lo = torch.zeros(r, dtype=torch.int32, device=dev)
    ok = torch.zeros(r, dtype=torch.int32, device=dev)
    valid = (line >= 0) & (line < words.shape[0])
    if r == 0:
        return new, old_hi, old_lo, ok
    rank = chain_rank(line, valid)
    for k in range(int(torch.where(valid, rank, -1).max()) + 1):
        sel = torch.nonzero(valid & (rank == k)).squeeze(1)
        idx = line[sel].long()
        hi = new[idx, 0].long()
        lo = new[idx, 1].long()
        is_cas = op[sel] == OP_CAS
        hit = (hi == cmp_hi[sel].long()) & (lo == cmp_lo[sel].long())
        cas_hi = torch.where(hit, arg_hi[sel].long(), hi)
        cas_lo = torch.where(hit, arg_lo[sel].long(), lo)
        sum_lo = (lo & _U32) + (arg_lo[sel].long() & _U32)
        faa_hi = hi + arg_hi[sel].long() + (sum_lo >> 32)
        new[idx, 0] = _to_i32(torch.where(is_cas, cas_hi, faa_hi))
        new[idx, 1] = _to_i32(torch.where(is_cas, cas_lo, sum_lo))
        old_hi[sel] = hi.to(torch.int32)
        old_lo[sel] = lo.to(torch.int32)
        ok[sel] = torch.where(is_cas, hit, True).to(torch.int32)
    return new, old_hi, old_lo, ok


_SIGNATURES = {"latch_apply_launch": (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p])}


def _check(words, req):
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != 2 or not words.is_contiguous():
        raise ValueError("words must be a contiguous [N, 2] int32 tensor")
    r = req["line"].shape[0]
    for k in REQ_KEYS:
        t = req[k]
        if t.dtype != torch.int32 or t.shape != (r,) \
                or not t.is_contiguous() or t.device != words.device:
            raise ValueError(f"request {k!r} must be a contiguous [R] "
                             f"int32 tensor on {words.device}")


def apply_batch(words: torch.Tensor, requests: dict):
    """words [N, 2] int32; ``requests`` holds line/op/arg_hi/arg_lo/
    cmp_hi/cmp_lo int32 [R].  Returns (new_words, old_hi, old_lo, ok)."""
    _check(words, requests)
    args = [requests[k] for k in REQ_KEYS]
    if words.device.type == "cpu":
        return latch_apply_plain(words, *args)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    r = args[0].shape[0]
    new = torch.empty_like(words)
    old_hi, old_lo, ok = (torch.empty(r, dtype=torch.int32,
                                      device=words.device)
                          for _ in range(3))
    lib = _build.load("latch_ops", _SIGNATURES)
    with torch.cuda.device(words.device):
        rc = lib.latch_apply_launch(
            words.data_ptr(), new.data_ptr(), words.shape[0],
            *[a.data_ptr() for a in args], old_hi.data_ptr(),
            old_lo.data_ptr(), ok.data_ptr(), r, _build.stream_of(words))
    _build.check(rc, "latch_apply")
    apply_batch.launches += 1
    return new, old_hi, old_lo, ok


apply_batch.launches = 0
