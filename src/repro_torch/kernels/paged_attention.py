"""Paged one-token GQA decode attention (kernel K3) and its plain version.

Counterpart of ``repro/kernels/paged_attention/ops.py:decode_paged``.
On CUDA tensors :func:`decode_paged` launches
``csrc/paged_attention.cu`` (it replaces the TPU kernel
``repro/kernels/paged_attention/paged_attention.py:paged_attention``);
on CPU tensors it runs :func:`paged_attention_plain`.
``decode_paged.launches`` counts kernel launches.

q [B, Hq, hd]; k_pages, v_pages [P, page, Hkv, hd] — views are fine as
long as each page's [page, Hkv, hd] block is contiguous and k and v
share one page stride (the pool passes column slices of its int32
payload lanes viewed as bf16); page_tbl [B, max_pages] int32, only the
first ceil(lens[b] / page) entries of a row are read; lens [B] int32.
Scores, softmax and accumulation are fp32, the scale is 1/sqrt(hd) and
the output has q's dtype.  A row with ``lens == 0`` comes out zero (the
Pallas kernel's behaviour; the JAX ``ref.py`` averages instead).

On the card each (sequence, kv head) is one thread-block cluster of
:func:`cluster_size` blocks, each taking a slice of the window's valid
pages; the slices' softmax states merge inside the one launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
CLUSTER = 2                 # blocks per (sequence, kv head), see below


def cluster_size(max_pages: int) -> int:
    """Blocks per (sequence, kv head) for a window of ``max_pages``
    pages: ``CLUSTER``, or one a page where the window has fewer.  Two
    were the fastest of 1, 2, 4 and 8 at the serve's grid (16 slots x 8
    kv heads) for windows of 256, 512 and 1024 tokens
    (``scripts/bench_attention_kernels.py``); other grids are untuned."""
    return max(1, min(CLUSTER, max_pages))


def paged_attention_plain(q, k_pages, v_pages, page_tbl, lens):
    """Plain PyTorch version: gather each sequence's pages, mask tokens
    at or past ``lens``, softmax in fp32."""
    b, hq, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    max_pages = page_tbl.shape[1]
    g = hq // hkv
    tbl = page_tbl.long().clamp(min=0)
    k_seq = k_pages[tbl].reshape(b, max_pages * page, hkv, hd).float()
    v_seq = v_pages[tbl].reshape(b, max_pages * page, hkv, hd).float()
    qg = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_seq) / math.sqrt(hd)
    tok = torch.arange(max_pages * page, device=q.device)
    live = tok[None, :] < lens[:, None].long()
    s = torch.where(live[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_seq)
    o = torch.where((lens > 0)[:, None, None, None], o, 0.0)
    return o.reshape(b, hq, hd).to(q.dtype)


_SIGNATURES = {"paged_attention_launch": (
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p])}


def _check(q, k_pages, v_pages, page_tbl, lens):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q must be [B, Hq, hd] and k/v pages "
                         "[P, page, Hkv, hd] of one shape")
    b, hq, hd = q.shape
    _, page, hkv, hd_k = k_pages.shape
    if hd_k != hd or hq % hkv:
        raise ValueError(f"head geometry mismatch: q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    if page_tbl.dtype != torch.int32 or page_tbl.dim() != 2 \
            or page_tbl.shape[0] != b or lens.dtype != torch.int32 \
            or lens.shape != (b,):
        raise ValueError("page_tbl must be [B, max_pages] int32 and lens "
                         "[B] int32")
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError("q and k/v must be float32 or bfloat16 (k and v "
                         "alike)")
    for t in (k_pages, v_pages, page_tbl, lens):
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")


def decode_paged(q, k_pages, v_pages, page_tbl, lens):
    """Decode attention through the page table: returns [B, Hq, hd] in
    q's dtype."""
    _check(q, k_pages, v_pages, page_tbl, lens)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_tbl, lens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, hd = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported on the GPU "
                         f"(supported: {HEAD_DIMS})")
    if hq // hkv > 32:
        raise ValueError(f"{hq // hkv} query heads per kv head exceeds "
                         f"the kernel's 32")
    if b > 65535:
        raise ValueError(f"B = {b} exceeds the grid's 65535")
    inner = (hkv * hd, hd, 1)
    if k_pages.stride()[1:] != inner or v_pages.stride()[1:] != inner \
            or k_pages.stride(0) != v_pages.stride(0):
        raise ValueError("each k/v page must be a contiguous "
                         "[page, Hkv, hd] block, with one page stride "
                         "for k and v")
    if not (q.is_contiguous() and page_tbl.is_contiguous()
            and lens.is_contiguous()):
        raise ValueError("q, page_tbl and lens must be contiguous")
    if (k_pages.data_ptr() | v_pages.data_ptr()
            | k_pages.stride(0) * k_pages.element_size()) % 16:
        raise ValueError("k/v pages must start 16-byte aligned, with a "
                         "page stride of a multiple of 16 bytes (the "
                         "kernel reads 16-byte vectors)")
    max_pages = page_tbl.shape[1]
    cluster = cluster_size(max_pages)
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_pages.stride(0), page_tbl.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, hq, hkv, hd, page, max_pages, n_pool,
            1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
            int(k_pages.dtype == torch.bfloat16), cluster,
            _build.stream_of(q))
    _build.check(rc, "paged_attention")
    decode_paged.launches += 1
    return out


decode_paged.launches = 0
