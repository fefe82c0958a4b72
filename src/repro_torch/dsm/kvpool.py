"""SELCC-coherent KV-page pool on the rounds plane.

Counterpart of the rounds-plane half of ``repro/dsm/kvpool.py``.  Pages
are lines, replicas are nodes, and each page's k+v tensors are bitcast
into the line's int32 payload lanes (``mem_data`` / per-replica
``cache_data``; bf16 packs two elements per lane, k lanes first).
``pool.read`` drives real coherence read ops and returns bytes whose
freshness the protocol guarantees; ``pool.append`` is one coherent
read-modify-write (S grant -> token splice on the device -> S->X
upgrade write); ``pool.attend`` runs the paged decode attention kernel
straight over zero-copy views of the plane's ``mem_data`` image.

Not ported yet: the legacy non-rounds path of the reference
(``append_tokens``, ``read_through_cache``, ``pool_decode_attention``
over shadow ``k_pages``/``v_pages`` and per-replica page caches) and the
mesh-sharded pool.  A :class:`SELCCKVPool` serves once
:meth:`SELCCKVPool.open_rounds_plane` has been called.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import coherence as co
from ..core.addressing import GAddr
from ..core.rounds import DevicePlane, make_state
from ..kernels.paged_attention import decode_paged
from .address import LineAllocator


@dataclass(frozen=True)
class KVPoolConfig:
    n_pages: int = 1024
    page_size: int = 16              # tokens per GCL
    n_kv_heads: int = 8
    head_dim: int = 128
    n_layers: int = 1                # pools are usually per layer-stack
    n_replicas: int = 4
    cache_slots: int = 256           # local cache capacity per replica
    dtype: str = "bfloat16"


def pool_dtype(cfg: KVPoolConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def page_lanes(cfg: KVPoolConfig) -> int:
    """int32 payload lanes per line for one (k, v) page pair — the
    ``payload_width`` of the pool's rounds-plane coherence state."""
    elems = cfg.page_size * cfg.n_kv_heads * cfg.head_dim
    if pool_dtype(cfg) == torch.bfloat16:
        if elems % 2:
            raise ValueError(
                f"bf16 page of {elems} elements cannot pack into int32 "
                f"lanes (need an even element count)")
        return elems                 # k: elems//2 lanes + v: elems//2
    return 2 * elems                 # fp32: one lane per element


def encode_kv(k, v, cfg: KVPoolConfig) -> torch.Tensor:
    """Bitcast k/v page tensors [..., page_size, Hkv, hd] into the
    line's int32 payload lanes [..., W] (k lanes then v lanes) — the
    reference's lane image, bit for bit."""
    dt = pool_dtype(cfg)

    def enc(x):
        x = torch.as_tensor(x).to(dt).contiguous()
        return x.reshape(x.shape[:-3] + (-1,)).view(torch.int32)
    return torch.cat([enc(k), enc(v)], dim=-1)


def decode_kv(data: torch.Tensor, cfg: KVPoolConfig):
    """Inverse of :func:`encode_kv`: payload lanes [..., W] int32 ->
    (k, v) page tensors [..., page_size, Hkv, hd] in the pool dtype.
    Zero-copy: both are strided views of ``data``."""
    half = data.shape[-1] // 2
    page_shape = (cfg.page_size, cfg.n_kv_heads, cfg.head_dim)

    def dec(lanes):
        return lanes.view(pool_dtype(cfg)).unflatten(-1, page_shape)
    return dec(data[..., :half]), dec(data[..., half:])


@functools.lru_cache(maxsize=None)
def _append_splice(cfg: KVPoolConfig):
    """The append's token splice as a ``run_rmw`` lane transform: decode
    the freshly-read page bytes, land every token of the batch on its
    page (later rows winning: the engine serializes a coalesced write
    group to its LAST slot's payload, so every slot of a duplicate-page
    group must carry the group total), re-encode.  A ``line = -1`` row
    is padding and keeps its bytes."""
    def modify(data, line, offsets, k_new, v_new):
        k_pg, v_pg = decode_kv(data, cfg)          # [B, ps, Hkv, hd]
        b = line.shape[0]
        tok = torch.arange(b, device=line.device)
        match = (line[:, None] == line[None, :]) & (line >= 0)[:, None]
        oh = offsets[:, None] == torch.arange(cfg.page_size,
                                              device=line.device)[None, :]
        win = torch.where(match[:, :, None] & oh[:, None, :],
                          tok[:, None, None], -1).max(dim=0).values
        keep = (win >= 0)[..., None, None]           # [B, ps, 1, 1]
        sel = win.clamp(min=0)
        dt = pool_dtype(cfg)
        k_pg = torch.where(keep, k_new.to(dt)[sel], k_pg)
        v_pg = torch.where(keep, v_new.to(dt)[sel], v_pg)
        return encode_kv(k_pg, v_pg, cfg)
    return modify


def pool_decode_attention_rounds(rstate, q, page_tbl, lens, *,
                                 cfg: KVPoolConfig):
    """Decode attention over the rounds plane's memory image: the page
    bytes are zero-copy views of ``mem_data``.  Under write-through
    appends the image is always protocol-fresh."""
    k_pages, v_pages = decode_kv(rstate["mem_data"], cfg)
    return decode_paged(q, k_pages, v_pages, page_tbl, lens)


class SELCCKVPool:
    """The serving pool: page allocation on the host, the data and
    coherence plane on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for)."""

    def __init__(self, cfg: KVPoolConfig, *, device=None):
        co.check_node_capacity(cfg.n_replicas)   # replicas = directory lanes
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rounds_plane = None     # set by open_rounds_plane()
        self._alloc = LineAllocator(cfg.n_pages)

    @property
    def rounds_state(self):
        """The coherence plane's state dict (None until
        ``open_rounds_plane``); owned by ``self.rounds_plane``."""
        return (None if self.rounds_plane is None
                else self.rounds_plane.state)

    def open_rounds_plane(self, *, write_back: bool = False):
        """Serve this pool from the rounds engine's payload plane: a
        coherence state whose lines are the pool's pages, its payload
        lanes zero (the lane image of zero pages).  Returns the state."""
        if self.rounds_plane is not None:
            raise RuntimeError(
                "rounds plane already open; build a fresh SELCCKVPool "
                "to re-open with different settings")
        state = make_state(self.cfg.n_replicas, self.cfg.n_pages,
                           write_back=write_back,
                           payload_width=page_lanes(self.cfg),
                           device=self.device)
        self.rounds_plane = DevicePlane.open(state,
                                             n_nodes=self.cfg.n_replicas)
        return state

    def _plane(self) -> DevicePlane:
        if self.rounds_plane is None:
            raise RuntimeError(
                "call open_rounds_plane() first: the pool serves from the "
                "rounds plane (the legacy page-copy path is not ported)")
        return self.rounds_plane

    def _plane_ops(self, node, line, isw, wdata):
        """Drive one op batch through the pool's coherence plane and
        return (versions, read payloads) as host arrays."""
        res = self._plane().ops(node, line, isw, wdata)
        return res.version, res.data

    def _plane_held(self, replica: int, pages) -> np.ndarray:
        """Hit mask: the replica already holds the page in S or M."""
        cs = self._plane().state["cache_state"]
        pos = torch.as_tensor(np.maximum(pages, 0), device=cs.device)
        held = (cs[replica, pos.long()] != 0).cpu().numpy()
        return np.logical_and(pages >= 0, held)

    @property
    def free_pages(self) -> int:
        """Pages currently allocatable (never-used + freed)."""
        return self._alloc.free_lines

    @property
    def pages_in_use(self) -> int:
        return self.cfg.n_pages - self._alloc.free_lines

    def allocate(self, n: int) -> np.ndarray:
        """Allocate ``n`` pages (freed pages first); raises on
        exhaustion instead of wrapping onto live pages."""
        return self._alloc.alloc(int(n))

    def free(self, pages) -> None:
        """Return pages to the free list.  Raises ``ValueError`` on a
        double-free or a never-allocated page.  Freeing scrubs nothing:
        the protocol, not the allocator, keeps recycled pages
        coherent."""
        self._alloc.free(pages)

    def gaddr_of(self, page: int, n_homes: int = 1) -> GAddr:
        """Structured address of a flat page index."""
        page = int(page)
        if not 0 <= page < self.cfg.n_pages:
            raise ValueError(
                f"page {page} outside this pool's 0..{self.cfg.n_pages - 1}")
        return GAddr.from_flat(page, n_homes)

    def page_of(self, gaddr, n_homes: int = 1) -> int:
        """Flat page index of a :class:`GAddr`; raises ``ValueError``
        for an address from a foreign pool geometry."""
        g = GAddr(*gaddr)
        if not 0 <= g.node_id < n_homes:
            raise ValueError(
                f"{g!r} is not from this pool's geometry: home "
                f"{g.node_id} outside 0..{n_homes - 1}")
        page = g.flat(n_homes)
        if not 0 <= page < self.cfg.n_pages:
            raise ValueError(
                f"{g!r} maps to page {page}, outside this pool's "
                f"0..{self.cfg.n_pages - 1}")
        return page

    def append(self, pages, offsets, k_new, v_new, replica=0) -> int:
        """Append one token per row (``pages = -1`` rows are padding) as
        ONE coherent read-modify-write.  ``replica`` is a scalar or a
        per-row vector; rows of different replicas must target
        different pages.  Returns the coherence rounds spent."""
        pages = np.asarray(pages, np.int32)
        node = np.broadcast_to(np.asarray(replica, np.int32),
                               pages.shape).astype(np.int32)
        res = self._plane().rmw(
            node, pages, modify=_append_splice(self.cfg),
            operands=(np.asarray(offsets, np.int32), k_new, v_new))
        return res.rounds

    def read(self, replica: int, pages):
        """Coherent read of whole pages by ``replica``: returns (k, v)
        [n, page, Hkv, hd] host tensors in the pool dtype and the hit
        mask (pages the replica already held)."""
        pages = np.asarray(pages, np.int32)
        hit = self._plane_held(replica, pages)
        node = np.full(pages.shape, replica, np.int32)
        _, data = self._plane_ops(node, pages, np.zeros_like(pages), None)
        k, v = decode_kv(torch.from_numpy(data), self.cfg)
        return k, v, hit

    def attend(self, q, page_tbl, lens) -> torch.Tensor:
        """Decode attention for q [B, Hq, hd] through page_tbl
        [B, max_pages] and lens [B]; the result stays on the device."""
        plane = self._plane()
        dev = plane.device
        return pool_decode_attention_rounds(
            plane.state, torch.as_tensor(q).to(dev),
            torch.as_tensor(page_tbl).to(device=dev, dtype=torch.int32),
            torch.as_tensor(lens).to(device=dev, dtype=torch.int32),
            cfg=self.cfg)
