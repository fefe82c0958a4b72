"""SELCC-coherent disaggregated KV-page pool for multi-replica serving.

Counterpart of ``repro/dsm/kvpool.py``.  A :class:`SELCCKVPool` serves
one of two planes:

* **The legacy page-copy path** (until ``open_rounds_plane()``): the
  pool is a dict of tensors (:func:`make_pool`: shadow ``k_pages`` /
  ``v_pages``, one 2-lane latch word a page that carries the directory,
  page versions and fills) and every replica keeps a direct-mapped
  cache of page copies tagged (page, version) (:func:`make_replica_cache`).
  :func:`append_tokens` takes each written page exclusively by an S->X
  upgrade CAS (kernel K1), counts the readers a failed upgrade evicts,
  writes in place, bumps the version and downgrades the writer back to
  a sole S registration; :func:`read_through_cache` serves hits from the
  replica's cache and misses by the combined latch verdict, reader-bit
  merge and page gather (kernel K2, once for k and once for v, with the
  replica's own directory lanes); :func:`pool_decode_attention` runs the
  paged decode attention kernel (K3) over the shadow pages.  These
  update the pool's and the cache's leaves in place (64 + 64 MiB at the
  defaults) and return them.
* **The rounds plane**: pages are lines, replicas are nodes, and each
  page's k+v tensors are bitcast into the line's int32 payload lanes
  (``mem_data`` / per-replica ``cache_data``; bf16 packs two elements
  per lane, k lanes first).  ``pool.read`` drives real coherence read
  ops and returns bytes whose freshness the protocol guarantees;
  ``pool.append`` is one coherent read-modify-write (S grant -> token
  splice on the device -> S->X upgrade write); ``pool.attend`` runs K3
  straight over zero-copy views of the plane's ``mem_data`` image.

A pool built with a :class:`~repro_torch.core.rounds.mesh.Mesh` serves
the SHARDED rounds plane (``home = page % n_shards``): every read and
append crosses it through the sharded drivers, and the attend maps each
page-table entry to its page's row in the striped ``mem_data``.  On the
mesh's one device the legacy pool's page-indexed leaves are the flat
arrays, with the same logical page indices.

Where the reference scatters with duplicate indices (JAX leaves the
result implementation-defined; its CPU backend applies the rows in
order, so the last row wins), the port makes last-row-wins explicit:
two rows of one read that map to one cache slot, and two append rows
that name one (page, offset).  Version bumps count every row.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import coherence as co
from ..core.addressing import GAddr
from ..core.rounds import (DevicePlane, make_sharded_state, make_state,
                           shard_state)
from ..kernels.gcl_fetch import fetch as gcl_fetch_op
from ..kernels.latch_ops import OP_CAS, apply_batch
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


def _mesh_device(cfg: KVPoolConfig, mesh, device) -> torch.device:
    """The pool's device: the mesh's when there is one (which must hold
    a whole number of pages a shard, and agree with ``device`` if that
    is given), else ``device``."""
    if mesh is None:
        return resolve_device(device)
    from ..core.rounds.mesh import shards_of
    n_shards = shards_of(mesh)
    if cfg.n_pages % n_shards:
        raise ValueError(f"n_pages={cfg.n_pages} not divisible by the "
                         f"mesh's {n_shards} shards")
    if device is not None and resolve_device(device).type \
            != mesh.device.type:
        raise ValueError(f"device={device} but the mesh lives on "
                         f"{mesh.device}")
    return mesh.device


def make_pool(cfg: KVPoolConfig, mesh=None, *, device=None) -> dict:
    """The legacy pool's leaves on ``device`` (``cuda`` unless ``"cpu"``
    is asked for; the mesh's device when a ``mesh`` is given): shadow
    ``k_pages``/``v_pages`` [P, page, Hkv, hd] in the pool dtype, the
    latch words [P, 2] int32 (the directory), the page versions and
    fills [P], and the ``append_evictions`` counter (readers evicted by
    appends' PeerWr broadcasts).  On one device the reference's
    block-sharded page leaves are these flat arrays: the logical page
    indices are the same."""
    dev = _mesh_device(cfg, mesh, device)
    dt = pool_dtype(cfg)
    shape = (cfg.n_pages, cfg.page_size, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return {"k_pages": zeros(shape, dt), "v_pages": zeros(shape, dt),
            "words": zeros((cfg.n_pages, 2)),
            "page_version": zeros((cfg.n_pages,)),
            "page_fill": zeros((cfg.n_pages,)),
            "alloc_top": zeros(()), "append_evictions": zeros(())}


def make_replica_cache(cfg: KVPoolConfig, *, device=None) -> dict:
    """Each replica's direct-mapped page cache on ``device``: local page
    copies ``k_local``/``v_local`` [N, slots, page, Hkv, hd] in the pool
    dtype, their tags ``tag_page`` (-1 = empty) and ``tag_version``
    [N, slots], and a per-replica ``clock``."""
    dev = resolve_device(device)
    dt = pool_dtype(cfg)
    shape = (cfg.n_replicas, cfg.cache_slots, cfg.page_size,
             cfg.n_kv_heads, cfg.head_dim)
    tags = (cfg.n_replicas, cfg.cache_slots)
    return {"k_local": torch.zeros(shape, dtype=dt, device=dev),
            "v_local": torch.zeros(shape, dtype=dt, device=dev),
            "tag_page": torch.full(tags, -1, dtype=torch.int32,
                                   device=dev),
            "tag_version": torch.zeros(tags, dtype=torch.int32,
                                       device=dev),
            "clock": torch.zeros((cfg.n_replicas,), dtype=torch.int32,
                                 device=dev)}


def _slot_of(page, cache_slots: int):
    return page % cache_slots        # direct-mapped (paper uses hashed LRU)


def _last_rows(key: torch.Tensor) -> torch.Tensor:
    """Row indices of the last row of each distinct ``key`` — the rows
    whose scatter survives under last-row-wins."""
    uniq, inv = torch.unique(key, return_inverse=True)
    last = torch.full(uniq.shape, -1, dtype=torch.int64, device=key.device)
    return last.scatter_reduce(0, inv, torch.arange(
        key.shape[0], device=key.device), "amax")


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 lane (torch has no popcount): the SWAR
    bit count over the lane's 32 bits, in int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _rows_on(x, dev, dtype=torch.int32) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype).contiguous()


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


# ------------------------------------------------------ legacy: appends

def append_tokens(pool, replica, pages, offsets, k_new, v_new, *,
                  cfg: KVPoolConfig) -> dict:
    """Decode write path: the replica owning the tail pages writes one
    token per row.  pages/offsets [B] (page -1 = skip); k_new/v_new
    [B, Hkv, hd].  Exclusive access follows the protocol's write path:

    1. S->X UPGRADE — CAS(my reader bit -> my writer field) through K1,
       in row order per word: it succeeds iff this replica is the sole
       registered holder;
    2. a failed CAS's returned old word IS the directory: its other
       reader bits are the PeerWr broadcast targets, counted into
       ``append_evictions`` (every failed row counts its word's
       readers, duplicates included, as in the reference);
    3. the in-place write (last row wins per (page, offset)), the
       version bump (one per row) and the fill, then the DOWNGRADE
       M -> S: the boundary writes the writer's sole reader bit.

    Updates ``pool``'s leaves in place and returns it."""
    dev = pool["words"].device
    dt = pool_dtype(cfg)
    pages = _rows_on(pages, dev)
    offsets = _rows_on(offsets, dev)
    valid = pages >= 0
    rep = torch.tensor(int(replica), device=dev)
    bit_hi, bit_lo = co.bit_lanes(rep)
    wf = co.writer_field_hi(rep)
    line = torch.where(valid, pages, -1).to(torch.int32)
    zeros = torch.zeros_like(line)
    words, old_hi, old_lo, ok_up = apply_batch(pool["words"], {
        "line": line, "op": torch.full_like(line, OP_CAS),
        "arg_hi": zeros + wf, "arg_lo": zeros,
        "cmp_hi": zeros + bit_hi, "cmp_lo": zeros + bit_lo})
    forced = valid & (ok_up == 0)
    others_lo = old_lo & ~bit_lo
    others_hi = (old_hi & ~bit_hi) & ((1 << co.WRITER_SHIFT_HI) - 1)
    evicted = torch.where(forced, _popcount32(others_lo)
                          + _popcount32(others_hi), 0).sum()
    idx = pages[valid].long()
    off = offsets[valid].long()
    last = _last_rows(idx * cfg.page_size + off)
    k_rows = _rows_on(k_new, dev, dt)[valid]
    v_rows = _rows_on(v_new, dev, dt)[valid]
    pool["k_pages"][idx[last], off[last]] = k_rows[last]
    pool["v_pages"][idx[last], off[last]] = v_rows[last]
    pool["page_version"].index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))
    pool["page_fill"].scatter_reduce_(0, idx, (off + 1).to(torch.int32),
                                      "amax")
    words[idx] = torch.stack([bit_hi, bit_lo]).expand(idx.shape[0], 2)
    pool["words"] = words
    pool["append_evictions"] += evicted.to(torch.int32)
    return pool


# -------------------------------------------------------- legacy: reads

def read_through_cache(pool, cache, replica, pages, *, cfg: KVPoolConfig):
    """Replica ``replica`` needs ``pages`` [R] (-1 = none).  Hits (tag
    page and version current) come from the replica's cache; misses do
    the combined latch + fetch (K2, once for k and once for v) with the
    replica's own directory lanes and install the page and its tag.
    Where rows share a cache slot, the last row decides: it installs if
    it missed, else the slot keeps what it held.  Returns (k, v
    [R, page, Hkv, hd] on the pool's device, cache, pool, hit [R] bool)
    with ``cache`` and ``pool`` updated in place."""
    dev = pool["words"].device
    pages = _rows_on(pages, dev)
    pg = pages.clamp(min=0).long()
    slots = _slot_of(pg, cfg.cache_slots)
    tag_p = cache["tag_page"][replica, slots]
    tag_v = cache["tag_version"][replica, slots]
    cur_v = pool["page_version"][pg]
    valid = pages >= 0
    hit = valid & (tag_p == pages) & (tag_v == cur_v)
    miss = valid & ~hit

    # combined latch + payload fetch for the misses (one round trip)
    req_page = torch.where(miss, pages, -1).to(torch.int32)
    rep_hi, rep_lo = co.bit_lanes(torch.tensor(int(replica), device=dev))
    bit_hi = torch.where(miss, rep_hi, 0).to(torch.int32)
    bit_lo = torch.where(miss, rep_lo, 0).to(torch.int32)
    flat_k = pool["k_pages"].reshape(cfg.n_pages, -1)
    flat_v = pool["v_pages"].reshape(cfg.n_pages, -1)
    k_fetch, _, _, _, words = gcl_fetch_op(flat_k, pool["words"],
                                           req_page, bit_hi, bit_lo)
    v_fetch = gcl_fetch_op(flat_v, pool["words"], req_page, bit_hi,
                           bit_lo)[0]
    page_shape = (-1, cfg.page_size, cfg.n_kv_heads, cfg.head_dim)
    k_fetch = k_fetch.reshape(page_shape)
    v_fetch = v_fetch.reshape(page_shape)

    k_loc, v_loc = cache["k_local"][replica], cache["v_local"][replica]
    sel = hit[:, None, None, None]
    k_out = torch.where(sel, k_loc[slots], k_fetch)
    v_out = torch.where(sel, v_loc[slots], v_fetch)
    # install: of the rows sharing a slot, the last one decides
    last = _last_rows(slots)
    inst = last[miss[last]]
    at = slots[inst]
    k_loc[at] = k_fetch[inst]
    v_loc[at] = v_fetch[inst]
    cache["tag_page"][replica, at] = pages[inst]
    cache["tag_version"][replica, at] = cur_v[inst]
    pool["words"] = words
    return k_out, v_out, cache, pool, hit


# ----------------------------------------------------- attention over pool

def pool_decode_attention(pool, q, page_tbl, lens, *, cfg: KVPoolConfig):
    """Decode attention straight over the legacy pool's shadow pages
    (K3): q [B, Hq, hd], page_tbl [B, max_pages], lens [B]."""
    return decode_paged(q, pool["k_pages"], pool["v_pages"], page_tbl,
                        lens)


def pool_decode_attention_rounds(rstate, q, page_tbl, lens, *,
                                 cfg: KVPoolConfig, n_shards: int = 1,
                                 mesh=None):
    """Decode attention over the rounds plane's memory image: the page
    bytes are zero-copy views of ``mem_data``.  Under write-through
    appends the image is always protocol-fresh.  On a sharded plane
    (stripe layout) each table entry ``p`` names row ``(p % S) * (P //
    S) + p // S``: the reference unstripes the image instead, to the
    same pages in the same order.  Over ranks (a ``mesh`` with a process
    group) every rank gathers the table's pages from the ranks that hold
    them (``read_rows``) and attends over those, in the table's
    order."""
    md = rstate["mem_data"]
    if mesh is not None and mesh.ranked:
        from ..core.rounds import read_rows
        used = torch.unique(page_tbl[page_tbl >= 0].long())
        md = read_rows(rstate, mesh, "mem_data",
                       (used % n_shards) * (cfg.n_pages // n_shards)
                       + used // n_shards)
        page_tbl = torch.where(
            page_tbl >= 0,
            torch.searchsorted(used, page_tbl.long()).to(page_tbl.dtype),
            page_tbl)
    elif n_shards > 1:
        rows = md.shape[0] // n_shards
        page_tbl = torch.where(page_tbl >= 0, (page_tbl % n_shards) * rows
                               + page_tbl // n_shards, page_tbl)
    k_pages, v_pages = decode_kv(md, cfg)
    return decode_paged(q, k_pages, v_pages, page_tbl, lens)


class SELCCKVPool:
    """The serving pool: page allocation on the host, the data and
    coherence plane on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for).  It serves the legacy page-copy path (``self.pool`` /
    ``self.cache``) until :meth:`open_rounds_plane`, and the rounds
    plane after it."""

    def __init__(self, cfg: KVPoolConfig, mesh=None, *, device=None):
        co.check_node_capacity(cfg.n_replicas)   # replicas = directory lanes
        self.cfg = cfg
        self.mesh = mesh
        self.device = _mesh_device(cfg, mesh, device)
        self.pool = make_pool(cfg, device=self.device)
        self.cache = make_replica_cache(cfg, device=self.device)
        self.rounds_plane = None     # set by open_rounds_plane()
        self._alloc = LineAllocator(cfg.n_pages)

    @property
    def rounds_state(self):
        """The coherence plane's state dict (None until
        ``open_rounds_plane``); owned by ``self.rounds_plane``."""
        return (None if self.rounds_plane is None
                else self.rounds_plane.state)

    @rounds_state.setter
    def rounds_state(self, value):
        if value is None:
            self.rounds_plane = None
        else:
            self.rounds_plane.state = value

    def as_rounds_state(self, *, write_back: bool = False, mesh=None):
        """A fresh rounds-plane coherence state for THIS pool's pages
        (pages are the lines, replicas the nodes).  With a mesh (the
        pool's own by default) it is the sharded plane's state on the
        mesh's device (``home = page % n_shards``), else the flat one on
        the pool's device."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is not None:
            return make_sharded_state(self.cfg.n_replicas, self.cfg.n_pages,
                                      mesh, write_back=write_back)
        return make_state(self.cfg.n_replicas, self.cfg.n_pages,
                          write_back=write_back, device=self.device)

    def open_rounds_plane(self, *, write_back: bool = False,
                          recorder=None):
        """Serve this pool from the rounds engine's payload plane: a
        coherence state whose lines are the pool's pages and whose
        ``mem_data`` lanes hold the page bytes, seeded from the current
        shadow ``k_pages``/``v_pages`` by bitcast (so legacy appends
        carry over).  On a mesh-backed pool the plane is the sharded
        one.  ``recorder`` optionally attaches an ``obs.FlightRecorder``
        to the plane.  Returns the state."""
        if self.rounds_plane is not None:
            # re-seeding from the shadow pages would silently discard
            # every append made through the plane
            raise RuntimeError(
                "rounds plane already open; build a fresh SELCCKVPool "
                "to re-open with different settings")
        state = make_state(self.cfg.n_replicas, self.cfg.n_pages,
                           write_back=write_back,
                           payload_width=page_lanes(self.cfg),
                           device=self.device)
        state["mem_data"].copy_(encode_kv(self.pool["k_pages"],
                                          self.pool["v_pages"], self.cfg))
        if self.mesh is not None:
            state = shard_state(state, self.mesh)
        self.rounds_plane = DevicePlane.open(
            state, self.mesh, n_nodes=self.cfg.n_replicas,
            recorder=recorder)
        return state

    def _plane_ops(self, node, line, isw, wdata):
        """Drive one op batch through the pool's coherence plane and
        return (versions, read payloads) as host arrays."""
        res = self.rounds_plane.ops(node, line, isw, wdata)
        return res.version, res.data

    def _plane_held(self, replica: int, pages) -> np.ndarray:
        """Hit mask: the replica already holds the page in S or M."""
        pos = np.maximum(pages, 0)
        s = self.rounds_plane.n_shards
        if s > 1:                                 # stripe layout
            pos = (pos % s) * (self.cfg.n_pages // s) + pos // s
        pos = torch.as_tensor(pos, device=self.device).long()
        if self.mesh is not None and self.mesh.ranked:
            from ..core.rounds import read_rows
            cs = read_rows(self.rounds_state, self.mesh, "cache_state", pos)
            held = cs[replica]
        else:
            held = self.rounds_state["cache_state"][replica, pos]
        return np.logical_and(pages >= 0, (held != 0).cpu().numpy())

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
        """Append one token per row (``pages = -1`` rows are padding).
        On the legacy path ``replica`` is a scalar and the call is one
        :func:`append_tokens` (returns 0).  On the rounds plane it is
        ONE coherent read-modify-write, ``replica`` a scalar or a per-row
        vector (rows of different replicas must target different pages),
        and it returns the coherence rounds spent."""
        if self.rounds_plane is None:
            if (replica.dim() if torch.is_tensor(replica)
                    else np.ndim(replica)) != 0:
                raise TypeError("per-row replica vectors need the "
                                "rounds plane (open_rounds_plane())")
            self.pool = append_tokens(self.pool, int(replica), pages,
                                      offsets, k_new, v_new, cfg=self.cfg)
            return 0
        pages = np.asarray(pages, np.int32)
        node = np.broadcast_to(np.asarray(replica, np.int32),
                               pages.shape).astype(np.int32)
        res = self.rounds_plane.rmw(
            node, pages, modify=_append_splice(self.cfg),
            operands=(np.asarray(offsets, np.int32), k_new, v_new))
        return res.rounds

    def read(self, replica: int, pages):
        """Coherent read of whole pages by ``replica``: returns (k, v)
        [n, page, Hkv, hd] in the pool dtype and the hit mask (numpy).
        Legacy path: :func:`read_through_cache`, k and v on the pool's
        device, a hit is a current cached copy.  Rounds plane: k and v
        on the host, a hit is a page the replica already held."""
        if self.rounds_plane is None:
            k, v, self.cache, self.pool, hit = read_through_cache(
                self.pool, self.cache, int(replica), pages, cfg=self.cfg)
            return k, v, hit.cpu().numpy()
        pages = np.asarray(pages, np.int32)
        hit = self._plane_held(replica, pages)
        node = np.full(pages.shape, replica, np.int32)
        _, data = self._plane_ops(node, pages, np.zeros_like(pages), None)
        k, v = decode_kv(torch.from_numpy(data), self.cfg)
        return k, v, hit

    def attend(self, q, page_tbl, lens) -> torch.Tensor:
        """Decode attention for q [B, Hq, hd] through page_tbl
        [B, max_pages] and lens [B], over the shadow pages (legacy) or
        the plane's memory image; the result stays on the device."""
        dev = self.device
        q = torch.as_tensor(q).to(dev)
        page_tbl = _rows_on(page_tbl, dev)
        lens = _rows_on(lens, dev)
        if self.rounds_plane is None:
            return pool_decode_attention(self.pool, q, page_tbl, lens,
                                         cfg=self.cfg)
        return pool_decode_attention_rounds(
            self.rounds_state, q, page_tbl, lens, cfg=self.cfg,
            n_shards=self.rounds_plane.n_shards, mesh=self.mesh)
