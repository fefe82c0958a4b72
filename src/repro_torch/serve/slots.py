"""Decode-slot grid: the engine's unit of residency.

A :class:`Slot` is one lane of the fixed batch the engine drives
through the device each tick — it owns the request bound to it, the
slot-PRIVATE pages allocated from the pool at admission, and the page
table the fused paged-attention call indexes.  Slot privacy is a
correctness invariant, not just an allocation policy: one tick's fused
``run_rmw`` append batches rows from slots owned by DIFFERENT replicas,
and the engine's per-call atomicity contract requires that two nodes
never target the same line in one call — private tail pages (plus
read-only shared prefix pages) guarantee it structurally.

:class:`SlotManager` does admission control: a request is admitted only
when a slot is free AND the pool can cover its WHOLE budget
(``pages_needed`` — prompt + max_new, minus the shared prefix) up
front.  Reserving at admission means an admitted request can never
deadlock mid-flight on pool exhaustion; a request that cannot reserve
stays QUEUED (backpressure), and one that can never fit the slot's
``max_pages`` window is rejected outright.  Eviction returns the
private pages to the pool's free list (``SELCCKVPool.free``) —
recycled pages stay coherent through the protocol, not the allocator.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .request import RequestState, ServeRequest


class Phase:
    IDLE = "idle"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclass
class Slot:
    sid: int
    replica: int
    req: ServeRequest | None = None
    phase: str = Phase.IDLE
    pages: np.ndarray | None = None      # private pages (pool lines)
    page_tbl: np.ndarray | None = None   # [max_pages], -1 padded
    pos: int = 0        # KV positions written so far == next position
    cursor: int = 0     # prompt tokens consumed by prefill (-> P-1)
    pending: int = -1   # next token to consume in decode
    last_attn: np.ndarray | None = None  # [Hq, hd] from the last tick
    stats_ticks: int = 0
    _history: list = field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.phase != Phase.IDLE


class SlotManager:
    """Fixed grid of ``n_slots`` decode slots over one pool.  Slot
    ``sid`` is owned by replica ``sid % n_replicas`` — the engine's
    static request-to-replica placement."""

    def __init__(self, pool, n_slots: int, max_pages: int):
        self.pool = pool
        self.n_slots = int(n_slots)
        self.max_pages = int(max_pages)
        n_rep = pool.cfg.n_replicas
        self.slots = [Slot(sid=s, replica=s % n_rep)
                      for s in range(self.n_slots)]

    # ------------------------------------------------------- geometry
    def pages_total(self, req: ServeRequest) -> int:
        return -(-req.kv_len // self.pool.cfg.page_size)

    def pages_needed(self, req: ServeRequest) -> int:
        """Slot-private pages to reserve at admission (whole budget)."""
        return self.pages_total(req) - len(req.shared_pages)

    def check_fits(self, req: ServeRequest) -> None:
        """Reject requests no slot can EVER serve (oversize), and
        shared prefixes that don't align to page boundaries (a partial
        shared tail page would be appended into by multiple slots,
        breaking slot privacy)."""
        ps = self.pool.cfg.page_size
        if req.shared_len != len(req.shared_pages) * ps:
            raise ValueError(
                f"shared_len={req.shared_len} must cover exactly the "
                f"{len(req.shared_pages)} shared page(s) of {ps} tokens")
        if self.pages_total(req) > self.max_pages:
            req.state = RequestState.REJECTED
            raise ValueError(
                f"request needs {self.pages_total(req)} pages, over the "
                f"slot capacity of {self.max_pages} "
                f"(kv_len={req.kv_len}, page_size={ps})")

    # ------------------------------------------------------ lifecycle
    def free_slot(self) -> Slot | None:
        for s in self.slots:
            if not s.active:
                return s
        return None

    def can_reserve(self, req: ServeRequest) -> bool:
        return self.pages_needed(req) <= self.pool.free_pages

    def admit(self, req: ServeRequest, slot: Slot, tick: int) -> Slot:
        """Bind ``req`` to ``slot``, reserving its private pages."""
        assert not slot.active
        pages = self.pool.allocate(self.pages_needed(req))
        tbl = np.full((self.max_pages,), -1, np.int32)
        tbl[:len(req.shared_pages)] = req.shared_pages
        tbl[len(req.shared_pages):len(req.shared_pages) + len(pages)] = \
            pages
        slot.req = req
        slot.pages = pages
        slot.page_tbl = tbl
        slot.pos = req.shared_len
        slot.cursor = 0
        slot.stats_ticks = 0
        slot.last_attn = None
        if len(req.prompt) == 1:          # nothing to prefill: the one
            slot.phase = Phase.DECODE     # prompt token is consumed by
            slot.pending = req.prompt[0]  # the first decode step
            req.state = RequestState.DECODE
        else:
            slot.phase = Phase.PREFILL
            slot.pending = -1
            req.state = RequestState.PREFILL
        req.admit_tick = tick
        return slot

    def release(self, slot: Slot, tick: int, done: bool = True) -> None:
        """Evict: private pages back to the pool free list, slot idle."""
        if slot.pages is not None and len(slot.pages):
            self.pool.free(slot.pages)
        if done and slot.req is not None:
            slot.req.state = RequestState.DONE
            slot.req.done_tick = tick
        slot.req = None
        slot.phase = Phase.IDLE
        slot.pages = None
        slot.page_tbl = None
        slot.pos = 0
        slot.cursor = 0
        slot.pending = -1
        slot.last_attn = None

    # ------------------------------------------------------ selectors
    def active(self) -> list[Slot]:
        return [s for s in self.slots if s.active]

    def prefilling(self) -> list[Slot]:
        return [s for s in self.slots if s.phase == Phase.PREFILL]

    def decoding(self) -> list[Slot]:
        return [s for s in self.slots if s.phase == Phase.DECODE]
