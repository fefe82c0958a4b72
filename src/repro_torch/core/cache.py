"""Compute-side cache: a sharded hash table with LRU replacement.

One instance per compute node (paper Sec. 5: "lightweight LRU caches on
the compute nodes").  Entries carry the MSI-aligned latch/cache state,
the local shared-exclusive mutex (two-level concurrency control,
Sec. 5.2), the fairness counters (Sec. 5.3.1) and the stored invalidation
message used for deterministic latch handover (Sec. 5.3.2).

The DES is single-threaded, so "sharding" here only spreads the LRU
bookkeeping (and is reported in stats) — the local mutexes provide the
actual conflict semantics.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from .simulator import Environment, SXLatch

# MSI-aligned states (paper Fig. 2): latch state IS the cache state.
MODIFIED = "M"    # holds global exclusive latch, copy may be dirty
SHARED = "S"      # holds global shared latch (reader bit set)
INVALID = "I"     # no global latch; local copy stale


class CacheEntry:
    __slots__ = (
        "gaddr", "state", "version", "dirty", "latch", "pins",
        "rc", "wc", "counters_active", "stored_inv", "processed_ids",
        "fetching", "fetch_waiters", "spin_until", "evicted",
    )

    def __init__(self, env: Environment, gaddr):
        self.gaddr = gaddr
        # set under the evictor's local X latch just before dict removal;
        # accessors that wake up on an evicted (orphaned) entry must re-loop
        # through the cache lookup instead of using it (prevents a leaked
        # reader bit at the memory node).
        self.evicted = False
        self.state = INVALID
        self.version = 0
        self.dirty = False
        self.latch = SXLatch(env)      # local S/X mutex (level 1 CC)
        self.pins = 0                  # outstanding handles — pin against eviction
        # fairness: lease counters (Sec. 5.3.1)
        self.rc = 0
        self.wc = 0
        self.counters_active = False
        # highest-priority pending invalidation (Sec. 5.3.2 handover)
        self.stored_inv = None         # (priority, requester_node, msg_type)
        self.processed_ids: set = set()
        # single-flight global fetch (one reader bit / CAS per *node*)
        self.fetching = False
        self.fetch_waiters: list = []
        # anti-write-starvation spin window (Sec. 5.3.2): no re-acquire before
        self.spin_until = 0.0

    def note_inv(self, priority: int, node: int, msg_type: str,
                 sent_at: float) -> None:
        """Remember the latest request per peer (bounded: <=56 peers).
        The release path picks the highest-priority FRESH writer."""
        if self.stored_inv is None:
            self.stored_inv = {}
        prev = self.stored_inv.get(node)
        if prev is None or sent_at >= prev[2]:
            self.stored_inv[node] = (priority, msg_type, sent_at)

    def reset_fairness(self) -> None:
        self.rc = 0
        self.wc = 0
        self.counters_active = False
        self.stored_inv = None


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    writebacks: int = 0
    lease_releases: int = 0
    handovers: int = 0
    inv_received: int = 0
    inv_dropped_busy: int = 0
    inv_dropped_stale: int = 0
    inv_dedup: int = 0
    overflow: int = 0

    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


class NodeCache:
    """LRU cache keyed by global address.  ``capacity`` in entries."""

    def __init__(self, env: Environment, capacity: int, shards: int = 16):
        self.env = env
        self.capacity = capacity
        self.shards = shards
        self.entries: OrderedDict = OrderedDict()
        self.stats = CacheStats()

    def lookup(self, gaddr) -> CacheEntry | None:
        e = self.entries.get(gaddr)
        if e is not None:
            self.entries.move_to_end(gaddr)
        return e

    def insert(self, gaddr) -> CacheEntry:
        e = CacheEntry(self.env, gaddr)
        self.entries[gaddr] = e
        self.entries.move_to_end(gaddr)
        return e

    def remove(self, gaddr) -> None:
        self.entries.pop(gaddr, None)

    def over_capacity(self) -> bool:
        return len(self.entries) > self.capacity

    def eviction_candidates(self, scan: int = 8):
        """Up to ``scan`` unpinned, un-latched entries in LRU order."""
        out = []
        for gaddr, e in self.entries.items():
            if e.pins == 0 and not e.latch.held and not e.fetching:
                out.append(e)
                if len(out) >= scan:
                    break
        return out

    def __len__(self):
        return len(self.entries)
