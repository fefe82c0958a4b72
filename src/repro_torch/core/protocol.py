"""The SELCC protocol — Shared-Exclusive Latch based Cache Coherence.

Faithful implementation of the paper's Secs. 4-6:

* lazy latch release + invalidation messages (PeerRd/PeerWr/PeerUpgr)
  align the SEL state machine with MSI (Fig. 2);
* the cache directory lives INSIDE the 64-bit RDMA latch word
  (8-bit exclusive holder id + 56-bit reader bitmap, Fig. 3);
* latch + payload move in ONE combined one-sided RDMA op (CAS+read /
  FAA+read);
* two-level concurrency control: local S/X mutex per cache entry first,
  global RDMA latch second (Sec. 5.2); invalidation handlers use try_lock
  and never block (Sec. 5.1);
* fairness: lease counters force a global release under continuous local
  access (Sec. 5.3.1); priority aging + deterministic latch handover +
  anti-write-starvation spin window (Sec. 5.3.2);
* exclusive release by FAA-subtract (never CAS — livelock, Sec. 4.3c);
* latch upgrade retries N times then falls back to release+reacquire
  (deadlock avoidance, Algorithm 2).

Every public entry point is a DES generator: drive with
``env.process(node.op_read(gaddr))`` etc.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from . import coherence as co
from . import coherence as lw   # host-form word helpers
from .cache import CacheEntry, NodeCache, INVALID, MODIFIED, SHARED
from .handles import Handle, NodeAPIMixin
from .registry import register_protocol
from .simulator import Environment, Fabric, Store

PEER_RD = "PeerRd"
PEER_WR = "PeerWr"
PEER_UPGR = "PeerUpgr"

# DES cache states <-> the shared spec's numeric MSI encoding, so the
# invalidation handlers can look transitions up in coherence.MSI_ON_PEER
# (the same table the device-plane round engine applies at boundaries).
_STATE_CODE = {INVALID: co.I, SHARED: co.S, MODIFIED: co.M}


class CoherenceError(AssertionError):
    """A cache-coherence invariant was violated (test hook)."""


@dataclass
class SELCCConfig:
    gcl_bytes: int = 2048            # paper: 24M GCLs over 48 GB => 2 KB lines
    cache_capacity: int = 4096      # entries per node (paper: 8 GB of 2 KB lines)
    handler_threads: int = 8         # background invalidation RPC handlers
                                     # (DES handlers BLOCK on the release
                                     # RTT; 8 approximates the pipelined
                                     # async verbs a real handler posts)
    retry_base: float = 8e-6         # base global-latch retry interval
    retry_floor: float = 2.5e-6      # congestion floor for aged retries
    retry_jitter: float = 0.3        # +- fraction of interval
    lease_theta: float = 4.0         # synthetic-access threshold (Sec. 5.3.1)
    upgrade_tries: int = 2           # N in Algorithm 2 (N >= 2)
    enable_handover: bool = True     # deterministic latch handover (Sec. 5.3.2)
    handover_ttl_rtts: float = 2.0   # freshness bound for handover targets
    enable_lease: bool = True
    enable_spin_window: bool = True
    spin_window_pr: int = 4          # starvation threshold for the window
    check_coherence: bool = True     # assert S copies == memory version
    record_history: bool = False


@dataclass
class NodeStats:
    reads: int = 0
    writes: int = 0
    inv_sent: int = 0
    latency_sum: float = 0.0
    retries: int = 0

    @property
    def ops(self) -> int:
        return self.reads + self.writes


class _InvMessage:
    __slots__ = ("type", "gaddr", "sender", "priority", "sent_at")

    def __init__(self, type: str, gaddr, sender: int, priority: int,
                 sent_at: float):
        self.type = type
        self.gaddr = gaddr
        self.sender = sender
        self.priority = priority
        self.sent_at = sent_at


class SELCCNode(NodeAPIMixin):
    """One compute node: sharded LRU cache + protocol engine + handlers."""

    def __init__(self, env: Environment, node_id: int, fabric: Fabric,
                 cfg: SELCCConfig | None = None, n_threads: int = 16,
                 seed: int = 0):
        self.env = env
        self.node_id = node_id
        self.fabric = fabric
        self.cfg = cfg or SELCCConfig()
        self.n_threads = max(1, n_threads)
        self.cache = NodeCache(env, self.cfg.cache_capacity)
        self.stats = NodeStats()
        self.rng = random.Random((seed << 8) ^ node_id)
        self.inbox = Store(env)
        fabric.register_inbox(node_id, self.inbox)
        self._retry_carry: dict = {}     # gaddr -> aged priority carry
        self.history: list = []          # (thread, op, gaddr, version, t) if enabled
        for _ in range(self.cfg.handler_threads):
            env.process(self._handler_loop())

    # ------------------------------------------------------------------ API
    def slock(self, gaddr):
        """Algorithm 1.  Returns a Handle with the local shared latch held
        and a coherent copy (global S or M latch held lazily)."""
        env, cache = self.env, self.cache
        while True:
            e = cache.lookup(gaddr)
            if e is None:
                e = cache.insert(gaddr)
                e.pins += 1                      # pin BEFORE yielding: evictors
                yield from self._maybe_evict()   # must never orphan this entry
            else:
                e.pins += 1
            waited = yield e.latch.acquire_s(owner=self)
            if e.evicted:          # woke up on an orphan — retry from lookup
                e.latch.release_s()
                e.pins -= 1
                continue
            self._lease_tick(e, waited, write=False)
            if e.state in (MODIFIED, SHARED):           # cache hit
                cache.stats.hits += 1
                yield env.timeout(self.fabric.cost.local_access)
                self._assert_coherent(e)
                return Handle(self, gaddr, "S", entry=e)
            cache.stats.misses += 1
            if e.fetching:
                # another local thread is already acquiring the global latch
                # for this node (one reader bit per NODE: single-flight).
                ev = env.event()
                e.fetch_waiters.append(ev)
                e.latch.release_s()
                e.pins -= 1
                yield ev
                continue
            e.fetching = True
            try:
                yield from self._global_s_acquire(e)
            finally:
                e.fetching = False
                waiters, e.fetch_waiters = e.fetch_waiters, []
                for w in waiters:
                    w.succeed()
            return Handle(self, gaddr, "S", entry=e)

    def xlock(self, gaddr):
        """Algorithm 2."""
        env, cache, cfg = self.env, self.cache, self.cfg
        while True:
            e = cache.lookup(gaddr)
            if e is None:
                e = cache.insert(gaddr)
                e.pins += 1
                yield from self._maybe_evict()
            else:
                e.pins += 1
            waited = yield e.latch.acquire_x(owner=self)
            if e.evicted:          # woke up on an orphan — retry from lookup
                e.latch.release_x()
                e.pins -= 1
                continue
            break
        self._lease_tick(e, waited, write=True)
        if e.state == MODIFIED:                          # cache hit
            cache.stats.hits += 1
            yield env.timeout(self.fabric.cost.local_access)
            return Handle(self, gaddr, "X", entry=e)
        cache.stats.misses += 1
        if e.state == SHARED:
            ok = yield from self._global_upgrade(e)
            if not ok:
                # fallback (Algorithm 2 line 14): release S, acquire X fresh
                yield from self._release_global_s(e)
                yield from self._global_x_acquire(e)
        else:
            yield from self._global_x_acquire(e)
        return Handle(self, gaddr, "X", entry=e)

    def write(self, handle: Handle):
        """Mutate the line under the X handle (bumps the version — versions
        stand in for payload bytes; the checker uses them)."""
        if handle.mode != "X":
            raise CoherenceError("write without exclusive handle")
        handle.mark_written()
        yield self.env.timeout(self.fabric.cost.local_access)

    def sunlock(self, handle: Handle):
        self._untrack(handle)
        e = handle.entry
        e.pins -= 1
        e.latch.release_s()
        if self._lease_due(e) and e.latch.try_x(owner="lease"):
            # Sec. 5.3.1: proactively hand the global latch back
            if e.state != INVALID:
                self.cache.stats.lease_releases += 1
                yield from self._release_global_any(e, handover=True)
            e.reset_fairness()
            e.latch.release_x()
        return None
        yield  # pragma: no cover — make this a generator

    def xunlock(self, handle: Handle):
        self._untrack(handle)
        e = handle.entry
        e.pins -= 1
        if self._lease_due(e):
            if e.state != INVALID:
                self.cache.stats.lease_releases += 1
                yield from self._release_global_any(e, handover=True)
            e.reset_fairness()
        e.latch.release_x()
        return None

    def atomic_faa(self, gaddr, delta: int):
        """Table-1 ``Atomic``: raw RDMA_FAA on a global word (timestamps)."""
        mid, line = gaddr
        old = yield from self.fabric.faa(mid, ("atomic", line), delta)
        return old

    # ------------------------------------------------------- composite ops
    def op_read(self, gaddr, thread: int = 0):
        t0 = self.env.now
        h = yield from self.slock(gaddr)
        ver = h.version
        yield from self.sunlock(h)
        self.stats.reads += 1
        self.stats.latency_sum += self.env.now - t0
        if self.cfg.record_history:
            self.history.append((thread, "R", gaddr, ver, self.env.now))
        return ver

    def op_write(self, gaddr, thread: int = 0):
        t0 = self.env.now
        h = yield from self.xlock(gaddr)
        yield from self.write(h)
        ver = h.version
        yield from self.xunlock(h)
        self.stats.writes += 1
        self.stats.latency_sum += self.env.now - t0
        if self.cfg.record_history:
            self.history.append((thread, "W", gaddr, ver, self.env.now))
        return ver

    # ----------------------------------------------------- global latching
    def _global_s_acquire(self, e: CacheEntry):
        env, fabric, cfg = self.env, self.fabric, self.cfg
        mid, line = e.gaddr
        bit = lw.reader_bit(self.node_id)
        retries = 0
        while True:
            if cfg.enable_spin_window and env.now < e.spin_until:
                yield env.timeout(e.spin_until - env.now)
            old, data_ver = yield from fabric.faa_read(mid, line, bit,
                                                       cfg.gcl_bytes)
            w = lw.writer_of(old)
            if w is None:
                self._became_valid(e, SHARED, data_ver)
                self._retry_reset(e.gaddr)
                return True
            # exclusive holder present: reset our bit, invalidate, back off
            yield from fabric.faa(mid, line, -bit)
            retries += 1
            self.stats.retries += 1
            pr = self._priority(e.gaddr, retries)
            # resend SUPPRESSION (Sec. 5.1): latch retries accelerate with
            # priority, but invalidation RESENDS back off exponentially —
            # a linear resend rate melts the holder's handler inbox under
            # fan-in (measured: 100 spinners starved a single holder)
            if retries & (retries - 1) == 0:
                self._send_inv(w, PEER_RD, e.gaddr, pr)
            yield env.timeout(self._retry_interval(pr))

    def _global_x_acquire(self, e: CacheEntry):
        env, fabric, cfg = self.env, self.fabric, self.cfg
        mid, line = e.gaddr
        want = lw.writer_field(self.node_id)
        retries = 0
        while True:
            old, data_ver = yield from fabric.cas_read(mid, line, lw.FREE,
                                                       want, cfg.gcl_bytes)
            if old == lw.FREE:
                self._became_valid(e, MODIFIED, data_ver)
                self._retry_reset(e.gaddr)
                return True
            if lw.writer_of(old) == self.node_id:
                # Deterministic handover landed the latch on us (Sec. 5.3.2):
                # the previous holder CAS'ed (A,0) -> (us,0) after write-back.
                # Reader bits alongside our writer field are PROVABLY
                # transient (genuine shared holders cannot coexist with a
                # writer field: both CAS paths demand a clean word), so
                # requiring an exactly-clean word here would livelock under
                # reader-bit churn — claim on the writer field alone.
                self._became_valid(e, MODIFIED, data_ver)
                self._retry_reset(e.gaddr)
                return True
            retries += 1
            self.stats.retries += 1
            pr = self._priority(e.gaddr, retries)
            if retries & (retries - 1) == 0:     # exponential resend backoff
                for h in lw.holders_of(old):
                    if h != self.node_id:
                        self._send_inv(h, PEER_WR, e.gaddr, pr)
            yield env.timeout(self._retry_interval(pr))

    def _global_upgrade(self, e: CacheEntry):
        """Atomic S->X upgrade, up to N tries (Algorithm 2 lines 8-13)."""
        env, fabric, cfg = self.env, self.fabric, self.cfg
        mid, line = e.gaddr
        have = lw.reader_bit(self.node_id)
        want = lw.writer_field(self.node_id)
        for attempt in range(cfg.upgrade_tries):
            old, data_ver = yield from fabric.cas_read(mid, line, have, want,
                                                       cfg.gcl_bytes)
            if old == have:
                # upgraded in place — local copy stays valid (same version)
                e.state = MODIFIED
                e.processed_ids.clear()
                return True
            retries = attempt + 1
            self.stats.retries += 1
            pr = self._priority(e.gaddr, retries)
            for h in lw.holders_of(old):
                if h != self.node_id:
                    self._send_inv(h, PEER_UPGR, e.gaddr, pr)
            yield env.timeout(self._retry_interval(pr))
        return False

    # ----------------------------------------------------- global release
    def _release_global_s(self, e: CacheEntry):
        mid, line = e.gaddr
        yield from self.fabric.faa(mid, line, -lw.reader_bit(self.node_id))
        e.state = INVALID
        e.dirty = False

    def _release_global_x(self, e: CacheEntry, handover: bool = False):
        fabric, cfg = self.fabric, self.cfg
        mid, line = e.gaddr
        mine = lw.writer_field(self.node_id)
        if e.dirty:
            self.cache.stats.writebacks += 1
            yield from fabric.write(mid, line, cfg.gcl_bytes, e.version)
            e.dirty = False
        target = None
        if handover and cfg.enable_handover and e.stored_inv:
            # Hand over ONLY to a requester that is provably still spinning:
            # a grant landing on a node with no in-flight X acquisition
            # parks the latch forever.  A full acquire->release->re-acquire
            # cycle takes >= 3 atomic RTTs, so a message younger than
            # handover_ttl (2 RTTs) cannot come from a finished round.
            ttl = cfg.handover_ttl_rtts * self.fabric.cost.atomic_rtt
            best_pr = 0
            for node, (pr, mtype, sent_at) in e.stored_inv.items():
                if (mtype == PEER_WR and node != self.node_id
                        and (self.env.now - sent_at) <= ttl
                        and pr > best_pr):
                    best_pr, target = pr, node
        if target is not None:
            old = yield from fabric.cas(mid, line, mine,
                                        lw.writer_field(target))
            if old == mine:
                self.cache.stats.handovers += 1
            else:  # readers raced their bits in — fall back to plain release
                yield from fabric.faa(mid, line, -mine)
        else:
            yield from fabric.faa(mid, line, -mine)
        e.state = INVALID

    def _release_global_any(self, e: CacheEntry, handover: bool = False):
        if e.state == MODIFIED:
            yield from self._release_global_x(e, handover=handover)
        elif e.state == SHARED:
            yield from self._release_global_s(e)

    def _downgrade(self, e: CacheEntry):
        """M -> S on PeerRd (Fig. 2b): write back, CAS (me,0)->(0,my bit)."""
        fabric, cfg = self.fabric, self.cfg
        mid, line = e.gaddr
        mine = lw.writer_field(self.node_id)
        if e.dirty:
            self.cache.stats.writebacks += 1
            yield from fabric.write(mid, line, cfg.gcl_bytes, e.version)
            e.dirty = False
        old = yield from fabric.cas(mid, line, mine,
                                    lw.reader_bit(self.node_id))
        if old == mine:
            e.state = SHARED
        else:
            # concurrent reader bits present — plain release instead
            yield from fabric.faa(mid, line, -mine)
            e.state = INVALID

    # -------------------------------------------------- invalidation plane
    def _send_inv(self, target: int, mtype: str, gaddr, priority: int):
        self.stats.inv_sent += 1
        self.fabric.send(target, _InvMessage(mtype, gaddr, self.node_id,
                                             priority, self.env.now))

    def _handler_loop(self):
        env = self.env
        while True:
            msg = yield self.inbox.get()
            yield env.timeout(self.fabric.cost.handler_service)
            yield from self._handle(msg)

    def _handle(self, msg: _InvMessage):
        st = self.cache.stats
        st.inv_received += 1
        e = self.cache.entries.get(msg.gaddr)       # no LRU bump
        if e is None or e.state == INVALID:
            st.inv_dropped_stale += 1
            return
        dedup_key = (msg.sender, msg.type)
        if dedup_key in e.processed_ids:
            st.inv_dedup += 1
            return
        if not e.latch.try_x(owner="inv"):
            # local accessors win (Sec. 5.2) — activate lease counters and
            # remember the highest-priority starving peer (Sec. 5.3)
            if self.cfg.enable_lease:
                e.counters_active = True
            e.note_inv(msg.priority, msg.sender, msg.type, msg.sent_at)
            st.inv_dropped_busy += 1
            return
        try:
            if e.state == INVALID:       # raced with another handler
                st.inv_dropped_stale += 1
                return
            e.processed_ids.add(dedup_key)
            e.note_inv(msg.priority, msg.sender, msg.type, msg.sent_at)
            # the shared MSI table decides WHERE to go; the fabric verbs
            # below are HOW the DES gets there
            cur = _STATE_CODE[e.state]
            nxt = co.on_peer(cur, co.PEER_EVENTS[msg.type])
            if cur == co.M and nxt == co.S:
                yield from self._downgrade(e)
            elif cur == co.M and nxt == co.I:
                yield from self._release_global_x(e, handover=True)
                e.reset_fairness()
            elif cur == co.S and nxt == co.I:
                yield from self._release_global_s(e)
                if self.cfg.enable_spin_window \
                        and msg.priority >= self.cfg.spin_window_pr:
                    # anti-write-starvation window: T_spin = P_inv * T_r,
                    # applied only once the writer actually reports
                    # starvation (paper: "when latch starvation is
                    # detected") — unconditional windows over-penalize
                    # ordinary write sharing; capped, as unbounded
                    # P_inv freezes readers under sustained contention
                    e.spin_until = self.env.now + (
                        min(msg.priority, 16)
                        * self.fabric.cost.atomic_rtt)
                e.reset_fairness()
            # nxt == cur (PeerRd to a reader): holders don't conflict — drop
        finally:
            e.latch.release_x()

    # -------------------------------------------------------- housekeeping
    def _maybe_evict(self):
        cache = self.cache
        while cache.over_capacity():
            victims = cache.eviction_candidates()
            if not victims:
                cache.stats.overflow += 1   # everything pinned; grow briefly
                return
            v = victims[0]
            if not v.latch.try_x(owner="evict"):
                cache.stats.overflow += 1
                return
            # The entry must stay in the dict (and locally X-latched) until
            # the global release has LANDED: a concurrent local re-acquire
            # of the same line would otherwise CAS against our own stale
            # writer field and misread it as a handover-to-self.
            v.evicted = True       # set under the latch, BEFORE any yield
            try:
                if v.state != INVALID:
                    yield from self._release_global_any(v)
            finally:
                cache.remove(v.gaddr)
                v.latch.release_x()
            cache.stats.evictions += 1

    def _became_valid(self, e: CacheEntry, state: str, version: int) -> None:
        e.state = state
        e.version = version
        e.dirty = False
        e.processed_ids.clear()
        e.stored_inv = None
        self._assert_coherent(e)

    def _assert_coherent(self, e: CacheEntry) -> None:
        """THE coherence invariant: a valid shared copy always equals the
        memory image (eager invalidation guarantees it — Sec. 7)."""
        if not self.cfg.check_coherence or e.state != SHARED:
            return
        mid, line = e.gaddr
        mem_ver = self.fabric.mem[mid].mem_version.get(line, 0)
        if e.version != mem_ver:
            raise CoherenceError(
                f"node {self.node_id} gaddr {e.gaddr}: cached v{e.version} "
                f"!= memory v{mem_ver}")

    # ------------------------------------------------------------ fairness
    def _lease_tick(self, e: CacheEntry, waited: bool, write: bool) -> None:
        # Counters activate when an invalidation is dropped because local
        # accessors hold the latch (Sec. 5.3.1).  While active, every local
        # access charges the lease: H = Rc/P + Wc.  NOTE: the paper counts
        # only accesses that *wait* — but shared local latches never make
        # concurrent readers wait, which would let a read-hot line starve
        # remote writers forever (observed in simulation); counting all
        # accesses while active preserves the intent and bounds starvation.
        if not (self.cfg.enable_lease and e.counters_active):
            return
        if write:
            e.wc += 1
        else:
            e.rc += 1

    def _lease_due(self, e: CacheEntry) -> bool:
        if not (self.cfg.enable_lease and e.counters_active):
            return False
        h_times = e.rc / self.n_threads + e.wc
        return h_times > self.cfg.lease_theta

    def _priority(self, gaddr, retries: int) -> int:
        return retries + self._retry_carry.get(gaddr, 0)

    def _retry_reset(self, gaddr) -> None:
        self._retry_carry.pop(gaddr, None)

    def _retry_interval(self, priority: int) -> float:
        # interval shrinks as priority (retry count) grows — priority aging
        # (Sec. 5.3.2) — but FLOORED: an unbounded shrink turns contended
        # lines into a resend storm (handler inboxes back up, latency
        # feeds retries, retries feed messages — measured collapse in the
        # fully-shared write-intensive micro-benchmark).  The paper's
        # congestion guidance (Sec. 5.1) and its fairness rule pull in
        # opposite directions; the floor keeps both bounded.
        base = max(self.cfg.retry_base / (1.0 + min(priority, 32)),
                   self.cfg.retry_floor)
        j = self.cfg.retry_jitter
        return base * (1.0 + self.rng.uniform(-j, j))


# --------------------------------------------------------------- registry
def _build_selcc(layer):
    c = layer.cfg
    return [SELCCNode(layer.env, i, layer.fabric, c.selcc,
                      c.threads_per_node, seed=c.seed)
            for i in range(c.n_compute)]


register_protocol(
    "selcc", _build_selcc,
    description="SEL-based cache coherence (the paper's protocol)")
