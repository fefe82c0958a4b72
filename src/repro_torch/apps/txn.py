"""Transaction engines over SELCC (paper Sec. 8.2): 2PL (no-wait), TO,
OCC — plus the 2PC-partitioned variant of Sec. 9.3 — and the counters
they share with the device batch engine.

A copy of ``repro/apps/txn.py``, over the port's host DES
(``repro_torch.core.SELCCLayer``).  Tuples are heap-organized into GCLs
(``tuples_per_gcl`` per line); every tuple access goes through a SELCC
latch scope on its GCL.  For 2PL the SELCC latches double as the
transaction locks (the paper's trick that saves RDMA round trips).  TO
reads update the read-timestamp in the header — the behaviour that
makes TO slow on read-only workloads in Fig. 11 (every read invalidates
peer caches).  OCC latches twice per tuple (read phase + validate
phase).  Durability: WAL flush latency per commit; partitioned mode
pays prepare+commit flushes per participant (Fig. 12's bottleneck).

Each GCL's payload is a dict record in the layer's :class:`GclHeap` —
``{"writes": int, tuple_id: (rts, wts), ...}`` — reached only through
``Handle.value``/``Handle.store`` under the latch.  The shared GCL
directory and the timestamp word are published as layer bindings
(``"txn:gcls"``, ``"txn:ts"``).  With ``run(..., ts=)`` and one memory
node, :class:`TxnEngine` replays a device batch in the device's serial
order and is the oracle of ``apps.txn_device.DeviceTxnEngine``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..obs import StreamingHistogram

GCLS_BINDING = "txn:gcls"
TS_BINDING = "txn:ts"


@dataclass
class TxnConfig:
    algo: str = "2pl"                # 2pl | to | occ
    tuples_per_gcl: int = 8
    wal: bool = False                # write-ahead log flush on commit
    partitioned: bool = False        # 2PC across partitions
    nowait_local: bool = True        # abort on local latch conflict (2PL)


@dataclass
class TxnStats:
    """Per-engine counters, shared by the host DES engine and the device
    batch engine (``apps/txn_device.py``) so host and device benches
    compare like for like: commits, aborts by REASON ("nowait" — 2PL
    lock conflict, "ts" — TO timestamp check, "occ" — version
    validation), and the latency distribution (DES time units on the
    host, wall seconds on the device: compare counts across the two,
    never latencies) as an ``obs.StreamingHistogram`` — bounded memory
    at any txn count, tail percentiles within the sketch's
    relative-error bound."""

    commits: int = 0
    aborts: int = 0
    latency_sum: float = 0.0
    abort_reasons: dict = field(default_factory=dict)
    latency: StreamingHistogram = field(
        default_factory=StreamingHistogram)

    def record(self, ok: bool, latency: float,
               reason: str | None = None) -> None:
        if ok:
            self.commits += 1
        else:
            self.aborts += 1
            if reason is not None:
                self.abort_reasons[reason] = \
                    self.abort_reasons.get(reason, 0) + 1
        self.latency_sum += latency
        self.latency.observe(latency)

    @property
    def p50(self) -> float:
        return self.latency.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.latency.quantile(0.99)


class TxnEngine:
    """One engine per compute node."""

    def __init__(self, layer, node, cfg: TxnConfig, n_tuples: int,
                 ts_counter=None):
        self.layer = layer
        self.node = node
        self.cfg = cfg
        self.stats = TxnStats()
        self._abort_reason = None
        gcls = layer.binding(GCLS_BINDING)
        if gcls is None:
            n_gcls = (n_tuples + cfg.tuples_per_gcl - 1) \
                // cfg.tuples_per_gcl
            gcls = layer.allocate_many(n_gcls)
            for g in gcls:
                layer.seed_object(g, {"writes": 0})
            layer.bind(GCLS_BINDING, gcls)
            layer.bind(TS_BINDING, layer.allocate())
        self.gcls = gcls
        self.ts_addr = layer.binding(TS_BINDING)
        # partition id per tuple (2PC participant detection); defaults to
        # the GCL's memory node — workloads install their own (warehouse)
        self.partition_fn = lambda t: self._gcl_of(t).node_id

    def _gcl_of(self, tuple_id: int):
        return self.gcls[tuple_id // self.cfg.tuples_per_gcl]

    # ------------------------------------------------------------ execute
    def run(self, read_set, write_set, thread: int = 0, ts=None):
        """Execute one transaction; returns True on commit.

        ``ts`` (TO only) overrides the FAA-drawn timestamp — the
        deterministic-replay / external-clock hook: a client that
        assigned its timestamp at txn begin (or an HLC source) replays
        here with the SAME ordering decisions, which is what lets the
        device differential tests drive this engine as an oracle."""
        t0 = self.node.env.now
        algo = self.cfg.algo
        self._abort_reason = None
        if algo == "2pl":
            ok = yield from self._run_2pl(read_set, write_set)
        elif algo == "to":
            ok = yield from self._run_to(read_set, write_set, ts)
        elif algo == "occ":
            ok = yield from self._run_occ(read_set, write_set)
        else:
            raise ValueError(algo)
        if ok:
            yield from self._commit_io(read_set, write_set)
        self.stats.record(ok, self.node.env.now - t0,
                          self._abort_reason)
        return ok

    def _commit_io(self, read_set, write_set):
        cost = self.node.fabric.cost
        if not self.cfg.wal or not write_set:
            return
        if self.cfg.partitioned:
            parts = {self.partition_fn(t) for t in write_set}
            if len(parts) > 1:
                # 2PC: prepare flush per participant + commit flush each
                for _ in range(2 * len(parts)):
                    yield self.node.env.timeout(cost.wal_flush)
                return
        yield self.node.env.timeout(cost.wal_flush)

    def _gcl_sets(self, read_set, write_set):
        """Tuple sets -> GCL sets (several tuples share a line; a line is
        latched at most once per txn — X dominates S)."""
        wg = {self._gcl_of(t) for t in write_set}
        rg = {self._gcl_of(t) for t in read_set} - wg
        return sorted(rg), sorted(wg)

    @staticmethod
    def _record_write(rec: dict) -> dict:
        """Tuple mutation stand-in: bump the GCL record's write count."""
        rec["writes"] = rec.get("writes", 0) + 1
        return rec

    # ---------------------------------------------------------------- 2PL
    def _run_2pl(self, read_set, write_set):
        """S2PL no-wait: SELCC latches ARE the locks, held to commit."""
        held = []
        rg, wg = self._gcl_sets(read_set, write_set)
        try:
            for g, is_x in sorted([(g, False) for g in rg]
                                  + [(g, True) for g in wg]):
                if self.cfg.nowait_local and self._local_conflict(g, is_x):
                    self._abort_reason = "nowait"
                    return False
                if is_x:
                    h = yield from self.node.xlocked(g)
                    held.append(h)
                    yield from h.store(self._record_write(h.value))
                else:
                    held.append((yield from self.node.slocked(g)))
            return True
        finally:
            # the scope guard: held latches release on commit AND on the
            # no-wait abort's early return — no leaked latch either way
            yield from self.node.release_all(held)

    def _local_conflict(self, gaddr, want_x: bool) -> bool:
        cache = getattr(self.node, "cache", None)
        if cache is None:
            return False
        e = cache.entries.get(gaddr)
        if e is None:
            return False
        if want_x:
            return e.latch.held
        return e.latch.writer is not None

    # ----------------------------------------------------------------- TO
    def _run_to(self, read_set, write_set, ts=None):
        if ts is None:
            ts = yield from self.node.atomic_faa(self.ts_addr, 1)
        # reads update rts in the header -> exclusive access needed: the
        # cache-invalidation storm the paper calls out for read queries
        by_gcl = {}
        wset = set(write_set)
        # sorted tuple order per GCL: the check/update sequence (and so
        # WHICH tuple a txn aborts at, hence which partial updates leak)
        # is part of the algorithm's observable state — set iteration
        # order must not decide it
        for t in sorted(set(read_set) | wset):
            by_gcl.setdefault(self._gcl_of(t), []).append(t)
        for g in sorted(by_gcl):
            h = yield from self.node.xlocked(g)
            try:
                rec = h.value
                for t in by_gcl[g]:
                    rts, wts = rec.get(t, (0, 0))
                    if t in wset:
                        if ts < rts or ts < wts:
                            self._abort_reason = "ts"
                            return False
                        rec[t] = (rts, ts)
                    else:
                        if ts < wts:
                            self._abort_reason = "ts"
                            return False
                        rec[t] = (max(rts, ts), wts)
                yield from h.store(rec)    # rts/wts update dirties the GCL
            finally:
                yield from h.release()
        return True

    # ---------------------------------------------------------------- OCC
    def _run_occ(self, read_set, write_set):
        # read phase: S latch per GCL, record versions (latch #1)
        rg, wg = self._gcl_sets(read_set, write_set)
        snapshots = {}
        for g in sorted(set(rg) | set(wg)):
            h = yield from self.node.slocked(g)
            snapshots[g] = h.version
            yield from h.release()
        # validate + write phase: X latch per GCL again (latch #2 — the
        # double-latching that makes OCC lose to 2PL in Fig. 11)
        held = []
        ok = True
        wgs = set(wg)
        try:
            for g in sorted(snapshots):
                h = yield from self.node.xlocked(g)
                held.append((h, g))
                if h.version != snapshots[g]:
                    ok = False
                    self._abort_reason = "occ"
                    break
            if ok:
                for h, g in held:
                    if g in wgs:
                        yield from h.store(self._record_write(h.value))
            return ok
        finally:
            yield from self.node.release_all([h for h, _ in held])
