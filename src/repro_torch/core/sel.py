"""SEL baseline: the one-sided shared-exclusive latch of Ziegler et al.
[54] with EAGER latch release and NO compute-side cache.

This is the paper's first baseline ("SEL ... circumvents the cache
coherence problem by disabling caching", Sec. 9.1).  Every access pays:

    latch acquire (combined atomic+read, 1 RTT)  ->  local access
    -> [write-back if dirty]  ->  latch release (1 atomic RTT)

Under contention it spins on RDMA atomics against the NIC atomic unit —
the collapse the paper shows in Fig. 9 (write-heavy, zipf 0.99).
"""

from __future__ import annotations

import random

from . import coherence as lw   # host-form word helpers
from .handles import Handle, NodeAPIMixin
from .protocol import NodeStats, SELCCConfig
from .registry import register_protocol
from .simulator import Environment, Fabric


class SELNode(NodeAPIMixin):
    """Same Table-1 v2 surface as SELCCNode — apps run unchanged
    (the paper stresses SEL shares SELCC's API)."""

    def __init__(self, env: Environment, node_id: int, fabric: Fabric,
                 cfg: SELCCConfig | None = None, n_threads: int = 16,
                 seed: int = 0):
        self.env = env
        self.node_id = node_id
        self.fabric = fabric
        self.cfg = cfg or SELCCConfig()
        self.stats = NodeStats()
        self.rng = random.Random((seed << 8) ^ (node_id + 977))
        self.history: list = []

    # -- latch procedures (eager) -------------------------------------------
    def _acquire_s(self, gaddr):
        mid, line = gaddr
        bit = lw.reader_bit(self.node_id)
        retries = 0
        while True:
            old, ver = yield from self.fabric.faa_read(mid, line, bit,
                                                       self.cfg.gcl_bytes)
            if lw.writer_of(old) is None:
                return ver
            yield from self.fabric.faa(mid, line, -bit)
            retries += 1
            self.stats.retries += 1
            yield self.env.timeout(self._backoff(retries))

    def _acquire_x(self, gaddr):
        mid, line = gaddr
        want = lw.writer_field(self.node_id)
        retries = 0
        while True:
            old, ver = yield from self.fabric.cas_read(mid, line, lw.FREE,
                                                       want, self.cfg.gcl_bytes)
            if old == lw.FREE:
                return ver
            retries += 1
            self.stats.retries += 1
            yield self.env.timeout(self._backoff(retries))

    def _backoff(self, retries: int) -> float:
        base = self.cfg.retry_base / (1.0 + retries)
        return base * (1.0 + self.rng.uniform(-self.cfg.retry_jitter,
                                              self.cfg.retry_jitter))

    # -- ops ------------------------------------------------------------------
    def op_read(self, gaddr, thread: int = 0):
        t0 = self.env.now
        mid, line = gaddr
        ver = yield from self._acquire_s(gaddr)
        yield self.env.timeout(self.fabric.cost.local_access)
        yield from self.fabric.faa(mid, line, -lw.reader_bit(self.node_id))
        self.stats.reads += 1
        self.stats.latency_sum += self.env.now - t0
        if self.cfg.record_history:
            self.history.append((thread, "R", gaddr, ver, self.env.now))
        return ver

    def op_write(self, gaddr, thread: int = 0):
        t0 = self.env.now
        mid, line = gaddr
        ver = yield from self._acquire_x(gaddr)
        yield self.env.timeout(self.fabric.cost.local_access)
        new_ver = ver + 1
        yield from self.fabric.write(mid, line, self.cfg.gcl_bytes, new_ver)
        yield from self.fabric.faa(mid, line,
                                   -lw.writer_field(self.node_id))
        self.stats.writes += 1
        self.stats.latency_sum += self.env.now - t0
        if self.cfg.record_history:
            self.history.append((thread, "W", gaddr, new_ver, self.env.now))
        return new_ver

    # SEL has the same locking surface for the apps layer -------------------
    def slock(self, gaddr):
        ver = yield from self._acquire_s(gaddr)
        return Handle(self, gaddr, "S", version=ver)

    def xlock(self, gaddr):
        ver = yield from self._acquire_x(gaddr)
        return Handle(self, gaddr, "X", version=ver)

    def write(self, handle: Handle):
        handle.mark_written()
        yield self.env.timeout(self.fabric.cost.local_access)

    def sunlock(self, handle: Handle):
        self._untrack(handle)
        mid, line = handle.gaddr
        yield from self.fabric.faa(mid, line,
                                   -lw.reader_bit(self.node_id))

    def xunlock(self, handle: Handle):
        self._untrack(handle)
        mid, line = handle.gaddr
        if handle.dirty:
            yield from self.fabric.write(mid, line, self.cfg.gcl_bytes,
                                         handle.version)
        yield from self.fabric.faa(mid, line,
                                   -lw.writer_field(self.node_id))

    def atomic_faa(self, gaddr, delta: int):
        mid, line = gaddr
        old = yield from self.fabric.faa(mid, ("atomic", line), delta)
        return old


# Deprecation shim: _SELHandle was SEL's private handle type pre-v2; the
# unified Handle (core/handles.py) replaced it.  Out-of-tree isinstance
# checks keep working for one release.
_SELHandle = Handle


# --------------------------------------------------------------- registry
def _build_sel(layer):
    c = layer.cfg
    return [SELNode(layer.env, i, layer.fabric, c.selcc,
                    c.threads_per_node, seed=c.seed)
            for i in range(c.n_compute)]


register_protocol(
    "sel", _build_sel,
    description="eager-release shared-exclusive latch, no caching "
                "(Ziegler et al. baseline)")
