"""Discrete-event simulation engine + modeled RDMA fabric.

The container has no RDMA NICs, so the paper's cluster (CloudLab c6220,
ConnectX-3 FDR 56 Gbps) is reproduced with a discrete-event simulator.
The *protocol logic* that runs on top (core/protocol.py, core/sel.py,
core/gam.py) is a real implementation — state machines, latch words,
invalidation queues — only the transport timing is modeled here.

Engine design: simpy-like, generator-based processes.  A process is a
Python generator that yields :class:`Event` objects (timeouts, message
arrivals, latch grants).  ``yield from`` composes sub-protocols.

Cost model (c6220 / ConnectX-3 FDR, numbers from the paper's testbed and
the RDMA literature [Kalia ATC'16, Ziegler SIGMOD'23]):

================================  =========  =================================
one-sided READ/WRITE RTT (small)   ~1.9 us    verbs RTT on FDR
RDMA atomic (CAS/FAA) RTT          ~2.3 us    atomics are slightly slower
NIC atomic serialization            0.35 us   per-op service at the target NIC
                                              (ConnectX-3 ~2-3 Mops atomic cap;
                                              atomics to the *same* line queue)
payload bandwidth                   6.5 GB/s  56 Gbps minus headers
compute<->compute message (1-way)   1.6 us    two-sided send/recv
RPC handler service                 0.3 us    per message CPU at the receiver
memory-node RPC service (GAM)       1.2 us    per request on the 1-core agent
local cache access                  0.08 us   hash probe + copy
=================================  =========  =================================
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Event engine
# ---------------------------------------------------------------------------

class Event:
    __slots__ = ("env", "_callbacks", "done", "value")

    def __init__(self, env: "Environment"):
        self.env = env
        self._callbacks: list | None = []
        self.done = False
        self.value = None

    def succeed(self, value=None) -> "Event":
        if self.done:
            raise RuntimeError("event already triggered")
        self.done = True
        self.value = value
        cbs, self._callbacks = self._callbacks, None
        if cbs:
            for cb in cbs:
                self.env._schedule(0.0, cb, value)
        return self

    def add_callback(self, cb) -> None:
        if self.done:
            self.env._schedule(0.0, cb, self.value)
        else:
            self._callbacks.append(cb)


class Process(Event):
    """Runs a generator; the process-event succeeds with the generator's
    return value."""
    __slots__ = ("gen",)

    def __init__(self, env: "Environment", gen):
        super().__init__(env)
        self.gen = gen
        env._schedule(0.0, self._step, None)

    def _step(self, value) -> None:
        try:
            ev = self.gen.send(value)
        except StopIteration as stop:
            self.succeed(getattr(stop, "value", None))
            return
        ev.add_callback(self._step)


class Environment:
    def __init__(self):
        self.now = 0.0
        self._queue: list = []
        self._seq = 0

    def _schedule(self, delay: float, fn, arg) -> None:
        self._seq += 1
        heapq.heappush(self._queue, (self.now + delay, self._seq, fn, arg))

    def timeout(self, delay: float) -> Event:
        ev = Event(self)
        self._seq += 1
        heapq.heappush(self._queue, (self.now + delay, self._seq, ev.succeed, None))
        return ev

    def process(self, gen) -> Process:
        return Process(self, gen)

    def event(self) -> Event:
        return Event(self)

    def run(self, until: float | None = None) -> None:
        q = self._queue
        while q:
            t, _, fn, arg = q[0]
            if until is not None and t > until:
                break
            heapq.heappop(q)
            self.now = t
            fn(arg)

    def run_until_complete(self, events: list[Event], hard_limit: float = 1e9) -> None:
        """Run until every event in ``events`` has fired."""
        self.run(until=hard_limit)
        missing = [e for e in events if not e.done]
        if missing:
            raise RuntimeError(f"{len(missing)} processes did not complete "
                               f"(deadlock or hard_limit reached at t={self.now})")


class Store:
    """Unbounded FIFO message queue with blocking get()."""
    __slots__ = ("env", "items", "getters")

    def __init__(self, env: Environment):
        self.env = env
        self.items: deque = deque()
        self.getters: deque = deque()

    def put(self, item) -> None:
        if self.getters:
            self.getters.popleft().succeed(item)
        else:
            self.items.append(item)

    def get(self) -> Event:
        ev = self.env.event()
        if self.items:
            ev.succeed(self.items.popleft())
        else:
            self.getters.append(ev)
        return ev

    def __len__(self):
        return len(self.items)


class RpcRequest:
    """Two-sided RPC message to a memory-side agent (the GAM directory
    and the RPC lock manager share this wire format)."""
    __slots__ = ("kind", "line", "node", "reply", "arg")

    def __init__(self, kind, line, node, reply, arg=None):
        self.kind = kind
        self.line = line
        self.node = node
        self.reply = reply
        self.arg = arg


class QueueResource:
    """k identical servers, FIFO admission — models a NIC atomic unit or a
    memory-node CPU core pool."""
    __slots__ = ("env", "free", "waiters", "busy_time", "_last")

    def __init__(self, env: Environment, k: int):
        self.env = env
        self.free = k
        self.waiters: deque = deque()
        self.busy_time = 0.0

    def request(self) -> Event:
        ev = self.env.event()
        if self.free > 0:
            self.free -= 1
            ev.succeed()
        else:
            self.waiters.append(ev)
        return ev

    def release(self) -> None:
        if self.waiters:
            self.waiters.popleft().succeed()
        else:
            self.free += 1


class SXLatch:
    """Local shared-exclusive mutex with FIFO queueing and non-blocking
    try-variants (invalidation handlers must never block: Sec. 5.1)."""
    __slots__ = ("env", "readers", "writer", "queue")

    def __init__(self, env: Environment):
        self.env = env
        self.readers = 0
        self.writer = None
        self.queue: deque = deque()  # (kind, event, owner)

    # -- blocking (front-end accessors) -------------------------------------
    def acquire_s(self, owner=None) -> Event:
        """Event fires with value ``waited: bool``."""
        ev = self.env.event()
        if self.writer is None and not self.queue:
            self.readers += 1
            ev.succeed(False)
        else:
            self.queue.append(("S", ev, owner))
        return ev

    def acquire_x(self, owner=None) -> Event:
        ev = self.env.event()
        if self.writer is None and self.readers == 0 and not self.queue:
            self.writer = owner if owner is not None else True
            ev.succeed(False)
        else:
            self.queue.append(("X", ev, owner))
        return ev

    # -- non-blocking (invalidation handlers / eviction) ---------------------
    def try_s(self) -> bool:
        if self.writer is None and not self.queue:
            self.readers += 1
            return True
        return False

    def try_x(self, owner=None) -> bool:
        if self.writer is None and self.readers == 0 and not self.queue:
            self.writer = owner if owner is not None else True
            return True
        return False

    def release_s(self) -> None:
        assert self.readers > 0
        self.readers -= 1
        self._grant()

    def release_x(self) -> None:
        assert self.writer is not None
        self.writer = None
        self._grant()

    def _grant(self) -> None:
        while self.queue:
            kind, ev, owner = self.queue[0]
            if kind == "S":
                if self.writer is not None:
                    return
                self.queue.popleft()
                self.readers += 1
                ev.succeed(True)
            else:
                if self.writer is not None or self.readers > 0:
                    return
                self.queue.popleft()
                self.writer = owner if owner is not None else True
                ev.succeed(True)
                return

    @property
    def held(self) -> bool:
        return self.writer is not None or self.readers > 0


# ---------------------------------------------------------------------------
# RDMA cost model + fabric
# ---------------------------------------------------------------------------

@dataclass
class CostModel:
    read_rtt: float = 1.9e-6          # one-sided read/write round trip (small)
    atomic_rtt: float = 2.3e-6        # CAS / FAA round trip
    atomic_service: float = 0.35e-6   # NIC atomic-unit serialization per op
    bandwidth: float = 6.5e9          # payload B/s
    msg_one_way: float = 1.6e-6       # compute<->compute two-sided message
    handler_service: float = 0.3e-6   # invalidation-handler CPU per message
    rpc_service: float = 1.2e-6       # GAM memory-node CPU per request
    local_access: float = 0.08e-6     # local cache hit
    local_op: float = 0.02e-6         # misc local CPU step
    wal_flush: float = 100e-6         # disk WAL flush (TPC-C durability, Fig 12)

    def xfer(self, nbytes: int) -> float:
        return nbytes / self.bandwidth


@dataclass
class FabricStats:
    atomics: int = 0
    reads: int = 0
    writes: int = 0
    messages: int = 0
    bytes_moved: int = 0

    def total_rdma(self) -> int:
        return self.atomics + self.reads + self.writes


class MemoryNode:
    """A passive memory server: latch words + payload versions. Zero
    protocol logic — the defining constraint of the paper."""
    __slots__ = ("mid", "words", "mem_version", "atomic_unit", "cpu")

    def __init__(self, env: Environment, mid: int, cpu_cores: int = 1):
        self.mid = mid
        self.words: dict[int, int] = {}
        self.mem_version: dict[int, int] = {}
        # NIC atomic unit: serializes atomics hitting this NIC
        self.atomic_unit = QueueResource(env, 1)
        # CPU cores — used ONLY by the RPC baseline (GAM); SELCC never touches it
        self.cpu = QueueResource(env, cpu_cores)


class Fabric:
    """Models one-sided verbs to memory nodes + two-sided messages among
    compute nodes.  GCL ``gaddr`` is (mem_node_id, line_id) — see dsm/address."""

    def __init__(self, env: Environment, n_memory_nodes: int,
                 cost: CostModel | None = None, mem_cpu_cores: int = 1):
        self.env = env
        self.cost = cost or CostModel()
        self.mem = [MemoryNode(env, i, mem_cpu_cores) for i in range(n_memory_nodes)]
        self.stats = FabricStats()
        self.inboxes: dict[int, Store] = {}

    # -- one-sided atomics ----------------------------------------------------
    def _atomic(self, mid: int, line: int, apply_fn, extra_return_bytes: int = 0):
        c = self.cost
        m = self.mem[mid]
        self.stats.atomics += 1
        yield self.env.timeout(c.atomic_rtt / 2)
        yield m.atomic_unit.request()
        yield self.env.timeout(c.atomic_service)
        old = m.words.get(line, 0)
        new = apply_fn(old)
        if new is not None:
            m.words[line] = new
        data = m.mem_version.get(line, 0)
        m.atomic_unit.release()
        back = c.atomic_rtt / 2 + (c.xfer(extra_return_bytes) if extra_return_bytes else 0.0)
        if extra_return_bytes:
            self.stats.bytes_moved += extra_return_bytes
        yield self.env.timeout(back)
        return old, data

    def cas(self, mid: int, line: int, cmp: int, new: int):
        old, _ = yield from self._atomic(
            mid, line, lambda w: new if w == cmp else None)
        return old

    def faa(self, mid: int, line: int, delta: int):
        old, _ = yield from self._atomic(
            mid, line, lambda w: (w + delta) & ((1 << 64) - 1))
        return old

    def cas_read(self, mid: int, line: int, cmp: int, new: int, nbytes: int):
        """Combined latch-CAS + payload read in ONE round trip (the paper's
        key data-path saving: Sec. 1 'one combined one-sided RDMA operation')."""
        return (yield from self._atomic(
            mid, line, lambda w: new if w == cmp else None,
            extra_return_bytes=nbytes))

    def faa_read(self, mid: int, line: int, delta: int, nbytes: int):
        return (yield from self._atomic(
            mid, line, lambda w: (w + delta) & ((1 << 64) - 1),
            extra_return_bytes=nbytes))

    # -- one-sided read/write -------------------------------------------------
    def read(self, mid: int, line: int, nbytes: int):
        c = self.cost
        self.stats.reads += 1
        self.stats.bytes_moved += nbytes
        yield self.env.timeout(c.read_rtt + c.xfer(nbytes))
        return self.mem[mid].mem_version.get(line, 0)

    def write(self, mid: int, line: int, nbytes: int, version: int):
        c = self.cost
        self.stats.writes += 1
        self.stats.bytes_moved += nbytes
        # effect lands at the memory node ~half an RTT after issue; the
        # issuing protocol holds the exclusive latch, so ordering is safe.
        yield self.env.timeout(c.read_rtt / 2 + c.xfer(nbytes))
        self.mem[mid].mem_version[line] = version
        yield self.env.timeout(c.read_rtt / 2)
        return None

    # -- two-sided messages among compute nodes --------------------------------
    def register_inbox(self, node_id: int, inbox: Store) -> None:
        self.inboxes[node_id] = inbox

    def send(self, dst_node: int, msg) -> None:
        """Fire-and-forget two-sided message (invalidation RPC)."""
        self.stats.messages += 1
        inbox = self.inboxes[dst_node]
        self.env._schedule(self.cost.msg_one_way, inbox.put, msg)
