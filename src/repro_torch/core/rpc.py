"""RPC-served coherence baseline — the paper's Sec. 2 strawman.

The simplest way to expose disaggregated memory with main-memory-like
semantics: keep ALL state (latch table + payload versions) on the memory
node and serve every single access as an RPC handled by the memory
node's (few) CPU cores.  No compute-side cache, no one-sided verbs, no
lazy latch release — each lock/unlock is a message to a centralized lock
manager whose throughput is capped at ``mem_cores / rpc_service``.

This backend exists for two reasons:

1. it is the missing lower-bound baseline between SEL (one-sided, no
   cache) and GAM (RPC directory WITH caching) — the Sec. 2 argument for
   why one-sided protocols matter on compute-limited memory nodes;
2. it is registered EXCLUSIVELY through the public
   :func:`repro_torch.core.register_protocol` extension point — no edits to
   ``SELCCLayer.__init__`` — proving the backend registry is a real API.

Configuration rides on the existing knobs: ``cfg.selcc.gcl_bytes`` sizes
the payload shipped with each grant and ``cfg.gam.mem_cores`` sets the
agent's CPU budget (both baselines share the paper's testbed memory
node).
"""

from __future__ import annotations

from collections import deque

from .handles import Handle, NodeAPIMixin
from .protocol import NodeStats, SELCCConfig
from .registry import register_protocol
from .simulator import Environment, Fabric, RpcRequest, Store

_Req = RpcRequest


class _LineLock:
    __slots__ = ("readers", "writer", "waitq")

    def __init__(self):
        self.readers = 0
        self.writer = None
        self.waitq: deque = deque()      # of _Req ("S"/"X")


class RPCLockAgent:
    """Centralized lock manager + data service on ONE memory node."""

    def __init__(self, env: Environment, fabric: Fabric, mid: int,
                 gcl_bytes: int, cores: int = 1):
        self.env = env
        self.fabric = fabric
        self.mid = mid
        self.gcl_bytes = gcl_bytes
        self.inbox = Store(env)
        self.locks: dict = {}            # line -> _LineLock
        self.version: dict = {}          # line -> authoritative version
        self.words: dict = {}            # Atomic() words
        for _ in range(max(1, cores)):
            env.process(self._serve_loop())

    def _serve_loop(self):
        env, cost = self.env, self.fabric.cost
        while True:
            req = yield self.inbox.get()
            yield env.timeout(cost.rpc_service)       # CPU: the bottleneck
            lk = self.locks.setdefault(req.line, _LineLock())
            if req.kind == "S":
                if lk.writer is None and not lk.waitq:
                    lk.readers += 1
                    self._grant(req)
                else:
                    lk.waitq.append(req)
            elif req.kind == "X":
                if lk.writer is None and lk.readers == 0 and not lk.waitq:
                    lk.writer = req.node
                    self._grant(req)
                else:
                    lk.waitq.append(req)
            elif req.kind == "US":
                lk.readers -= 1
                self._wake(lk)
            elif req.kind == "UX":
                if req.arg is not None:               # dirty write-back
                    self.version[req.line] = req.arg
                lk.writer = None
                self._wake(lk)
            elif req.kind == "FAA":
                old = self.words.get(req.line, 0)
                self.words[req.line] = old + req.arg
                self._reply(req, old, data=False)

    def _wake(self, lk: _LineLock) -> None:
        """FIFO grant: one writer, or every reader at the queue head."""
        while lk.waitq:
            head = lk.waitq[0]
            if head.kind == "X":
                if lk.writer is None and lk.readers == 0:
                    lk.waitq.popleft()
                    lk.writer = head.node
                    self._grant(head)
                return
            if lk.writer is not None:
                return
            lk.waitq.popleft()
            lk.readers += 1
            self._grant(head)

    def _grant(self, req: _Req) -> None:
        self._reply(req, self.version.get(req.line, 0), data=True)

    def _reply(self, req: _Req, value, data: bool) -> None:
        cost = self.fabric.cost
        delay = cost.msg_one_way + (cost.xfer(self.gcl_bytes) if data else 0)
        if data:
            self.fabric.stats.bytes_moved += self.gcl_bytes
        self.fabric.stats.messages += 1
        self.env._schedule(delay, req.reply.succeed, value)


class RPCNode(NodeAPIMixin):
    """Compute node of the strawman: every latch op is a round trip to
    the home memory node's lock agent; nothing is ever cached."""

    def __init__(self, env: Environment, node_id: int, fabric: Fabric,
                 agents: list[RPCLockAgent], cfg: SELCCConfig | None = None,
                 n_threads: int = 16, seed: int = 0):
        self.env = env
        self.node_id = node_id
        self.fabric = fabric
        self.agents = agents
        self.cfg = cfg or SELCCConfig()
        self.n_threads = n_threads
        self.stats = NodeStats()
        self.history: list = []

    # -- RPC plumbing -------------------------------------------------------
    def _rpc(self, kind, gaddr, arg=None):
        mid, line = gaddr
        reply = self.env.event()
        self.fabric.stats.messages += 1
        agent = self.agents[mid]
        self.env._schedule(self.fabric.cost.msg_one_way, agent.inbox.put,
                           _Req(kind, line, self.node_id, reply, arg))
        value = yield reply
        return value

    def _rpc_oneway(self, kind, gaddr, arg=None) -> None:
        mid, line = gaddr
        self.fabric.stats.messages += 1
        agent = self.agents[mid]
        self.env._schedule(self.fabric.cost.msg_one_way, agent.inbox.put,
                           _Req(kind, line, self.node_id, None, arg))

    # -- Table-1 v2 surface -------------------------------------------------
    def slock(self, gaddr):
        ver = yield from self._rpc("S", gaddr)
        return Handle(self, gaddr, "S", version=ver)

    def xlock(self, gaddr):
        ver = yield from self._rpc("X", gaddr)
        return Handle(self, gaddr, "X", version=ver)

    def write(self, handle: Handle):
        if handle.mode != "X":
            raise PermissionError("RPC write without the exclusive lock")
        handle.mark_written()
        yield self.env.timeout(self.fabric.cost.local_access)

    def sunlock(self, handle: Handle):
        self._untrack(handle)
        self._rpc_oneway("US", handle.gaddr)
        yield self.env.timeout(self.fabric.cost.local_op)

    def xunlock(self, handle: Handle):
        self._untrack(handle)
        self._rpc_oneway("UX", handle.gaddr,
                         handle.version if handle.dirty else None)
        yield self.env.timeout(self.fabric.cost.local_op)

    def atomic_faa(self, gaddr, delta: int):
        mid, line = gaddr
        old = yield from self._rpc("FAA", (mid, ("atomic", line)), delta)
        return old

    # -- composite ops (micro-benchmark surface) ----------------------------
    def op_read(self, gaddr, thread: int = 0):
        t0 = self.env.now
        h = yield from self.slock(gaddr)
        ver = h.version
        yield self.env.timeout(self.fabric.cost.local_access)
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


# ------------------------------------------------------- public registration
def _build_rpc(layer):
    c = layer.cfg
    agents = [RPCLockAgent(layer.env, layer.fabric, m,
                           gcl_bytes=c.selcc.gcl_bytes,
                           cores=c.gam.mem_cores)
              for m in range(c.n_memory)]
    layer.agents = agents
    return [RPCNode(layer.env, i, layer.fabric, agents, c.selcc,
                    c.threads_per_node, seed=c.seed)
            for i in range(c.n_compute)]


register_protocol(
    "rpc", _build_rpc,
    mem_cpu_cores=lambda cfg: cfg.gam.mem_cores,
    description="centralized RPC lock manager on the memory node "
                "(Sec. 2 strawman)")
