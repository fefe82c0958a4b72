"""GAM baseline: RPC-based directory cache coherence (Cai et al., VLDB'18).

The paper's second baseline.  The defining property (and weakness on
compute-limited disaggregated memory): the COHERENCE DIRECTORY LIVES ON
THE MEMORY NODE and every miss / ownership change is an RPC served by the
memory node's (few) CPU cores.  With the default 1 core per memory server
(the paper's testbed restriction) the agent saturates at
~1/rpc_service requests/s — the bottleneck SELCC removes.

Two consistency levels, as benchmarked in the paper:
* ``SEQ``  — writes wait for all sharer invalidation ACKs;
* ``TSO``  — writes get their reply as soon as the directory is updated;
  invalidations complete asynchronously (total-store-order-ish).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass

from .handles import Handle, NodeAPIMixin
from .protocol import NodeStats
from .registry import register_protocol
from .simulator import (Environment, Fabric, QueueResource, RpcRequest,
                        SXLatch, Store)

_Req = RpcRequest


@dataclass
class GAMConfig:
    gcl_bytes: int = 2048
    cache_capacity: int = 4096
    consistency: str = "SEQ"          # or "TSO"
    mem_cores: int = 1                # compute power of the memory agent


class GAMMemoryAgent:
    """Directory + request servers on ONE memory node."""

    def __init__(self, env: Environment, fabric: Fabric, mid: int,
                 cfg: GAMConfig):
        self.env = env
        self.fabric = fabric
        self.mid = mid
        self.cfg = cfg
        self.inbox = Store(env)
        self.directory: dict = {}          # line -> [owner|None, set(sharers)]
        self.version: dict = {}            # authoritative version
        self.nodes: dict = {}              # node_id -> GAMNode
        self._line_q: dict = {}            # line -> deque of parsed _Req
        # the agent's CPU: every CPU-bound step contends here (the
        # baseline's defining bottleneck), while network waits — recalls
        # parked on a peer's open scope, invalidation acks — overlap
        self.cpu = QueueResource(env, max(1, cfg.mem_cores))
        for _ in range(cfg.mem_cores):
            env.process(self._serve_loop())

    def _serve_loop(self):
        """Front-end: parse requests (CPU-serialized) and dispatch them to
        per-line drains.  Handling must NOT block this loop inline: a
        single-core agent that waited out an ownership recall here
        deadlocked against sorted multi-line scope acquisition (the
        recalled holder was itself waiting for this agent's next grant)."""
        env, cost = self.env, self.fabric.cost
        while True:
            req = yield self.inbox.get()
            yield env.timeout(cost.rpc_service)          # CPU: parse + directory
            q = self._line_q.get(req.line)
            if q is None:
                q = self._line_q[req.line] = deque()
                q.append(req)
                env.process(self._drain_line(req.line))
            else:
                q.append(req)

    def _drain_line(self, line):
        """Serve one line's requests strictly in order (two concurrent
        grants on one line would hand out double ownership)."""
        q = self._line_q[line]
        while q:
            yield from self._handle(q[0])
            q.popleft()
        del self._line_q[line]

    def _handle(self, req: _Req):
        env, cost = self.env, self.fabric.cost
        entry = self.directory.setdefault(req.line, [None, set()])
        owner = entry[0]
        ver = self.version.get(req.line, 0)
        if req.kind == "R":
            if owner is not None and owner != req.node:
                # max(): an owner that already evicted the line reports
                # version 0 — never regress the authoritative counter —
                # and PERSIST the recalled version: a later W grant must
                # not reuse a number readers already observed
                ver = max(ver, (yield from self._recall(req.line, owner,
                                                        downgrade=True)))
                self.version[req.line] = ver
                entry[0] = None
                entry[1].add(owner)
            entry[1].add(req.node)
            yield from self._grant(req, ver)
        elif req.kind == "W":
            if owner is not None and owner != req.node:
                ver = max(ver, (yield from self._recall(req.line, owner,
                                                        downgrade=False)))
                entry[0] = None
            targets = [s for s in entry[1] if s != req.node]
            acks = []
            for s in targets:
                yield self.cpu.request()                    # CPU per inv
                yield env.timeout(cost.rpc_service * 0.5)
                self.cpu.release()
                acks.append(self._invalidate(req.line, s))
            entry[1].clear()
            if self.cfg.consistency == "SEQ":
                for ev in acks:
                    yield ev
            entry[0] = req.node
            self.version[req.line] = ver + 1
            yield from self._grant(req, ver + 1)
        elif req.kind == "EVICT":
            entry[1].discard(req.node)
            # the write-back carries the evictor's version: restore it
            # UNCONDITIONALLY — ownership may already have moved on
            # (a W raced ahead of this notice and recalled an entry the
            # evictor had popped), and skipping the max() would regress
            # the counter to a number earlier readers already observed
            self.version[req.line] = max(
                self.version.get(req.line, 0), req.arg or 0)
            if entry[0] == req.node:
                entry[0] = None
                yield env.timeout(
                    cost.xfer(self.cfg.gcl_bytes))          # write-back in
            if req.reply is not None:
                self._reply(req, 0)

    def _recall(self, line, owner, downgrade):
        """Fetch the dirty copy back from its owner (adds 2 message hops +
        payload + the owner's handler time)."""
        cost = self.fabric.cost
        yield self.env.timeout(cost.msg_one_way)                 # recall msg
        node = self.nodes[owner]
        # the owner may have an OPEN exclusive scope on the line; the
        # recall completes only once that scope releases (otherwise two
        # nodes would hold live X handles at once and lose updates)
        ver = yield node.recall_begin((self.mid, line), downgrade)
        yield self.env.timeout(cost.handler_service
                               + cost.msg_one_way
                               + cost.xfer(self.cfg.gcl_bytes))  # data back
        self.fabric.stats.messages += 2
        self.fabric.stats.bytes_moved += self.cfg.gcl_bytes
        return ver

    def _invalidate(self, line, sharer):
        """Send INV to a sharer; returns an ack event.  The invalidation
        parks until the sharer's open scopes release (same rule as
        ownership recalls): an S scope must observe one payload for its
        whole lifetime."""
        cost = self.fabric.cost
        ev = self.env.event()
        node = self.nodes[sharer]

        def deliver(_):
            done = node.invalidate_begin((self.mid, line))

            def acked(_v):
                # ack flies back one hop later
                self.env._schedule(cost.msg_one_way + cost.handler_service,
                                   ev.succeed, None)

            done.add_callback(acked)

        self.env._schedule(cost.msg_one_way, deliver, None)
        self.fabric.stats.messages += 2
        return ev

    def _reply(self, req: _Req, value):
        cost = self.fabric.cost
        self.env._schedule(cost.msg_one_way
                           + cost.xfer(self.cfg.gcl_bytes),
                           req.reply.succeed, value)
        self.fabric.stats.messages += 1
        self.fabric.stats.bytes_moved += self.cfg.gcl_bytes

    def _grant(self, req: _Req, version):
        """Ship a grant and wait until the grantee has INSTALLED it (the
        install ack): serving the line's next request while the previous
        grant is still airborne would let a recall of the new owner
        complete against a copy that does not exist yet — double
        ownership.  Ownership transfer cannot outrun the grant message."""
        ack = self.env.event()
        self._reply(req, (version, ack))
        yield ack


class GAMNode(NodeAPIMixin):
    """Compute node with a local cache; misses go to the directory via RPC."""

    def __init__(self, env: Environment, node_id: int, fabric: Fabric,
                 agents: list[GAMMemoryAgent], cfg: GAMConfig | None = None,
                 n_threads: int = 16, seed: int = 0):
        self.env = env
        self.node_id = node_id
        self.fabric = fabric
        self.agents = agents
        self.cfg = cfg or GAMConfig()
        self.stats = NodeStats()
        # keyed by the FULL gaddr: offsets repeat across memory nodes, so
        # a line-only key would alias (0, k) with (1, k) and hand out
        # phantom cache hits / exclusive ownership
        self.entries: OrderedDict = OrderedDict()   # gaddr -> [state, version]
        # local S/X mutex per line: GAM's directory grants OWNERSHIP, not
        # latches — without a local level two threads of one node could
        # hold overlapping X scopes on a cached M line
        self._latches: dict = {}                    # gaddr -> SXLatch
        # open-scope pins: a directory recall completes only once the
        # line has NO open scope.  Pins — not the latch — gate recalls:
        # an acquiring thread holds the latch while it waits for this
        # very agent, so recall-on-latch deadlocks under eviction races
        self._pins: dict = {}                       # gaddr -> open scopes
        self._pin_waiters: dict = {}                # gaddr -> [(downgrade, ev)]
        # versions of lines evicted while the EVICT notice is in flight:
        # a recall racing that notice must still see the line's version,
        # or the directory re-issues numbers readers already observed
        self._wb_versions: dict = {}                # gaddr -> version
        for a in agents:
            a.nodes[node_id] = self

    def _latch(self, gaddr) -> SXLatch:
        latch = self._latches.get(gaddr)
        if latch is None:
            latch = self._latches[gaddr] = SXLatch(self.env)
        return latch

    def _pin(self, gaddr) -> None:
        self._pins[gaddr] = self._pins.get(gaddr, 0) + 1

    def _unpin(self, gaddr) -> None:
        n = self._pins.get(gaddr, 1) - 1
        if n > 0:
            self._pins[gaddr] = n
            return
        self._pins.pop(gaddr, None)
        for to_state, ev in self._pin_waiters.pop(gaddr, []):
            self._finish_flip(gaddr, to_state, ev)

    def _finish_flip(self, gaddr, to_state: str, ev) -> None:
        e = self.entries.get(gaddr)
        if e is not None:
            ver = e[1]
            e[0] = to_state
        else:
            # already evicted locally — answer from the in-flight
            # write-back so the directory's counter stays monotonic
            ver = self._wb_versions.pop(gaddr, 0)
        ev.succeed(ver)

    def _flip_when_unpinned(self, gaddr, to_state: str):
        """Returns an Event firing with the local version once no open
        scope pins the line; the cache state flips at that moment (local
        accessors win, as in SELCC Sec. 5.2).  A line with no open scope
        flips immediately — lazy grants cost nothing to take back."""
        ev = self.env.event()
        if self._pins.get(gaddr, 0):
            self._pin_waiters.setdefault(gaddr, []).append((to_state, ev))
        else:
            self._finish_flip(gaddr, to_state, ev)
        return ev

    # -- memory-agent callbacks (no latency of their own; hops modeled
    #    by the agent) --------------------------------------------------------
    def invalidate_begin(self, gaddr):
        """Sharer invalidation (W grant elsewhere): S copy drops once no
        open scope reads it."""
        return self._flip_when_unpinned(gaddr, "I")

    def recall_begin(self, gaddr, downgrade: bool):
        """Ownership recall: M copy downgrades (PeerRd) or drops (PeerWr)
        once no open scope holds it."""
        return self._flip_when_unpinned(gaddr, "S" if downgrade else "I")

    # -- ops -------------------------------------------------------------------
    def _rpc(self, kind, gaddr, state):
        """Request a grant, install it, pin it, and ONLY THEN ack the
        agent (see GAMMemoryAgent._grant for why the ack gates the
        line's next request)."""
        mid, line = gaddr
        reply = self.env.event()
        self.fabric.stats.messages += 1
        agent = self.agents[mid]
        self.env._schedule(self.fabric.cost.msg_one_way, agent.inbox.put,
                           _Req(kind, line, self.node_id, reply))
        ver, ack = yield reply
        self._touch(gaddr, state, ver)
        self._pin(gaddr)
        ack.succeed()
        return ver

    def _touch(self, gaddr, state, ver):
        self._wb_versions.pop(gaddr, None)   # fresh grant supersedes
        e = self.entries.get(gaddr)
        if e is None:
            self.entries[gaddr] = [state, ver]
            if len(self.entries) > self.cfg.cache_capacity:
                self._evict_one()
        else:
            e[0] = state
            e[1] = ver
            self.entries.move_to_end(gaddr)

    def _evict_one(self) -> None:
        """Evict the LRU line whose latch is free — a line with an open
        scope must keep its ownership until the scope releases."""
        for old_gaddr in list(self.entries):
            latch = self._latches.get(old_gaddr)
            if (latch is not None and latch.held) \
                    or self._pins.get(old_gaddr, 0):
                continue
            old_e = self.entries.pop(old_gaddr)
            if old_e[0] != "I":
                self._wb_versions[old_gaddr] = old_e[1]
                # eviction notice (fire-and-forget RPC, costs agent
                # CPU) to the directory that owns the victim line; the
                # local version rides along as the write-back payload
                agent = self.agents[old_gaddr[0]]
                self.env._schedule(self.fabric.cost.msg_one_way,
                                   agent.inbox.put,
                                   _Req("EVICT", old_gaddr[1],
                                        self.node_id, None, old_e[1]))
            return

    # composite ops are thin wrappers over the lock surface below — ONE
    # copy of the hit/miss/directory logic
    def op_read(self, gaddr, thread: int = 0):
        t0 = self.env.now
        h = yield from self.slock(gaddr)
        yield from self.sunlock(h)
        self.stats.reads += 1
        self.stats.latency_sum += self.env.now - t0

    def op_write(self, gaddr, thread: int = 0):
        t0 = self.env.now
        h = yield from self.xlock(gaddr)
        yield from self.write(h)
        yield from self.xunlock(h)
        self.stats.writes += 1
        self.stats.latency_sum += self.env.now - t0

    # -- Table-1 v2 lock surface ----------------------------------------------
    # Two-level CC, mirroring SELCC Sec. 5.2: a LOCAL S/X mutex per line
    # first (scopes on one node serialize), directory ownership second
    # (paying the memory-node CPU on every miss — the baseline's defining
    # weakness).  Directory recalls wait on the local mutex, so an open
    # exclusive scope is genuinely exclusive cluster-wide.  This is what
    # lets btree/txn/parity workloads run over GAM through the ONE facade.
    def slock(self, gaddr):
        yield self._latch(gaddr).acquire_s(owner=self)
        e = self.entries.get(gaddr)
        if e is not None and e[0] in ("S", "M"):
            self._pin(gaddr)          # pin BEFORE yielding: recalls wait
            self.entries.move_to_end(gaddr)
            yield self.env.timeout(self.fabric.cost.local_access)
            ver = e[1]
        else:
            ver = yield from self._rpc("R", gaddr, "S")
        return Handle(self, gaddr, "S", version=ver)

    def xlock(self, gaddr):
        yield self._latch(gaddr).acquire_x(owner=self)
        e = self.entries.get(gaddr)
        if e is not None and e[0] == "M":
            self._pin(gaddr)          # pin BEFORE yielding: recalls wait
            self.entries.move_to_end(gaddr)
            yield self.env.timeout(self.fabric.cost.local_access)
            ver = e[1]
        else:
            ver = yield from self._rpc("W", gaddr, "M")
        return Handle(self, gaddr, "X", version=ver)

    def write(self, handle: Handle):
        if handle.mode != "X":
            raise PermissionError("GAM write without exclusive ownership")
        e = self.entries.get(handle.gaddr)
        if e is not None:
            e[1] += 1
        handle.mark_written()
        yield self.env.timeout(self.fabric.cost.local_access)

    def sunlock(self, handle: Handle):
        self._untrack(handle)
        self._unpin(handle.gaddr)     # parked recalls complete here
        self._latch(handle.gaddr).release_s()
        yield self.env.timeout(self.fabric.cost.local_op)

    def xunlock(self, handle: Handle):
        # directory ownership stays cached M (lazy, like GAM's lease)
        # until recalled/invalidated; only the local mutex and the
        # recall pin release here
        self._untrack(handle)
        self._unpin(handle.gaddr)     # parked recalls complete here
        self._latch(handle.gaddr).release_x()
        yield self.env.timeout(self.fabric.cost.local_op)

    def atomic_faa(self, gaddr, delta: int):
        mid, line = gaddr
        old = yield from self.fabric.faa(mid, ("atomic", line), delta)
        return old


# --------------------------------------------------------------- registry
def _build_gam(layer):
    c = layer.cfg
    agents = [GAMMemoryAgent(layer.env, layer.fabric, m, c.gam)
              for m in range(c.n_memory)]
    layer.agents = agents
    return [GAMNode(layer.env, i, layer.fabric, agents, c.gam,
                    c.threads_per_node, seed=c.seed)
            for i in range(c.n_compute)]


register_protocol(
    "gam", _build_gam,
    mem_cpu_cores=lambda cfg: cfg.gam.mem_cores,
    description="RPC directory coherence on the memory node "
                "(Cai et al. baseline)")
