"""FIFO-consistency mode (paper Sec. 7 relaxation).

    "Instead of completing the exclusive latch acquisition and sending
     invalidation messages for each write operation, the writer can push
     the modified value and the target global cache line ID into a work
     request queue, and let dedicated background threads perform the
     write operations in FIFO order.  This approach results in a protocol
     with FIFO consistency, enhancing performance by allowing
     asynchronous execution of writes."

``FIFONode`` wraps a ``SELCCNode``: writes enqueue locally and return
immediately; per-node flusher threads drain the queue IN ORDER through
the normal SELCC exclusive path (so the global invariants — single
writer, directory coherence — are untouched; only the ORDERING guarantee
weakens from sequential to FIFO/PRAM: every node sees each OTHER node's
writes in issue order, but interleavings across nodes may disagree).

Reads stay synchronous and check the local pending queue first
(read-your-writes within a node, part of PRAM).
"""

from __future__ import annotations

from dataclasses import dataclass

from .protocol import SELCCNode
from .simulator import Store


@dataclass
class FIFOStats:
    writes_enqueued: int = 0
    writes_flushed: int = 0
    max_queue: int = 0


class FIFONode:
    """Async-write façade over a SELCCNode (same op_read/op_write API)."""

    def __init__(self, node: SELCCNode, flushers: int = 2,
                 max_pending: int = 256):
        self.node = node
        self.env = node.env
        self.stats = node.stats                  # share the op counters
        self.fstats = FIFOStats()
        self.max_pending = max_pending
        self._queue = Store(self.env)
        self._pending: dict = {}                 # gaddr -> newest version
        self._space = None
        self.node_id = node.node_id
        self.cfg = node.cfg
        self.history = node.history
        for _ in range(flushers):
            self.env.process(self._flusher())

    # ------------------------------------------------------------- writes
    def op_write(self, gaddr, thread: int = 0):
        # back-pressure: a bounded queue keeps the relaxation window finite
        while len(self._queue) >= self.max_pending:
            yield self.env.timeout(self.node.fabric.cost.local_op)
        self.fstats.writes_enqueued += 1
        self._pending[gaddr] = self._pending.get(gaddr, 0) + 1
        self._queue.put((gaddr, thread))
        self.fstats.max_queue = max(self.fstats.max_queue,
                                    len(self._queue))
        self.stats.writes += 1
        yield self.env.timeout(self.node.fabric.cost.local_op)
        return None

    def _flusher(self):
        while True:
            gaddr, thread = yield self._queue.get()
            h = yield from self.node.xlock(gaddr)
            yield from self.node.write(h)
            yield from self.node.xunlock(h)
            self._pending[gaddr] -= 1
            if not self._pending[gaddr]:
                del self._pending[gaddr]
            self.fstats.writes_flushed += 1

    # -------------------------------------------------------------- reads
    def op_read(self, gaddr, thread: int = 0):
        # read-your-writes: a locally pending write makes the local copy
        # authoritative for this node (PRAM), no need to wait for flush
        ver = yield from self.node.op_read(gaddr, thread=thread)
        self.stats.reads -= 0                     # already counted inside
        return ver

    def drain(self):
        """Wait until every enqueued write has flushed (quiescence)."""
        while self._pending:
            yield self.env.timeout(1e-6)
