"""Concurrent B-link tree over the SELCC Table-1 v2 API (paper Sec. 8.1).

Migration recipe exactly as the paper prescribes: tree nodes align onto
Global Cache Lines, and the monolithic server's local shared-exclusive
latches become SELCC latch scopes.  Lehman-Yao right-links make descents
latch-free-ish (no lock coupling): a reader that lands on a split node
follows the link.  Runs unchanged over every backend registered with
``repro_torch.core.register_protocol`` (SELCC, SEL, GAM, RPC, ...) — that API
parity is the paper's abstraction-layer claim.

v2 data plane: node payloads live in the layer's :class:`GclHeap` and
are reached ONLY through handles — ``h = yield from node.slocked(g)``,
``n = h.value``, ``yield from h.store(n)``, ``yield from h.release()``.
Every access happens strictly under the corresponding SELCC latch scope,
and the protocol's coherence invariant (asserted online) makes that
equivalent to reading one's own coherent cached copy.  The shared root
is published as the layer binding ``"btree:root"`` — no state hides in
``SELCCLayer.__dict__`` anymore.
"""

from __future__ import annotations

from dataclasses import dataclass, field

FANOUT = 64
ROOT_BINDING = "btree:root"


@dataclass
class _Node:
    leaf: bool
    keys: list = field(default_factory=list)
    vals: list = field(default_factory=list)      # children gaddrs or values
    right: object = None                           # right-link gaddr
    high: object = None                            # high key (None = +inf)


class BLinkTree:
    def __init__(self, layer, node, fanout: int = FANOUT):
        """layer: SELCCLayer (allocator + heap); node: the compute-node
        protocol object this tree instance runs on."""
        self.layer = layer
        self.node = node
        self.fanout = fanout
        if layer.binding(ROOT_BINDING) is None:
            layer.bind(ROOT_BINDING, layer.alloc_object(_Node(leaf=True)))
        self.stats = {"splits": 0, "link_hops": 0}

    @property
    def root(self):
        return self.layer.binding(ROOT_BINDING)

    # ------------------------------------------------------------- search
    def _descend(self, key):
        """Find the leaf that should hold key (read-latched walk)."""
        cur = self.root
        while True:
            h = yield from self.node.slocked(cur)
            try:
                n = h.value
                if n.high is not None and key >= n.high \
                        and n.right is not None:
                    nxt = n.right
                    self.stats["link_hops"] += 1
                elif n.leaf:
                    return cur
                else:
                    nxt = n.vals[self._child_index(n, key)]
            finally:
                yield from h.release()
            cur = nxt

    @staticmethod
    def _child_index(n: _Node, key) -> int:
        i = 0
        while i < len(n.keys) and key >= n.keys[i]:
            i += 1
        return i

    def lookup(self, key):
        leaf = yield from self._descend(key)
        while True:
            h = yield from self.node.slocked(leaf)
            try:
                n = h.value
                if n.high is not None and key >= n.high \
                        and n.right is not None:
                    leaf = n.right
                    self.stats["link_hops"] += 1
                    continue
                if key in n.keys:
                    return n.vals[n.keys.index(key)]
                return None
            finally:
                yield from h.release()

    # ------------------------------------------------------------- insert
    def insert(self, key, val):
        leaf = yield from self._descend(key)
        while True:
            h = yield from self.node.xlocked(leaf)
            try:
                n = h.value
                if n.high is not None and key >= n.high \
                        and n.right is not None:
                    leaf = n.right
                    self.stats["link_hops"] += 1
                    continue
                self._leaf_put(n, key, val)
                yield from h.store(n)
                if len(n.keys) <= self.fanout:
                    return
                # split: allocate right sibling, move upper half, link.
                # The sibling is seeded BEFORE n.right publishes it (the
                # store below happens under this X scope), so no reader
                # can observe a half-built node.
                mid = len(n.keys) // 2
                sep = n.keys[mid]
                sn = _Node(leaf=n.leaf, keys=n.keys[mid:], vals=n.vals[mid:],
                           right=n.right, high=n.high)
                if not n.leaf:
                    sn.keys = n.keys[mid + 1:]
                    sn.vals = n.vals[mid:]
                sib = self.layer.alloc_object(sn)
                n.keys = n.keys[:mid]
                n.vals = n.vals[:mid] if n.leaf else n.vals[:mid + 1]
                n.right = sib
                n.high = sep
                self.stats["splits"] += 1
                yield from h.store(n)
            finally:
                yield from h.release()
            yield from self._insert_parent(leaf, sep, sib)
            return

    def _leaf_put(self, n: _Node, key, val) -> None:
        i = 0
        while i < len(n.keys) and n.keys[i] < key:
            i += 1
        if i < len(n.keys) and n.keys[i] == key:
            n.vals[i] = val
        else:
            n.keys.insert(i, key)
            n.vals.insert(i, val)

    def _insert_parent(self, child, sep, sib):
        """Install separator; grows a new root when the old root split."""
        root = self.root
        if child == root:
            new_root = self.layer.alloc_object(
                _Node(leaf=False, keys=[sep], vals=[child, sib]))
            h = yield from self.node.xlocked(new_root)
            try:
                yield from h.store(h.value)
            finally:
                yield from h.release()
            self.layer.bind(ROOT_BINDING, new_root)
            return
        # find parent by descending for sep (simplified Lehman-Yao)
        cur = self.root
        path = []
        while True:
            h = yield from self.node.slocked(cur)
            try:
                n = h.value
                if n.leaf or (n.vals and child in n.vals):
                    break
                path.append(cur)
                cur = n.vals[self._child_index(n, sep)]
            finally:
                yield from h.release()
        target = cur if not self.layer.heap.load(cur).leaf else \
            (path[-1] if path else self.root)
        h = yield from self.node.xlocked(target)
        oversize = False
        try:
            n = h.value
            i = self._child_index(n, sep)
            n.keys.insert(i, sep)
            n.vals.insert(i + 1, sib)
            yield from h.store(n)
            oversize = len(n.keys) > self.fanout
            if oversize:
                mid = len(n.keys) // 2
                sep2 = n.keys[mid]
                sib2 = self.layer.alloc_object(
                    _Node(leaf=False, keys=n.keys[mid + 1:],
                          vals=n.vals[mid + 1:], right=n.right, high=n.high))
                n.keys = n.keys[:mid]
                n.vals = n.vals[:mid + 1]
                n.right = sib2
                n.high = sep2
                self.stats["splits"] += 1
                yield from h.store(n)
        finally:
            yield from h.release()
        if oversize:
            yield from self._insert_parent(target, sep2, sib2)

    # -------------------------------------------------------------- scan
    def range_scan(self, key, count: int):
        """Read ``count`` keys from ``key`` following leaf links."""
        leaf = yield from self._descend(key)
        out = []
        while leaf is not None and len(out) < count:
            h = yield from self.node.slocked(leaf)
            try:
                n = h.value
                for k, v in zip(n.keys, n.vals):
                    if k >= key and len(out) < count:
                        out.append((k, v))
                leaf = n.right
            finally:
                yield from h.release()
        return out
