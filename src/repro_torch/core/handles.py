"""Unified data-plane handles + scope guards — the Table-1 v2 surface.

Pre-v2, the abstraction layer had a control plane only: ``slock``/
``xlock`` returned backend-private handles (SELCC's cache-entry wrapper,
SEL's ``_SELHandle``) carrying nothing but a version counter, and the
applications smuggled their actual payloads through
``layer.__dict__["_btree_content"]``-style side channels.  This module
makes the data plane first-class:

* :class:`Handle` — ONE handle type for every backend.  ``h.value``
  reads the payload object of the latched line; ``yield from
  h.store(obj)`` writes it (X mode only) and drives the backend's write
  path (version bump, dirty marking, DES cost); ``yield from
  h.release()`` releases the latch the handle was taken in.
* :class:`GclHeap` — the per-layer object store backing ``h.value``.
  The DES is single-process, so the heap doubles as the authoritative
  memory image; the latch protocol guarantees every access happens under
  a coherent grant, which is exactly the paper's Sec. 7 argument.
* :class:`NodeAPIMixin` — scope-guarded acquisition shared by all
  backends: ``h = yield from node.slocked(g)`` / ``xlocked(g)`` track
  the open scope until ``h.release()``; ``with_slock``/``with_xlock``
  run a generator body and release on EVERY exit path (early return,
  exception); ``xlocked_many`` takes latches in canonical (sorted)
  order to keep multi-line acquisition deadlock-free.

Leak detection: ``node.open_scopes()`` / ``SELCCLayer.assert_released()``
fail teardown if any ``slocked``/``xlocked`` scope was never released —
the cross-backend parity tests assert this for every backend.
"""

from __future__ import annotations


class GclHeap:
    """Per-layer object store keyed by GAddr + a named-binding catalog.

    ``bindings`` replace the old ``layer.__dict__`` hacks: applications
    publish shared roots (B-link-tree root, txn GCL directory) under
    stable names instead of poking private attributes into the layer.
    """

    __slots__ = ("_objs", "_bindings")

    def __init__(self):
        self._objs: dict = {}
        self._bindings: dict = {}

    # -- payload plane ------------------------------------------------------
    def load(self, gaddr):
        return self._objs.get(gaddr)

    def store(self, gaddr, obj) -> None:
        self._objs[gaddr] = obj

    def discard(self, gaddr) -> None:
        """Drop a line's payload (allocator ``free``: a recycled line
        must read as uninitialized, not as the previous owner's data)."""
        self._objs.pop(gaddr, None)

    def __contains__(self, gaddr) -> bool:
        return gaddr in self._objs

    def __len__(self) -> int:
        return len(self._objs)

    def snapshot(self) -> dict:
        """Shallow copy of the memory image (cross-backend parity tests)."""
        return dict(self._objs)

    # -- named roots --------------------------------------------------------
    def bind(self, name: str, value) -> None:
        self._bindings[name] = value

    def binding(self, name: str, default=None):
        return self._bindings.get(name, default)

    def bindings(self) -> dict:
        return dict(self._bindings)


class Handle:
    """Returned by SELCC_SLock / SELCC_XLock on EVERY backend (Table 1 v2).

    ``entry`` is the backend token: SELCC hands its cache entry (version
    and dirty bits live there); cache-less backends (SEL, RPC) and GAM
    leave it ``None`` and the handle itself carries the version.
    """

    __slots__ = ("node", "gaddr", "mode", "entry", "dirty", "_version",
                 "_tracked")

    def __init__(self, node, gaddr, mode: str, entry=None, version: int = 0):
        self.node = node
        self.gaddr = gaddr
        self.mode = mode
        self.entry = entry
        self.dirty = False
        self._version = version
        self._tracked = False

    # -- control plane ------------------------------------------------------
    @property
    def version(self) -> int:
        return self.entry.version if self.entry is not None else self._version

    def mark_written(self) -> None:
        """Backend write paths call this: bump version, mark dirty."""
        if self.entry is not None:
            self.entry.version += 1
            self.entry.dirty = True
        else:
            self._version += 1
            self.dirty = True

    def release(self):
        """DES generator: release the latch this handle was taken in
        (dispatches S/X — the caller cannot mismatch unlock flavours)."""
        if self.mode == "X":
            yield from self.node.xunlock(self)
        else:
            yield from self.node.sunlock(self)

    # -- data plane ---------------------------------------------------------
    @property
    def value(self):
        """Payload object of the latched line (any mode)."""
        return self.node.heap.load(self.gaddr)

    def store(self, obj):
        """DES generator: write the payload under the exclusive latch and
        drive the backend write path (version bump + simulated cost)."""
        if self.mode != "X":
            raise PermissionError(
                f"store() on a {self.mode}-mode handle for {self.gaddr}; "
                f"take the latch with xlocked()/xlock() first")
        self.node.heap.store(self.gaddr, obj)
        yield from self.node.write(self)

    def __repr__(self) -> str:
        return (f"Handle({self.gaddr}, {self.mode}, v{self.version}"
                f"{', tracked' if self._tracked else ''})")


class NodeAPIMixin:
    """Scope-guarded latch surface shared by every protocol backend.

    Backends provide the primitives (``slock``/``xlock``/``sunlock``/
    ``xunlock``/``write``); the mixin layers the guarded, leak-tracked
    idiom on top.  ``heap`` is attached by :class:`SELCCLayer` right
    after the backend factory builds the nodes (standalone nodes get a
    private heap lazily, so unit tests can drive them directly).
    """

    _heap = None

    @property
    def heap(self) -> GclHeap:
        if self._heap is None:
            self._heap = GclHeap()
        return self._heap

    @heap.setter
    def heap(self, value: GclHeap) -> None:
        self._heap = value

    # -- scope tracking -----------------------------------------------------
    @property
    def _scopes(self) -> set:
        s = getattr(self, "_open_scope_set", None)
        if s is None:
            s = self._open_scope_set = set()
        return s

    def _track(self, h: Handle) -> Handle:
        h._tracked = True
        self._scopes.add(h)
        return h

    def _untrack(self, h: Handle) -> None:
        if h._tracked:
            h._tracked = False
            self._scopes.discard(h)

    def open_scopes(self) -> int:
        """Number of slocked/xlocked scopes not yet released (0 = clean)."""
        return len(self._scopes)

    # -- guarded acquisition ------------------------------------------------
    def slocked(self, gaddr):
        """``h = yield from node.slocked(g)`` — tracked shared scope;
        finish it with ``yield from h.release()``."""
        h = yield from self.slock(gaddr)
        return self._track(h)

    def xlocked(self, gaddr):
        """``h = yield from node.xlocked(g)`` — tracked exclusive scope."""
        h = yield from self.xlock(gaddr)
        return self._track(h)

    def xlocked_many(self, gaddrs):
        """Acquire X latches on ``gaddrs`` in canonical sorted order
        (global deadlock-avoidance order).  Returns ONE handle per
        distinct address, in first-request order — duplicates collapse
        so ``release_all`` never double-releases a latch."""
        by_addr = {}
        for g in sorted(set(gaddrs)):
            by_addr[g] = yield from self.xlocked(g)
        seen = set()
        ordered = []
        for g in gaddrs:
            if g not in seen:
                seen.add(g)
                ordered.append(by_addr[g])
        return ordered

    def release_all(self, handles):
        """Release a batch of handles in reverse acquisition order."""
        for h in reversed(list(handles)):
            yield from h.release()

    # -- whole-scope combinators (cannot leak) ------------------------------
    def with_slock(self, gaddr, body):
        """Run generator ``body(handle)`` under a shared latch; the latch
        is released on every exit path, including exceptions."""
        h = yield from self.slocked(gaddr)
        try:
            result = yield from body(h)
        finally:
            yield from h.release()
        return result

    def with_xlock(self, gaddr, body):
        """Exclusive-latch variant of :meth:`with_slock`."""
        h = yield from self.xlocked(gaddr)
        try:
            result = yield from body(h)
        finally:
            yield from h.release()
        return result
