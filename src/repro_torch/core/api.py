"""The SELCC abstraction layer — the paper's Table 1 API, v2 surface.

``SELCCLayer`` wires memory servers (Fabric), compute nodes, and a global
allocator into the main-memory-like programming surface the paper argues
for.  The v2 redesign makes the surface typed, data-plane-complete, and
backend-agnostic:

    Allocate / Free          -> typed :class:`GAddr` (NodeID, offset)
    SELCC_SLock / XLock      -> unified :class:`Handle` on every backend
    h.value / h.store(obj)   -> data plane (per-layer :class:`GclHeap`)
    node.slocked / xlocked   -> leak-tracked scope guards (handles.py)
    SELCC_SUnlock / XUnlock  -> ``yield from h.release()``
    Atomic                   -> uint64 fetch-op

Backends plug in through :func:`repro_torch.core.register_protocol`
(core/registry.py): SELCC, SEL, GAM, and the RPC strawman register
themselves at import; ``ClusterConfig(protocol=...)`` resolves by name
with zero dispatch code here.  Applications (apps/btree.py, apps/txn.py)
are written purely against this facade and therefore run over any
registered backend unchanged — the paper's "applications over SELCC can
run seamlessly on SEL", extended to N protocols.

The same address/handle vocabulary reaches the device plane:
:meth:`SELCCLayer.as_rounds_state` and :meth:`SELCCLayer.as_plane` size a
core/rounds state (and its ``DevicePlane``) to the layer's allocation
map under the ``GAddr.flat`` striping — flat, or sharded over a
``mesh`` — and :meth:`SELCCLayer.make_kv_pool` opens the dsm/kvpool.py
serving pool, each on ``cuda`` unless the caller asks for ``"cpu"``.

A copy of ``repro/core/api.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .addressing import GAddr
from .gam import GAMConfig
from .handles import GclHeap
from .protocol import SELCCConfig
from .registry import get_protocol
from .simulator import CostModel, Environment, Fabric


@dataclass
class ClusterConfig:
    n_compute: int = 8
    n_memory: int = 8
    threads_per_node: int = 16
    protocol: str = "selcc"           # any name in available_protocols()
    selcc: Optional[SELCCConfig] = None
    gam: Optional[GAMConfig] = None
    cost: Optional[CostModel] = None
    seed: int = 0

    def __post_init__(self):
        if self.selcc is None:
            self.selcc = SELCCConfig()
        if self.gam is None:
            self.gam = GAMConfig(gcl_bytes=self.selcc.gcl_bytes,
                                 cache_capacity=self.selcc.cache_capacity)
        if self.cost is None:
            self.cost = CostModel()


# Legacy layer.__dict__ side channels (deleted in v2) -> one-release shim
# with a pointed migration message.
_LEGACY_SIDE_CHANNELS = {
    "_btree_content": "payloads now flow through Handle.value/.store() "
                      "backed by SELCCLayer.heap",
    "_btree_root": 'the tree root is published via layer.bind("btree:root", '
                   "gaddr) / layer.binding(\"btree:root\")",
    "_txn_shared": "TxnEngine state now lives in SELCCLayer.heap bindings "
                   '("txn:gcls", "txn:ts") and per-GCL heap records',
}


class SELCCLayer:
    """A simulated cluster exposing the Table-1 v2 API per compute node."""

    def __init__(self, cfg: ClusterConfig | None = None):
        self.cfg = cfg or ClusterConfig()
        c = self.cfg
        spec = get_protocol(c.protocol)
        self.env = Environment()
        self.fabric = Fabric(self.env, c.n_memory, c.cost,
                             mem_cpu_cores=spec.mem_cpu_cores(c))
        # ONE object heap per layer: the data plane every Handle resolves
        # through, shared by all nodes of all backends.  Created (with
        # the allocator state) BEFORE the backend factory runs — build()
        # is promised the fully-constructed layer.
        self.heap = GclHeap()
        self._next_line = [0] * c.n_memory
        self._free: list[GAddr] = []
        self._live: set[GAddr] = set()
        self._rr = 0
        self.agents: list = []            # backend factories may populate
        self.nodes = spec.build(self)
        for n in self.nodes:
            n.heap = self.heap

    def __getattr__(self, name: str):
        hint = _LEGACY_SIDE_CHANNELS.get(name)
        if hint is not None:
            raise AttributeError(
                f"SELCCLayer.{name} was a pre-v2 side channel and no longer "
                f"exists; {hint} (see docs/API.md)")
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    # ------------------------------------------------------------- Table 1
    def allocate(self) -> GAddr:
        """Allocate a global cache line; returns a typed :class:`GAddr`."""
        if self._free:
            g = self._free.pop()
        else:
            mid = self._rr % self.cfg.n_memory
            self._rr += 1
            g = GAddr(mid, self._next_line[mid])
            self._next_line[mid] += 1
        self._live.add(g)
        return g

    def allocate_many(self, n: int) -> list[GAddr]:
        """Batched allocation (one call, n lines — Table 1 ``Allocate``
        with a count, so apps stop looping over the allocator)."""
        return [self.allocate() for _ in range(n)]

    def free(self, gaddr) -> None:
        """Return a line to the allocator.  Rejects double-frees and
        never-allocated addresses instead of corrupting the free list."""
        g = GAddr(*gaddr)
        if g not in self._live:
            if g in self._free:
                raise ValueError(f"double free of {g}")
            raise ValueError(f"free() of never-allocated address {g}")
        self._live.discard(g)
        self._free.append(g)
        self.heap.discard(g)       # a recycled line reads as uninitialized

    def alloc_object(self, obj) -> GAddr:
        """Allocate a line and seed its payload in one step (init-time
        convenience; steady-state writes go through ``Handle.store``)."""
        g = self.allocate()
        self.heap.store(g, obj)
        return g

    def seed_object(self, gaddr, obj) -> None:
        """Install a payload without taking latches — ONLY safe during
        single-threaded setup, before workers start."""
        self.heap.store(GAddr(*gaddr), obj)

    # -------------------------------------------------------- named roots
    def bind(self, name: str, value) -> None:
        """Publish a shared root object/address under a stable name."""
        self.heap.bind(name, value)

    def binding(self, name: str, default=None):
        return self.heap.binding(name, default)

    # lock APIs are per compute node (node.slocked/xlocked/...); composite:
    def run(self, until: float | None = None):
        self.env.run(until)

    # ----------------------------------------------------- leak detection
    def assert_released(self) -> None:
        """Teardown invariant: every slocked/xlocked scope was released
        and no local latch or pin is still held (parity tests)."""
        for n in self.nodes:
            open_n = n.open_scopes()
            if open_n:
                raise AssertionError(
                    f"node {n.node_id}: {open_n} latch scope(s) leaked")
            cache = getattr(n, "cache", None)
            if cache is None:
                continue
            for gaddr, e in cache.entries.items():
                if e.pins or e.latch.held:
                    raise AssertionError(
                        f"node {n.node_id}: entry {gaddr} still "
                        f"pinned/latched at teardown")

    # ------------------------------------------ device-plane interop (facade)
    def gaddr_to_line(self, gaddr) -> int:
        """DES address -> flat device-side line index (striped)."""
        return GAddr(*gaddr).flat(self.cfg.n_memory)

    def line_to_gaddr(self, line: int) -> GAddr:
        return GAddr.from_flat(line, self.cfg.n_memory)

    def as_rounds_state(self, n_lines: int | None = None, *,
                        write_back: bool = False, payload_width: int = 0,
                        mesh=None, axis: str = "shards", device=None):
        """Fresh device-plane round state (core/rounds) sized to this
        layer: same node count, lines spanning every allocation under
        the shared ``GAddr.flat`` striping.  ``write_back=True`` builds
        the dirty-bit variant; ``payload_width=W`` attaches the GCL data
        plane (reads return W int32 payload lanes, the device mirror of
        this layer's ``GclHeap`` objects).  The state lives on
        ``device`` (``cuda`` unless ``"cpu"`` is asked for).

        With a ``mesh`` (:class:`repro_torch.core.rounds.Mesh`) it is the
        sharded plane's state on the mesh's device, ``home = line %
        n_shards`` (the device mirror of this layer's memory-node
        striping), ``n_lines`` padded up to a shard multiple."""
        from .. import resolve_device
        from . import rounds
        if n_lines is None:
            n_lines = max(1, max(self._next_line, default=1)
                          * self.cfg.n_memory)
        if mesh is not None:
            rounds.mesh.shards_of(mesh, axis)
            if device is not None and \
                    resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device={device} but the mesh lives on "
                                 f"{mesh.device}")
            return rounds.make_sharded_state(self.cfg.n_compute, n_lines,
                                             mesh, axis,
                                             write_back=write_back,
                                             payload_width=payload_width)
        return rounds.make_state(self.cfg.n_compute, n_lines,
                                 write_back=write_back,
                                 payload_width=payload_width,
                                 device=device)

    def as_plane(self, n_lines: int | None = None, *,
                 write_back: bool = False, payload_width: int = 0,
                 mesh=None, axis: str = "shards", max_rounds: int = 64,
                 bucket_cap: int | None = None, device=None):
        """Fresh :class:`repro_torch.core.rounds.DevicePlane` sized to
        this layer — ``as_rounds_state`` plus the facade in one call:
        the returned plane owns the state, the mesh and the node count,
        and exposes ``plane.ops`` / ``plane.rmw`` / ``plane.descent`` /
        ``plane.txn``.  This is the ONE bridge from the DES world to
        the device plane."""
        from .rounds.plane import DevicePlane
        state = self.as_rounds_state(n_lines, write_back=write_back,
                                     payload_width=payload_width,
                                     mesh=mesh, axis=axis, device=device)
        return DevicePlane.open(state, mesh, axis=axis,
                                n_nodes=self.cfg.n_compute,
                                max_rounds=max_rounds,
                                bucket_cap=bucket_cap)

    @staticmethod
    def make_kv_pool(kv_cfg=None, mesh=None, device=None):
        """Open a dsm/kvpool.py serving pool on ``device`` (``cuda``
        unless ``"cpu"`` is asked for; with a ``mesh``, on the mesh's
        device, its rounds plane sharded over it); it serves the legacy
        page-copy path until ``pool.open_rounds_plane()``."""
        from ..dsm.kvpool import KVPoolConfig, SELCCKVPool
        return SELCCKVPool(kv_cfg or KVPoolConfig(), mesh=mesh,
                           device=device)

    # ------------------------------------------------------------- metrics
    def throughput(self) -> float:
        ops = sum(n.stats.ops for n in self.nodes)
        return ops / self.env.now if self.env.now > 0 else 0.0

    def total_ops(self) -> int:
        return sum(n.stats.ops for n in self.nodes)

    def mean_latency(self) -> float:
        ops = self.total_ops()
        return (sum(n.stats.latency_sum for n in self.nodes) / ops
                if ops else 0.0)

    def cache_stats(self):
        out = {}
        for n in self.nodes:
            cs = getattr(n, "cache", None)
            if cs is None:
                continue
            s = cs.stats
            for k, v in vars(s).items():
                out[k] = out.get(k, 0) + v
        return out

    def inv_ratio(self) -> float:
        """Invalidation messages per operation (the bar series in the
        paper's Fig. 7).  Deliberately UNclamped: a value above 1.0 is an
        accounting bug (or a resend storm) that tests must catch, not a
        number to silently round down — see test_protocol.py."""
        ops = self.total_ops()
        sent = sum(getattr(n.stats, "inv_sent", 0) for n in self.nodes)
        return sent / ops if ops else 0.0
