"""`DevicePlane` — the facade over the device coherence plane.

Counterpart of ``repro/core/rounds/plane.py``: ``open`` adopts a round
state, flat or sharded over a :class:`~repro_torch.core.rounds.mesh.Mesh`
(``DevicePlane.open(state, mesh)``; the sharded drivers of
:mod:`.sharded` then carry every verb, with slots padded to the shard
count and results sliced back), the verbs ``ops`` / ``rmw`` /
``descent`` / ``txn`` / ``evict`` drive it, and ``ops``, ``rmw`` and
``descent`` each return one :class:`PlaneResult` whose fields are host
numpy arrays, as in the reference (``txn`` returns a
``TxnBatchResult``).  Every verb mutates ``plane.state`` (its leaves in
place), raises ``RuntimeError`` when the round or step bound was hit,
and reports the loop's counters as a typed :class:`PlaneTelemetry`.

Two placement verbs act at op-quiescent boundaries: :meth:`rehome`
(pairwise slot swaps moved by ``sharded.rehome_exchange``; on a flat
plane every line already homes on the one shard, so it validates its
arguments and moves nothing, as the reference's flat plane does) and
:meth:`replicate` (marks read-mostly lines and seeds their replica
images from the unsharded image, in place).
``core/rounds/placement.py`` plans both from the telemetry or a
recorder's heat.  Attach an ``obs.FlightRecorder``
(``DevicePlane.open(..., recorder=rec)`` or :meth:`attach_recorder`)
and every verb dispatch appends one span: wall time, rounds, serve
totals and the kernel libraries built or loaded meanwhile (the port's
compile events, ``kernels/_build.LOADS``).  ``ops``, ``rmw``,
``descent`` and ``txn`` end in host copies, so their spans cover the
device work; ``evict`` returns without a sync, so its span is the
dispatch's host time only.

The layer spans (``obs.span``; nothing while tracing is off): each verb
is ``plane.<verb>``, opened by the same bracket (:class:`_Verb`) that
feeds the recorder; its copies of
results to the host are ``plane.result_copy`` (the first also waits for
the rounds still queued on the device) and its telemetry's
``plane.telemetry_copy``.  Counters: ``plane.host_reads`` (one a
blocking read of a device tensor, here and in the drivers' spin checks,
whatever the device) and ``plane.telemetry_bytes`` (the telemetry a
verb copies).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ...kernels import _build
from ...obs import PlaneTelemetry, count, span
from .placement import _host


def _to_host(*tensors) -> list:
    """Host numpy copies of device tensors: blocking reads, each one
    ``plane.host_reads``."""
    count("plane.host_reads", len(tensors))
    return [t.cpu().numpy() for t in tensors]


class _Verb:
    """One verb's bracket: the layer span ``plane.<verb>`` and, with a
    recorder attached, one recorder span when the body returns (wall
    time, kernel library loads meanwhile, and the rounds and telemetry
    of the result the body sets as ``result``)."""

    __slots__ = ("plane", "verb", "batch", "attrs", "result", "mark",
                 "span")

    def __init__(self, plane, verb: str, *, batch=(), attrs=None):
        self.plane = plane
        self.verb = verb
        self.batch = batch
        self.attrs = attrs
        self.result = None

    def __enter__(self) -> "_Verb":
        self.mark = None if self.plane.recorder is None \
            else (time.perf_counter(), _build.LOADS)
        self.span = span("plane." + self.verb)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        if exc[0] is None and self.mark is not None:
            t0, c0 = self.mark
            res = self.result
            self.plane.recorder.record(
                self.verb, duration=time.perf_counter() - t0,
                batch=self.batch, rounds=0 if res is None else res.rounds,
                telemetry=None if res is None else res.telemetry,
                compiled=_build.LOADS - c0, attrs=self.attrs)
        return False


@dataclass(frozen=True)
class PlaneResult:
    """Result of a DevicePlane verb: per-slot ``version`` [R] and
    payload ``data`` [R, W] (host numpy), the coherence ``rounds`` the
    loop spent (summed over phases), verb-specific ``stats`` and the
    loop's :class:`PlaneTelemetry`."""

    version: np.ndarray | None
    data: np.ndarray | None
    rounds: int
    stats: dict = field(default_factory=dict)
    telemetry: PlaneTelemetry | None = None


class DevicePlane:
    """Facade owning a rounds-plane state, flat or sharded over a
    :class:`~repro_torch.core.rounds.mesh.Mesh` on the state's device."""

    def __init__(self, state, mesh=None, *, axis: str = "shards",
                 n_nodes: int | None = None, max_rounds: int = 64,
                 bucket_cap: int | None = None, recorder=None):
        if mesh is not None:
            from .mesh import check_on_mesh, shards_of
            from .sharded import lines_of
            n = shards_of(mesh, axis)
            check_on_mesh(state, mesh)
            n_lines = lines_of(state, mesh, axis)
            if n_lines % n:
                raise ValueError(f"n_lines={n_lines} not divisible by "
                                 f"n_shards={n}")
        self.state = state
        self.mesh = mesh
        self.axis = axis
        self.n_nodes = (int(state["cache_state"].shape[0])
                        if n_nodes is None else int(n_nodes))
        self.max_rounds = int(max_rounds)
        self.bucket_cap = bucket_cap
        self.recorder = recorder

    @classmethod
    def open(cls, state, mesh=None, *, axis: str = "shards",
             n_nodes: int | None = None, max_rounds: int = 64,
             bucket_cap: int | None = None,
             recorder=None) -> "DevicePlane":
        """The one constructor: wrap a round state (``make_state``, or
        ``make_sharded_state`` / ``shard_state`` with its ``mesh``).
        ``bucket_cap`` bounds a sharded round's (source, home) buckets
        (default: a shard's slot count, which never overflows);
        ``recorder`` optionally attaches an ``obs.FlightRecorder`` that
        receives one span per verb dispatch."""
        return cls(state, mesh, axis=axis, n_nodes=n_nodes,
                   max_rounds=max_rounds, bucket_cap=bucket_cap,
                   recorder=recorder)

    def attach_recorder(self, recorder) -> None:
        """Attach (or replace, or with ``None`` detach) the plane's
        ``obs.FlightRecorder``: spans start or stop with the next verb
        dispatch."""
        self.recorder = recorder

    # ------------------------------------------------------------ geometry
    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis] if self.sharded else 1

    @property
    def device(self) -> torch.device:
        return self.state["words"].device

    @property
    def n_lines(self) -> int:
        """Lines of the whole plane (over ranks, not just this rank's
        slabs)."""
        from .sharded import lines_of
        return lines_of(self.state, self.mesh, self.axis)

    @property
    def payload_width(self) -> int:
        from .state import payload_width
        return payload_width(self.state)

    @property
    def write_back(self) -> bool:
        return "dirty" in self.state

    def flat_state(self) -> dict:
        """The state in flat (line-major) layout: a sharded state
        unstriped (copies), the flat plane's own state otherwise."""
        if self.sharded:
            from .sharded import unshard_state
            return unshard_state(self.state, self.mesh, self.axis)
        return self.state

    def _positions(self) -> torch.Tensor:
        """Row of each line id in the shard-major slab concatenation."""
        from .state import slot_positions
        perm = self.state.get("home")
        if perm is None:
            perm = torch.arange(self.n_lines, device=self.device)
        return slot_positions(perm.long(), self.n_shards)

    def check(self) -> None:
        """Protocol invariants over the state."""
        from .state import check_invariants
        check_invariants(self.flat_state())

    def _telemetry(self, tele) -> PlaneTelemetry:
        """A driver's counter dict as a :class:`PlaneTelemetry`; a
        sharded plane's per-slot hits come back in slab-concatenation
        order and are remapped to line ids through the directory.  The
        layer span ``plane.telemetry_copy``."""
        with span("plane.telemetry_copy"):
            if self.sharded:
                pos = self._positions()
                tele = dict(tele, slot_hits=tele["slot_hits"][pos],
                            slot_whits=tele["slot_whits"][pos])
            c = dict(zip(tele, _to_host(*tele.values())))
            count("plane.telemetry_bytes", sum(a.nbytes for a in c.values()))
        c["line_hits"] = c.pop("slot_hits")
        c["line_whits"] = c.pop("slot_whits")
        return PlaneTelemetry.from_counters(c)

    def _sharded_kw(self) -> dict:
        return {"mesh": self.mesh, "axis": self.axis,
                "bucket_cap": self.bucket_cap}

    # ------------------------------------------------------------- verbs
    def ops(self, node_id, line, is_write, wdata=None, *,
            max_rounds: int | None = None) -> PlaneResult:
        """Drive op slots ``(node, line, is_write[, wdata])`` to
        completion through the spin loop."""
        mr = self.max_rounds if max_rounds is None else max_rounds
        r = np.shape(line)[0]
        with _Verb(self, "ops", batch=(r,)) as v:
            if self.sharded:
                from .sharded import pad_ops, run_rounds_sharded
                ops = pad_ops(node_id, line, is_write, self.n_shards, wdata)
                state, versions, data, rounds, done, tele = \
                    run_rounds_sharded(self.state, *ops,
                                       n_nodes=self.n_nodes, max_rounds=mr,
                                       **self._sharded_kw())
            else:
                from .driver import run_rounds
                state, versions, data, rounds, done, tele = run_rounds(
                    self.state, node_id, line, is_write, wdata,
                    n_nodes=self.n_nodes, max_rounds=mr)
            self.state = state
            if not done:
                raise RuntimeError(f"ops not served after {mr} rounds")
            with span("plane.result_copy"):
                versions, data = _to_host(versions[:r], data[:r])
            res = v.result = PlaneResult(versions, data, rounds, {},
                                         self._telemetry(tele))
        return res

    def rmw(self, node_id, line, *, modify, operands=(),
            max_rounds: int | None = None) -> PlaneResult:
        """Coherent read-modify-write: ``modify(data, line, *operands)``
        runs on the device between the read and the write phase.
        Operands are ``[R, ...]`` row-aligned with the op slots and move
        to the plane's device; ``modify`` must treat ``line = -1`` rows
        as no-ops."""
        mr = self.max_rounds if max_rounds is None else max_rounds
        r = np.shape(line)[0]
        with _Verb(self, "rmw", batch=(r,)) as v:
            operands = tuple(torch.as_tensor(op).to(self.device)
                             for op in operands)
            if self.sharded:
                from .sharded import pad_ops, run_rmw_sharded
                node_id, line, _ = pad_ops(node_id, line,
                                           np.zeros(r, np.int32),
                                           self.n_shards)
                pad = line.shape[0] - r
                operands = tuple(
                    torch.cat([op, op.new_zeros((pad,)
                                                + tuple(op.shape[1:]))])
                    for op in operands) if pad else operands
                state, versions, data, rounds, done, tele = \
                    run_rmw_sharded(self.state, node_id, line, operands,
                                    modify=modify, n_nodes=self.n_nodes,
                                    max_rounds=mr, **self._sharded_kw())
            else:
                from .driver import run_rmw
                state, versions, data, rounds, done, tele = run_rmw(
                    self.state, node_id, line, operands, modify=modify,
                    n_nodes=self.n_nodes, max_rounds=mr)
            self.state = state
            if not done:
                raise RuntimeError(f"RMW ops not served after {mr} "
                                   f"rounds per phase")
            with span("plane.result_copy"):
                versions, data = _to_host(versions[:r], data[:r])
            res = v.result = PlaneResult(versions, data, rounds, {},
                                         self._telemetry(tele))
        return res

    def descent(self, node_id, key, root, *, transition,
                path_cap: int = 16,
                max_steps: int | None = None) -> PlaneResult:
        """Whole pointer-chase walk: ``transition(data, key) -> (at_leaf,
        hop, nxt)`` advances every slot on the device.  ``data`` is each
        slot's LEAF lanes; ``stats`` carries ``line``, ``levels``,
        ``hops``, ``paths``, ``path_len``; ``rounds`` counts the steps
        (one coherence round each)."""
        ms = self.max_rounds if max_steps is None else max_steps
        r = np.shape(root)[0]
        with _Verb(self, "descent", batch=(r,)) as v:
            if self.sharded:
                from .sharded import pad_ops, run_descent_sharded
                node_id, root, key = pad_ops(node_id, root, key,
                                             self.n_shards)
                (state, line, lanes, levels, hops, paths, plen, steps, done,
                 tele) = run_descent_sharded(
                    self.state, node_id, key, root, transition=transition,
                    n_nodes=self.n_nodes, max_steps=ms, path_cap=path_cap,
                    **self._sharded_kw())
            else:
                from .descent import run_descent
                (state, line, lanes, levels, hops, paths, plen, steps, done,
                 tele) = run_descent(self.state, node_id, key, root,
                                     transition=transition,
                                     n_nodes=self.n_nodes, max_steps=ms,
                                     path_cap=path_cap)
            self.state = state
            if not done:
                raise RuntimeError(f"descent did not settle after {ms} "
                                   f"steps (broken links?)")
            stats = {"line": line, "levels": levels, "hops": hops,
                     "paths": paths, "path_len": plen}
            with span("plane.result_copy"):
                lanes, *host = _to_host(lanes[:r], *(t[:r] for t in
                                                     stats.values()))
            res = v.result = PlaneResult(None, lanes, steps,
                                         dict(zip(stats, host)),
                                         self._telemetry(tele))
        return res

    def txn(self, node_id, glines, rmask, wmask, ts, *, algo: str,
            max_iters: int | None = None, max_rounds: int | None = None):
        """Run one transaction batch through the device CC scheduler
        (:mod:`repro_torch.core.rounds.txn`); returns a
        ``TxnBatchResult``."""
        from .txn import run_txn_batch
        with _Verb(self, "txn", batch=tuple(np.shape(glines)),
                   attrs={"algo": algo}) as v:
            res = v.result = run_txn_batch(
                self, node_id, glines, rmask, wmask, ts, algo=algo,
                max_iters=max_iters, max_rounds=max_rounds)
        return res

    def evict(self, node_id, line) -> None:
        """Evict (node, line) pairs: release holder latches, flushing
        dirty write-back copies first."""
        r = np.shape(line)[0]
        with _Verb(self, "evict", batch=(r,)):
            dev = self.device
            node_id, line = (torch.as_tensor(x).to(device=dev,
                                                  dtype=torch.int32)
                             for x in (node_id, line))
            if self.sharded:
                from .sharded import evict_lines_sharded, pad_ops
                node_id, line, _ = pad_ops(node_id, line,
                                           torch.zeros_like(line),
                                           self.n_shards)
                self.state = evict_lines_sharded(
                    self.state, node_id, line, mesh=self.mesh,
                    axis=self.axis, bucket_cap=self.bucket_cap)
            else:
                from .engine import evict_lines
                self.state = evict_lines(self.state, node_id, line)

    # -------------------------------------------------------- placement
    def rehome(self, lines, new_homes, victims=None) -> int:
        """Migrate ``lines[i]`` to home shard ``new_homes[i]`` through
        the coherent directory, at an op-quiescent boundary: pairwise
        SLOT SWAPS with a victim line homed on the target shard
        (``victims[i]``, as ``plan_rehome`` plans it, or else the
        highest-id line still homed there), moved by
        :func:`~.sharded.rehome_exchange`.  Lines already on their
        target, or named twice, are skipped.  Returns the number of
        migrations performed.  On a flat plane the one shard is every
        line's home already: the call validates its arguments exactly as
        the reference does (shard ids in ``[0, 1)``) and moves nothing,
        so flat and sharded differentials replay one call sequence."""
        if "home" not in self.state:
            raise ValueError(
                "rehome needs a home-directory state "
                "(make_state(..., home_directory=True))")
        lines = np.asarray(_host(lines), np.int64).reshape(-1)
        new_homes = np.asarray(_host(new_homes), np.int64).reshape(-1)
        if lines.shape != new_homes.shape:
            raise ValueError("lines and new_homes must match in length")
        if victims is not None:
            victims = np.asarray(_host(victims), np.int64).reshape(-1)
            if victims.shape != lines.shape:
                raise ValueError("victims must match lines in length")
        l, s = self.n_lines, self.n_shards
        if lines.size and (lines.min() < 0 or lines.max() >= l):
            raise ValueError(f"line ids out of range [0, {l})")
        if new_homes.size and (new_homes.min() < 0
                               or new_homes.max() >= s):
            raise ValueError(f"home shards out of range [0, {s})")
        if not self.sharded:
            return 0
        perm = _host(self.state["home"]).astype(np.int64)
        taken: set = set()
        src, dst = [], []
        for i in range(lines.size):
            a, h = int(lines[i]), int(new_homes[i])
            if a in taken or perm[a] % s == h:
                continue
            if victims is not None:
                b = int(victims[i])
                if b in taken or b == a or perm[b] % s != h:
                    continue
            else:
                cands = [int(c) for c in np.flatnonzero(perm % s == h)[::-1]
                         if int(c) not in taken]
                if not cands:
                    continue
                b = cands[0]
            taken.update((a, b))
            src.extend((perm[a], perm[b]))
            dst.extend((perm[b], perm[a]))
            perm[a], perm[b] = perm[b], perm[a]
        if not src:
            return 0
        from .sharded import rehome_exchange
        self.state = rehome_exchange(
            self.state, np.asarray(src), np.asarray(dst),
            perm.astype(np.int32), mesh=self.mesh, axis=self.axis)
        return len(taken) // 2

    def replicate(self, lines, *, enable: bool = True) -> None:
        """Mark ``lines`` read-replicated (or drop the mark with
        ``enable=False``), in place on the plane's device.
        Boundary-only, like :meth:`rehome`: the replica images of marked
        lines whose memory is current (no exclusive holder) are seeded
        here from the unsharded image of ``mem_data`` / ``mem_version``;
        the rest seed at the next round boundary.  A sharded plane then
        serves S-latch reads of a marked line with a valid image at the
        requester's own shard; the flat engine refreshes the images
        every round but serves from home."""
        if "replica" not in self.state:
            raise ValueError(
                "replicate needs a replica-plane state "
                "(make_state(..., replicas=True))")
        from ..coherence import M
        lines = np.asarray(_host(lines), np.int64).reshape(-1)
        l = self.n_lines
        if lines.size and (lines.min() < 0 or lines.max() >= l):
            raise ValueError(f"line ids out of range [0, {l})")
        st = self.state
        st["replica"][torch.from_numpy(lines).to(self.device)] = \
            bool(enable)
        held_m = (st["cache_state"] == M).any(dim=0)
        mver, mdata = st["mem_version"], st.get("mem_data")
        if self.sharded:                 # the unsharded image, by line id
            from .sharded import gather_state
            pos = self._positions()
            if self.mesh.ranked:
                held_m = self.mesh.all_gather(held_m.to(torch.uint8)).bool()
            img = gather_state(st, self.mesh, self.axis,
                               ("mem_version",) + (("mem_data",)
                                                   if mdata is not None
                                                   else ()))
            held_m, mver = held_m[pos], img["mem_version"][pos]
            mdata = None if mdata is None else img["mem_data"][pos]
        rok = st["replica"] & ~held_m
        st["replica_ok"].copy_(rok)
        st["replica_version"].copy_(torch.where(
            rok, mver, st["replica_version"]))
        if "replica_data" in st:
            st["replica_data"][rok] = mdata[rok]

    def __repr__(self) -> str:
        geo = f"sharded x{self.n_shards}" if self.sharded else "flat"
        return (f"DevicePlane({geo}, n_nodes={self.n_nodes}, "
                f"n_lines={self.n_lines}, W={self.payload_width}, "
                f"{'write-back' if self.write_back else 'write-through'}, "
                f"{self.device})")
