"""`DevicePlane` — the facade over the flat device coherence plane.

Counterpart of ``repro/core/rounds/plane.py`` for the flat geometry:
``open`` adopts a round state, the verbs ``ops`` / ``rmw`` /
``descent`` / ``txn`` / ``evict`` drive it, and ``ops``, ``rmw`` and
``descent`` each return one :class:`PlaneResult` whose fields are host
numpy arrays, as in the reference (``txn`` returns a
``TxnBatchResult``).  Every verb mutates ``plane.state`` (its leaves in
place), raises ``RuntimeError`` when the round or step bound was hit,
and reports the loop's counters as a typed :class:`PlaneTelemetry`.

Two placement verbs act at op-quiescent boundaries: :meth:`rehome`
(on a flat plane every line already homes on the one shard, so it
validates its arguments and moves nothing, as the reference's flat
plane does) and :meth:`replicate` (marks read-mostly lines and seeds
their replica images).  ``core/rounds/placement.py`` plans both from the
telemetry or a recorder's heat.  Attach an ``obs.FlightRecorder``
(``DevicePlane.open(..., recorder=rec)`` or :meth:`attach_recorder`)
and every verb dispatch appends one span: wall time, rounds, serve
totals and the kernel libraries built or loaded meanwhile (the port's
compile events, ``kernels/_build.LOADS``).  ``ops``, ``rmw``,
``descent`` and ``txn`` end in host copies, so their spans cover the
device work; ``evict`` returns without a sync, so its span is the
dispatch's host time only.

The mesh-sharded plane is queue 1 item 9.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ...kernels import _build
from ...obs import PlaneTelemetry
from .placement import _host


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
    """Facade owning a flat rounds-plane state on one device."""

    def __init__(self, state, *, n_nodes: int | None = None,
                 max_rounds: int = 64, recorder=None):
        self.state = state
        self.n_nodes = (int(state["cache_state"].shape[0])
                        if n_nodes is None else int(n_nodes))
        self.max_rounds = int(max_rounds)
        self.recorder = recorder

    @classmethod
    def open(cls, state, *, n_nodes: int | None = None,
             max_rounds: int = 64, recorder=None) -> "DevicePlane":
        """The one constructor: wrap a round state (``make_state``).
        ``recorder`` optionally attaches an ``obs.FlightRecorder`` that
        receives one span per verb dispatch."""
        return cls(state, n_nodes=n_nodes, max_rounds=max_rounds,
                   recorder=recorder)

    def attach_recorder(self, recorder) -> None:
        """Attach (or replace, or with ``None`` detach) the plane's
        ``obs.FlightRecorder``: spans start or stop with the next verb
        dispatch."""
        self.recorder = recorder

    # ------------------------------------------------------------ geometry
    @property
    def device(self) -> torch.device:
        return self.state["words"].device

    @property
    def n_lines(self) -> int:
        return int(self.state["words"].shape[0])

    @property
    def payload_width(self) -> int:
        from .state import payload_width
        return payload_width(self.state)

    @property
    def write_back(self) -> bool:
        return "dirty" in self.state

    def flat_state(self) -> dict:
        """The state in flat (line-major) layout — the only layout the
        flat plane has."""
        return self.state

    def check(self) -> None:
        """Protocol invariants over the state."""
        from .state import check_invariants
        check_invariants(self.state)

    def _telemetry(self, tele) -> PlaneTelemetry:
        c = {k: v.cpu().numpy() for k, v in tele.items()}
        c["line_hits"] = c.pop("slot_hits")
        c["line_whits"] = c.pop("slot_whits")
        return PlaneTelemetry.from_counters(c)

    def _span_begin(self):
        """Recorder bracket: (wall clock, kernel library loads) or
        None without a recorder."""
        if self.recorder is None:
            return None
        return (time.perf_counter(), _build.LOADS)

    def _span_end(self, verb: str, mark, *, batch=(), rounds: int = 0,
                  telemetry=None, attrs=None) -> None:
        """Close a bracket: append one span to the attached recorder."""
        if mark is None or self.recorder is None:
            return
        t0, c0 = mark
        self.recorder.record(
            verb, duration=time.perf_counter() - t0, batch=batch,
            rounds=rounds, telemetry=telemetry,
            compiled=_build.LOADS - c0, attrs=attrs)

    # ------------------------------------------------------------- verbs
    def ops(self, node_id, line, is_write, wdata=None, *,
            max_rounds: int | None = None) -> PlaneResult:
        """Drive op slots ``(node, line, is_write[, wdata])`` to
        completion through the spin loop."""
        from .driver import run_rounds
        mr = self.max_rounds if max_rounds is None else max_rounds
        mark = self._span_begin()
        state, versions, data, rounds, done, tele = run_rounds(
            self.state, node_id, line, is_write, wdata,
            n_nodes=self.n_nodes, max_rounds=mr)
        self.state = state
        if not done:
            raise RuntimeError(f"ops not served after {mr} rounds")
        res = PlaneResult(versions.cpu().numpy(), data.cpu().numpy(),
                          rounds, {}, self._telemetry(tele))
        self._span_end("ops", mark, batch=(np.shape(line)[0],),
                       rounds=rounds, telemetry=res.telemetry)
        return res

    def rmw(self, node_id, line, *, modify, operands=(),
            max_rounds: int | None = None) -> PlaneResult:
        """Coherent read-modify-write: ``modify(data, line, *operands)``
        runs on the device between the read and the write phase.
        Operands are ``[R, ...]`` row-aligned with the op slots and move
        to the plane's device; ``modify`` must treat ``line = -1`` rows
        as no-ops."""
        from .driver import run_rmw
        mr = self.max_rounds if max_rounds is None else max_rounds
        mark = self._span_begin()
        operands = tuple(torch.as_tensor(op).to(self.device)
                         for op in operands)
        state, versions, data, rounds, done, tele = run_rmw(
            self.state, node_id, line, operands, modify=modify,
            n_nodes=self.n_nodes, max_rounds=mr)
        self.state = state
        if not done:
            raise RuntimeError(f"RMW ops not served after {mr} "
                               f"rounds per phase")
        res = PlaneResult(versions.cpu().numpy(), data.cpu().numpy(),
                          rounds, {}, self._telemetry(tele))
        self._span_end("rmw", mark, batch=(np.shape(line)[0],),
                       rounds=rounds, telemetry=res.telemetry)
        return res

    def descent(self, node_id, key, root, *, transition,
                path_cap: int = 16,
                max_steps: int | None = None) -> PlaneResult:
        """Whole pointer-chase walk: ``transition(data, key) -> (at_leaf,
        hop, nxt)`` advances every slot on the device.  ``data`` is each
        slot's LEAF lanes; ``stats`` carries ``line``, ``levels``,
        ``hops``, ``paths``, ``path_len``; ``rounds`` counts the steps
        (one coherence round each)."""
        from .descent import run_descent
        ms = self.max_rounds if max_steps is None else max_steps
        mark = self._span_begin()
        (state, line, lanes, levels, hops, paths, plen, steps, done,
         tele) = run_descent(self.state, node_id, key, root,
                             transition=transition, n_nodes=self.n_nodes,
                             max_steps=ms, path_cap=path_cap)
        self.state = state
        if not done:
            raise RuntimeError(f"descent did not settle after {ms} "
                               f"steps (broken links?)")
        stats = {"line": line, "levels": levels, "hops": hops,
                 "paths": paths, "path_len": plen}
        res = PlaneResult(None, lanes.cpu().numpy(), steps,
                          {k: v.cpu().numpy() for k, v in stats.items()},
                          self._telemetry(tele))
        self._span_end("descent", mark, batch=(np.shape(root)[0],),
                       rounds=steps, telemetry=res.telemetry)
        return res

    def txn(self, node_id, glines, rmask, wmask, ts, *, algo: str,
            max_iters: int | None = None, max_rounds: int | None = None):
        """Run one transaction batch through the device CC scheduler
        (:mod:`repro_torch.core.rounds.txn`); returns a
        ``TxnBatchResult``."""
        from .txn import run_txn_batch
        mark = self._span_begin()
        res = run_txn_batch(self, node_id, glines, rmask, wmask, ts,
                            algo=algo, max_iters=max_iters,
                            max_rounds=max_rounds)
        self._span_end("txn", mark, batch=tuple(np.shape(glines)),
                       rounds=res.rounds, telemetry=res.telemetry,
                       attrs={"algo": algo})
        return res

    def evict(self, node_id, line) -> None:
        """Evict (node, line) pairs: release holder latches, flushing
        dirty write-back copies first."""
        from .engine import evict_lines
        mark = self._span_begin()
        dev = self.device
        node_id, line = (torch.as_tensor(x).to(device=dev,
                                              dtype=torch.int32)
                         for x in (node_id, line))
        self.state = evict_lines(self.state, node_id, line)
        self._span_end("evict", mark, batch=(np.shape(line)[0],))

    # -------------------------------------------------------- placement
    def rehome(self, lines, new_homes, victims=None) -> int:
        """Migrate ``lines[i]`` to home shard ``new_homes[i]`` (swapping
        slots with ``victims[i]``, as ``plan_rehome`` plans it) through
        the coherent directory, at an op-quiescent boundary.  Returns
        the number of migrations performed.  On this flat plane the one
        shard is every line's home already: the call validates its
        arguments exactly as the reference does (a ``home`` leaf, equal
        lengths, line ids in range, shard ids in ``[0, 1)``) and moves
        nothing, so flat and sharded differentials replay one call
        sequence.  The sharded exchange is queue 1 item 9."""
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
        l, s = self.n_lines, 1
        if lines.size and (lines.min() < 0 or lines.max() >= l):
            raise ValueError(f"line ids out of range [0, {l})")
        if new_homes.size and (new_homes.min() < 0
                               or new_homes.max() >= s):
            raise ValueError(f"home shards out of range [0, {s})")
        return 0

    def replicate(self, lines, *, enable: bool = True) -> None:
        """Mark ``lines`` read-replicated (or drop the mark with
        ``enable=False``), on the plane's device.  Boundary-only, like
        :meth:`rehome`: the replica images of marked lines whose memory
        is current (no exclusive holder) are seeded here from
        ``mem_data``/``mem_version``; the rest seed at the next round
        boundary.  The flat engine refreshes the images every round but
        serves from home; the sharded router that serves S reads from
        them is queue 1 item 9."""
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
        rok = st["replica"] & ~(st["cache_state"] == M).any(dim=0)
        st["replica_ok"].copy_(rok)
        st["replica_version"].copy_(torch.where(
            rok, st["mem_version"], st["replica_version"]))
        if "replica_data" in st:
            st["replica_data"][rok] = st["mem_data"][rok]

    def __repr__(self) -> str:
        return (f"DevicePlane(flat, n_nodes={self.n_nodes}, "
                f"n_lines={self.n_lines}, W={self.payload_width}, "
                f"{'write-back' if self.write_back else 'write-through'}, "
                f"{self.device})")
