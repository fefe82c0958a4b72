"""`DevicePlane` — the facade over the flat device coherence plane.

Counterpart of ``repro/core/rounds/plane.py`` for the flat geometry:
``open`` adopts a round state, the verbs ``ops`` / ``rmw`` /
``descent`` / ``txn`` / ``evict`` drive it, and ``ops``, ``rmw`` and
``descent`` each return one :class:`PlaneResult` whose fields are host
numpy arrays, as in the reference (``txn`` returns a
``TxnBatchResult``).  Every verb mutates ``plane.state`` (its leaves in
place), raises ``RuntimeError`` when the round or step bound was hit,
and reports the loop's counters as a typed :class:`PlaneTelemetry`.

Not ported yet: the mesh-sharded plane, ``rehome``, ``replicate`` and
the flight-recorder spans.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ...obs import PlaneTelemetry


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
                 max_rounds: int = 64):
        self.state = state
        self.n_nodes = (int(state["cache_state"].shape[0])
                        if n_nodes is None else int(n_nodes))
        self.max_rounds = int(max_rounds)

    @classmethod
    def open(cls, state, *, n_nodes: int | None = None,
             max_rounds: int = 64) -> "DevicePlane":
        """The one constructor: wrap a round state (``make_state``)."""
        return cls(state, n_nodes=n_nodes, max_rounds=max_rounds)

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

    # ------------------------------------------------------------- verbs
    def ops(self, node_id, line, is_write, wdata=None, *,
            max_rounds: int | None = None) -> PlaneResult:
        """Drive op slots ``(node, line, is_write[, wdata])`` to
        completion through the spin loop."""
        from .driver import run_rounds
        mr = self.max_rounds if max_rounds is None else max_rounds
        state, versions, data, rounds, done, tele = run_rounds(
            self.state, node_id, line, is_write, wdata,
            n_nodes=self.n_nodes, max_rounds=mr)
        self.state = state
        if not done:
            raise RuntimeError(f"ops not served after {mr} rounds")
        return PlaneResult(versions.cpu().numpy(), data.cpu().numpy(),
                           rounds, {}, self._telemetry(tele))

    def rmw(self, node_id, line, *, modify, operands=(),
            max_rounds: int | None = None) -> PlaneResult:
        """Coherent read-modify-write: ``modify(data, line, *operands)``
        runs on the device between the read and the write phase.
        Operands are ``[R, ...]`` row-aligned with the op slots and move
        to the plane's device; ``modify`` must treat ``line = -1`` rows
        as no-ops."""
        from .driver import run_rmw
        mr = self.max_rounds if max_rounds is None else max_rounds
        operands = tuple(torch.as_tensor(op).to(self.device)
                         for op in operands)
        state, versions, data, rounds, done, tele = run_rmw(
            self.state, node_id, line, operands, modify=modify,
            n_nodes=self.n_nodes, max_rounds=mr)
        self.state = state
        if not done:
            raise RuntimeError(f"RMW ops not served after {mr} "
                               f"rounds per phase")
        return PlaneResult(versions.cpu().numpy(), data.cpu().numpy(),
                           rounds, {}, self._telemetry(tele))

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
        return PlaneResult(None, lanes.cpu().numpy(), steps,
                           {k: v.cpu().numpy() for k, v in stats.items()},
                           self._telemetry(tele))

    def txn(self, node_id, glines, rmask, wmask, ts, *, algo: str,
            max_iters: int | None = None, max_rounds: int | None = None):
        """Run one transaction batch through the device CC scheduler
        (:mod:`repro_torch.core.rounds.txn`); returns a
        ``TxnBatchResult``."""
        from .txn import run_txn_batch
        return run_txn_batch(self, node_id, glines, rmask, wmask, ts,
                             algo=algo, max_iters=max_iters,
                             max_rounds=max_rounds)

    def evict(self, node_id, line) -> None:
        """Evict (node, line) pairs: release holder latches, flushing
        dirty write-back copies first."""
        from .engine import evict_lines
        dev = self.device
        node_id, line = (torch.as_tensor(x).to(device=dev,
                                              dtype=torch.int32)
                         for x in (node_id, line))
        self.state = evict_lines(self.state, node_id, line)

    def __repr__(self) -> str:
        return (f"DevicePlane(flat, n_nodes={self.n_nodes}, "
                f"n_lines={self.n_lines}, W={self.payload_width}, "
                f"{'write-back' if self.write_back else 'write-through'}, "
                f"{self.device})")
