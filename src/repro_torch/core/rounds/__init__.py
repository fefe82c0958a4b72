"""The device coherence engine (bulk-synchronous rounds plane), flat.

Counterpart of ``repro/core/rounds``:

    state = make_state(n_nodes, n_lines[, write_back=True]
                       [, payload_width=W], device="cuda")
    plane = DevicePlane.open(state)
    res = plane.ops(nodes, lines, is_write[, wdata])     # PlaneResult
    res = plane.rmw(nodes, lines, modify=fn, operands=(...))
    res = plane.descent(nodes, keys, roots, transition=step)
    out = plane.txn(nodes, glines, rmask, wmask, ts, algo="2pl")

or the drivers underneath (``run_rounds`` / ``run_rmw`` /
``run_descent`` / ``run_txn_rounds``) and a single round
(``coherence_round``).  The placement verbs ``plane.rehome`` /
``plane.replicate`` take their picks from :mod:`.placement`
(``plan_rehome`` / ``plan_replication``) over the telemetry or the
EWMA heat of an attached ``obs.FlightRecorder``
(``DevicePlane.open(state, recorder=rec)``: one span per dispatch).
``stripe_state`` / ``unstripe_state`` convert a state to and from the
sharded plane's physical-slot layout; the sharded plane itself is
queue 1 item 9.
"""

from ...obs import FlightRecorder, PlaneTelemetry
from ..coherence import I, M, S
from .descent import run_descent
from .driver import run_rmw, run_rounds
from .engine import TRACE_COUNTS, coherence_round, evict_lines
from .placement import plan_rehome, plan_replication
from .plane import DevicePlane, PlaneResult
from .state import (GLOBAL_LEAVES, LINE_AXIS, check_invariants,
                    is_write_back, make_state, payload_width,
                    stripe_state, unstripe_state)
from .txn import TxnBatchResult, run_txn_batch, run_txn_rounds, \
    txn_payload_width

__all__ = [
    "I", "S", "M", "DevicePlane", "FlightRecorder", "GLOBAL_LEAVES",
    "LINE_AXIS", "PlaneResult", "PlaneTelemetry", "TRACE_COUNTS",
    "TxnBatchResult", "check_invariants", "coherence_round",
    "evict_lines", "is_write_back", "make_state", "payload_width",
    "plan_rehome", "plan_replication", "run_descent", "run_rmw",
    "run_rounds", "run_txn_batch", "run_txn_rounds", "stripe_state",
    "txn_payload_width", "unstripe_state",
]
