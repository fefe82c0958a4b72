"""The device coherence engine (bulk-synchronous rounds plane).

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
(``coherence_round``).  The sharded plane takes a :class:`Mesh` of S
home shards on one device::

    mesh = Mesh(4)                                 # device="cpu" to test
    state = make_sharded_state(n_nodes, n_lines, mesh[, ...])
    plane = DevicePlane.open(state, mesh[, bucket_cap=c])

with the same verbs (and ``run_rounds_sharded`` / ``run_rmw_sharded`` /
``run_descent_sharded`` / ``run_txn_rounds_sharded`` /
``evict_lines_sharded`` / ``rehome_exchange`` underneath).  The
placement verbs ``plane.rehome`` / ``plane.replicate`` take their picks
from :mod:`.placement` (``plan_rehome`` / ``plan_replication``) over
the telemetry or the EWMA heat of an attached ``obs.FlightRecorder``
(``DevicePlane.open(state, recorder=rec)``: one span per dispatch).
``stripe_state`` / ``unstripe_state`` (``shard_state`` /
``unshard_state`` with a mesh) convert a state to and from the sharded
plane's physical-slot layout.
"""

from ...obs import FlightRecorder, PlaneTelemetry
from ..coherence import I, M, S
from .descent import run_descent
from .driver import run_rmw, run_rounds
from .engine import TRACE_COUNTS, coherence_round, evict_lines
from .mesh import Mesh
from .placement import plan_rehome, plan_replication
from .plane import DevicePlane, PlaneResult
from .sharded import (coherence_round_sharded, evict_lines_sharded,
                      gather_state, lines_of, make_sharded_state, pad_ops,
                      read_rows, rehome_exchange, run_descent_sharded,
                      run_rmw_sharded, run_rounds_sharded, shard_state,
                      unshard_state)
from .state import (GLOBAL_LEAVES, LINE_AXIS, check_invariants,
                    is_write_back, make_state, payload_width,
                    stripe_state, unstripe_state)
from .txn import (TxnBatchResult, run_txn_batch, run_txn_rounds,
                  run_txn_rounds_sharded, txn_payload_width)

__all__ = [
    "I", "S", "M", "DevicePlane", "FlightRecorder", "GLOBAL_LEAVES",
    "LINE_AXIS", "Mesh", "PlaneResult", "PlaneTelemetry", "TRACE_COUNTS",
    "TxnBatchResult", "check_invariants", "coherence_round",
    "coherence_round_sharded", "evict_lines", "evict_lines_sharded",
    "gather_state", "lines_of", "read_rows",
    "is_write_back", "make_sharded_state", "make_state", "pad_ops",
    "payload_width", "plan_rehome", "plan_replication", "rehome_exchange",
    "run_descent", "run_descent_sharded", "run_rmw", "run_rmw_sharded",
    "run_rounds", "run_rounds_sharded", "run_txn_batch", "run_txn_rounds",
    "run_txn_rounds_sharded", "shard_state", "stripe_state",
    "txn_payload_width", "unshard_state", "unstripe_state",
]
