"""The device coherence engine (bulk-synchronous rounds plane), flat.

Counterpart of ``repro/core/rounds``:

    state = make_state(n_nodes, n_lines[, write_back=True]
                       [, payload_width=W], device="cuda")
    plane = DevicePlane.open(state)
    res = plane.ops(nodes, lines, is_write[, wdata])     # PlaneResult
    res = plane.rmw(nodes, lines, modify=fn, operands=(...))

or the drivers underneath (``run_rounds`` / ``run_rmw``) and a single
round (``coherence_round``).  The mesh-sharded plane, the fused
descent and the device transactions are not ported yet.
"""

from ..coherence import I, M, S
from .driver import run_rmw, run_rounds
from .engine import TRACE_COUNTS, coherence_round, evict_lines
from .plane import DevicePlane, PlaneResult
from .state import check_invariants, is_write_back, make_state, \
    payload_width

__all__ = [
    "I", "S", "M", "DevicePlane", "PlaneResult", "TRACE_COUNTS",
    "check_invariants", "coherence_round", "evict_lines",
    "is_write_back", "make_state", "payload_width", "run_rmw",
    "run_rounds",
]
