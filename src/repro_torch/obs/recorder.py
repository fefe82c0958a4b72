"""`FlightRecorder` — the plane's bounded span ring + exporters.

One :class:`Span` per verb dispatch (ops/rmw/descent/txn/evict —
appended by ``DevicePlane`` when a recorder is attached): verb, batch
shape, coherence rounds, served/deferred totals from the dispatch's
:class:`~repro_torch.obs.telemetry.PlaneTelemetry`, wall time, a
monotonic dispatch index, and the number of compile events the dispatch
triggered.  In the port a compile event is a kernel library that
``kernels/_build.py`` built or loaded during the dispatch (the first use
of a kernel: the counterpart of the reference's jit traces, which it
counts as the ``engine.TRACE_COUNTS`` delta; the port's
``TRACE_COUNTS`` counts round executions instead).  The recorder itself
never touches the loops, so it adds no kernel and no build.

The ring is bounded (oldest spans drop; ``recorder.dropped`` counts
them) — a serving loop can run forever without the recorder growing.
Alongside the ring the recorder owns:

* a :class:`~repro_torch.obs.metrics.MetricsRegistry` — dispatch/round/
  compile counters and per-verb wall-time histograms, rendered with
  ``recorder.registry.render_prom()``;
* per-line and per-home :class:`~repro_torch.obs.metrics.EwmaHeat`, updated
  from every dispatch's telemetry — the signal
  ``placement.plan_rehome`` / ``plan_replication`` consume for ONLINE
  placement from inside a serving loop (no raw stats plumbing).

Exporters: :meth:`export_chrome_trace` writes Chrome-trace/Perfetto
JSON (open a serving run in ``chrome://tracing`` / ui.perfetto.dev);
:meth:`snapshot` folds the whole recorder into a plain dict for
``BENCH_*.json`` ``meta.telemetry``.

A copy of ``repro/obs/recorder.py``, but for what ``compiled`` counts.
"""

from __future__ import annotations

import json
import time
from typing import NamedTuple

import numpy as np

from .metrics import EwmaHeat, MetricsRegistry

__all__ = ["Span", "FlightRecorder"]


class Span(NamedTuple):
    """One verb dispatch through the plane.  A NamedTuple, not a
    dataclass: construction sits on the dispatch hot path and the
    C-level tuple ``__new__`` is ~10x cheaper than frozen-dataclass
    ``object.__setattr__`` per field."""

    index: int                 # monotonic dispatch number
    verb: str                  # ops | rmw | descent | txn | evict | ...
    ts: float                  # seconds since the recorder's epoch
    dur: float                 # wall seconds
    batch: tuple               # dispatch batch shape
    rounds: int                # coherence rounds/steps the loop spent
    served: int                # ops served (home + replica)
    deferred: int              # bucket-overflow defers
    replica_served: int        # replica-path serves
    compiled: int              # kernel libraries built/loaded meanwhile
    attrs: dict = {}           # callers pass a fresh dict (record does)

    def to_chrome_event(self) -> dict:
        """Chrome-trace 'complete' event (ph=X, microsecond units)."""
        args = {"rounds": self.rounds, "served": self.served,
                "deferred": self.deferred,
                "replica_served": self.replica_served,
                "batch": list(self.batch), "dispatch": self.index}
        if self.compiled:
            args["compiled"] = self.compiled
        args.update(self.attrs)
        return {"name": self.verb, "cat": "plane", "ph": "X",
                "ts": self.ts * 1e6, "dur": max(self.dur, 1e-9) * 1e6,
                "pid": 0, "tid": 0, "args": args}


class FlightRecorder:
    """Bounded host-side span ring + metrics + EWMA heat."""

    def __init__(self, capacity: int = 1024, *, alpha: float = 0.3,
                 registry: MetricsRegistry | None = None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} < 1")
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._ring: list[Span | None] = [None] * self.capacity
        self._total = 0                     # spans ever recorded
        self._epoch = time.perf_counter()
        self._line_heat: EwmaHeat | None = None
        self._home_heat: EwmaHeat | None = None
        # per-verb metric handles, resolved once — record() sits on the
        # dispatch path, so it must not pay registry lookup + label-key
        # sorting on every span
        self._verb_metrics: dict = {}

    # ----------------------------------------------------------- clock
    def now(self) -> float:
        """Seconds since the recorder's epoch (span timebase)."""
        return time.perf_counter() - self._epoch

    # ---------------------------------------------------------- record
    def record(self, verb: str, *, duration: float, batch=(),
               rounds: int = 0, telemetry=None, compiled: int = 0,
               ts: float | None = None, attrs: dict | None = None
               ) -> Span:
        """Append one span; update metrics and heat.  ``telemetry`` is
        the dispatch's ``PlaneTelemetry`` (or None for verbs that have
        none, e.g. evict); ``ts`` defaults to now - duration."""
        served = deferred = rserved = 0
        if telemetry is not None:
            sph = telemetry.served_per_home
            if sph.shape[0] == 1:
                # flat plane: every reduction is over one cell —
                # .item() skips the ufunc-reduce machinery entirely
                rserved = telemetry.replica_served.item(0)
                served = sph.item(0) + rserved
                deferred = telemetry.deferred.item(0)
            else:
                rserved = int(telemetry.replica_served.sum())
                served = int(sph.sum()) + rserved
                deferred = telemetry.deferred_total
        if ts is None:
            ts = max(0.0, self.now() - duration)
        span = Span(index=self._total, verb=str(verb), ts=float(ts),
                    dur=float(duration), batch=tuple(batch),
                    rounds=int(rounds), served=served,
                    deferred=deferred, replica_served=rserved,
                    compiled=int(compiled), attrs=dict(attrs or {}))
        self._ring[self._total % self.capacity] = span
        self._total += 1

        mets = self._verb_metrics.get(span.verb)
        if mets is None:
            reg = self.registry
            lbl = {"verb": span.verb}
            mets = (
                reg.counter("plane_dispatches_total",
                            "verb dispatches through the plane",
                            labels=lbl),
                reg.counter("plane_rounds_total",
                            "coherence rounds spent in fused loops",
                            labels=lbl),
                reg.counter("plane_served_ops_total",
                            "ops served (home + replica)"),
                reg.counter("plane_deferred_ops_total",
                            "bucket-overflow defer events"),
                reg.counter("plane_compile_events_total",
                            "kernel libraries loaded during dispatches"),
                reg.histogram("plane_dispatch_seconds",
                              "wall time per verb dispatch",
                              labels=lbl),
                reg.histogram("plane_rounds_per_dispatch",
                              "coherence rounds per dispatch"),
            )
            self._verb_metrics[span.verb] = mets
        disp, rnds, srv, dfr, cmp_evts, dsec, rper = mets
        # direct .value bumps — the Counter.inc() negative-amount guard
        # is vacuous here (rounds/served/deferred/compiled are counter
        # deltas, non-negative by construction) and the five method
        # calls are measurable on the dispatch path
        disp.value += 1.0
        rnds.value += span.rounds
        srv.value += span.served
        dfr.value += span.deferred
        cmp_evts.value += span.compiled
        dsec.observe(span.dur)
        rper.observe(float(span.rounds))

        if telemetry is not None:
            if (self._line_heat is None
                    or self._line_heat.values.shape[0]
                    != telemetry.n_lines):
                self._line_heat = EwmaHeat(telemetry.n_lines,
                                           alpha=self.alpha)
            self._line_heat.update(telemetry.line_hits)
            if (self._home_heat is None
                    or self._home_heat.values.shape[0]
                    != telemetry.n_shards):
                self._home_heat = EwmaHeat(telemetry.n_shards,
                                           alpha=self.alpha)
            if telemetry.n_shards == 1:
                # flat plane: home load collapses to the scalars
                # already extracted above — skip the per-span numpy
                # reductions on the dispatch path
                self._home_heat.update1(served - rserved + deferred)
            else:
                self._home_heat.update(telemetry.served_per_home
                                       + telemetry.deferred.sum(axis=0))
        return span

    # ------------------------------------------------------------ heat
    @property
    def line_heat(self) -> np.ndarray | None:
        """EWMA per-line hit heat [L] — feed ``plan_rehome`` /
        ``plan_replication`` directly; None before any telemetry."""
        return None if self._line_heat is None \
            else self._line_heat.values

    @property
    def home_heat(self) -> np.ndarray | None:
        """EWMA per-home load (served + deferred-toward) [S]."""
        return None if self._home_heat is None \
            else self._home_heat.values

    # ------------------------------------------------------------ ring
    def __len__(self) -> int:
        return min(self._total, self.capacity)

    @property
    def total(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        return max(0, self._total - self.capacity)

    def spans(self) -> list[Span]:
        """Retained spans, oldest first."""
        if self._total <= self.capacity:
            return [s for s in self._ring[:self._total]]
        head = self._total % self.capacity
        return [s for s in self._ring[head:] + self._ring[:head]]

    # ------------------------------------------------------- exporters
    def export_chrome_trace(self, path: str | None = None) -> dict:
        """Chrome-trace JSON document; written to ``path`` if given."""
        doc = {
            "traceEvents": [s.to_chrome_event() for s in self.spans()],
            "displayTimeUnit": "ms",
            "otherData": {"spans_total": self._total,
                          "spans_dropped": self.dropped},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
        return doc

    def snapshot(self) -> dict:
        """Plain-dict summary for ``BENCH_*.json`` ``meta.telemetry``."""
        verbs: dict = {}
        rounds = served = deferred = compiled = 0
        for s in self.spans():
            verbs[s.verb] = verbs.get(s.verb, 0) + 1
            rounds += s.rounds
            served += s.served
            deferred += s.deferred
            compiled += s.compiled
        out = {"spans": self._total, "dropped": self.dropped,
               "verbs": verbs, "rounds_total": rounds,
               "served_total": served, "deferred_total": deferred,
               "compile_events": compiled}
        if self._line_heat is not None:
            top = self._line_heat.top(8)
            out["heat_top"] = [[int(i), float(self._line_heat.values[i])]
                               for i in top]
            out["heat_updates"] = self._line_heat.updates
        if self._home_heat is not None:
            out["home_heat"] = [float(v)
                                for v in self._home_heat.values]
        return out

    def __repr__(self) -> str:
        return (f"FlightRecorder(capacity={self.capacity}, "
                f"spans={self._total}, dropped={self.dropped})")
