"""`FlightRecorder` — the plane's bounded span ring + exporters; and the
process's layer spans and counters (:func:`span`, :func:`count`).

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

**Layer spans and counters.**  The layers mark their own work:
``with span("engine.round"):`` around a round's body,
``count("plane.host_reads")`` at a blocking read of a device value.
Tracing is off by default, and then a site costs one flag test (no
clock read, no allocation, no annotation, no registry write).  It is on
while ``tracing(True)`` holds, or while a ``torch.profiler`` session
records.  When on, each span is also a
``torch.profiler.record_function`` annotation of its name, so in any
profiler trace it nests with its parent span on the device events'
clock; and the totals go to one process-wide registry
(:data:`TRACER`): per span name the calls, the seconds and the self
seconds (less the spans nested in it), per counter its sum.  Only
durations are kept, on the monotonic clock (``time.perf_counter_ns``);
where a span lies among the device's events is its annotation's.
Totals are kept per tracing session: a session starts with the first
site that finds tracing on after one that found it off (or after
``tracing(True)`` turned it on).  The registry holds the newest session
and the one before it.  An operator::

    with obs.tracing():
        tree.lookup_batch(keys)
    print(obs.TRACER.registry.render_prom())
    # trace_span_self_seconds_total{session="1",span="engine.round"} ...
    obs.session_totals()    # {"session": 1, "spans": {...}, ...}

The spans' names and what reads them: ``PERF.md`` section 3.

A copy of ``repro/obs/recorder.py``, but for what ``compiled`` counts
and the layer spans.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import NamedTuple

import numpy as np
import torch.autograd.profiler as _profiler

from .metrics import EwmaHeat, MetricsRegistry

__all__ = ["Span", "FlightRecorder", "TRACER", "Tracer", "count",
           "session_totals", "span", "tracing"]


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


# ------------------------------------------------ layer spans and counters

# what span() gives while tracing is off: one shared do-nothing
# context, so the off path allocates nothing
_OFF = contextlib.nullcontext()

# a span's clock: durations only, so a monotonic one
_clock = time.perf_counter_ns


class _OnSpan:
    """One span while tracing is on: a ``record_function`` annotation
    of its name and, on exit, its seconds and self seconds added to the
    tracer's session totals."""

    __slots__ = ("tracer", "name", "annotation", "t0", "children")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        self.annotation = _profiler.record_function(self.name)
        self.annotation.__enter__()
        self.tracer._stack().append(self)
        self.children = 0
        # read inside the annotation, so the span's interval nests in it
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        dur = _clock() - self.t0
        stack = self.tracer._stack()
        stack.pop()
        if stack:
            stack[-1].children += dur
        self.tracer._add_span(self.name, dur, dur - self.children)
        self.annotation.__exit__(*exc)
        return False


class Tracer:
    """The process's layer spans and counters: the tracing switch, the
    session, and the totals in :attr:`registry` (families
    ``trace_span_total``, ``trace_span_seconds_total``,
    ``trace_span_self_seconds_total`` labelled ``session`` and ``span``;
    ``trace_count_total`` labelled ``session`` and ``counter``).  Spans
    nest per thread; the registry is shared by every thread, as the
    plane's callers are one thread each."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.on = False         # tracing()'s switch
        self.live = False       # the last site found tracing on
        self.session = 0        # the newest session (0: none yet)
        self._local = threading.local()
        self._span_handles: dict = {}
        self._count_handles: dict = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _start_session(self) -> None:
        self.session += 1
        self._span_handles.clear()
        self._count_handles.clear()
        # the series of the session before stay beside the new one's,
        # older ones go: a process that traces again and again holds two
        # sessions' series
        keep = {str(self.session - 1), str(self.session)}
        self.registry.retain(lambda labels: labels["session"] in keep)

    def active(self) -> bool:
        """Whether tracing is on now (starting a session if the last
        site found it off)."""
        if self.on or _profiler._is_profiler_enabled:
            if not self.live:
                self.live = True
                self._start_session()
            return True
        self.live = False
        return False

    def _add_span(self, name: str, dur_ns: int, self_ns: int) -> None:
        h = self._span_handles.get(name)
        if h is None:
            reg, lbl = self.registry, {"session": str(self.session),
                                       "span": name}
            h = self._span_handles[name] = (
                reg.counter("trace_span_total", "layer span calls",
                            labels=lbl),
                reg.counter("trace_span_seconds_total",
                            "layer span wall seconds", labels=lbl),
                reg.counter("trace_span_self_seconds_total",
                            "layer span seconds less its nested spans",
                            labels=lbl))
        calls, secs, own = h
        calls.inc()
        secs.inc(dur_ns * 1e-9)
        own.inc(self_ns * 1e-9)

    def _add_count(self, name: str, n) -> None:
        c = self._count_handles.get(name)
        if c is None:
            c = self._count_handles[name] = self.registry.counter(
                "trace_count_total", "layer counters",
                labels={"session": str(self.session), "counter": name})
        c.inc(n)

    def totals(self) -> dict | None:
        """The newest session's totals as plain numbers: ``{"session":
        k, "spans": {name: {"count", "seconds", "self_seconds"}},
        "counters": {name: value}}``; None before any session."""
        if self.session < 1:
            return None
        return {"session": self.session,
                "spans": {name: {"count": calls.value,
                                 "seconds": secs.value,
                                 "self_seconds": own.value}
                          for name, (calls, secs, own)
                          in self._span_handles.items()},
                "counters": {name: c.value
                             for name, c in self._count_handles.items()}}


TRACER = Tracer()


def span(name: str):
    """A context marking a layer's work as span ``name``: nothing while
    tracing is off; an annotation and session totals while it is on."""
    return _OnSpan(TRACER, name) if TRACER.active() else _OFF


def count(name: str, n=1) -> None:
    """Adds ``n`` to counter ``name`` while tracing is on."""
    if TRACER.active():
        TRACER._add_count(name, n)


class tracing:                                     # noqa: N801
    """Turns the layer spans on (``tracing()``, ``tracing(True)``) or
    off (``tracing(False)``) from the call on; as a context it puts the
    switch back on exit.  Turning it on starts a new session, and so
    does the first site after tracing was off.  A ``torch.profiler``
    session turns tracing on while it records, whatever the switch
    says (two profiler sessions with no site between them share one
    tracing session)."""

    def __init__(self, on: bool = True):
        self.prev = TRACER.on
        TRACER.on = bool(on)
        if on and not self.prev:
            TRACER.live = False

    def __enter__(self) -> Tracer:
        return TRACER

    def __exit__(self, *exc):
        TRACER.on = self.prev
        if not (TRACER.on or _profiler._is_profiler_enabled):
            TRACER.live = False
        return False


def session_totals() -> dict | None:
    """The newest tracing session's totals (:meth:`Tracer.totals`)."""
    return TRACER.totals()
