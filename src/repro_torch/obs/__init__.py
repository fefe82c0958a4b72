"""Observability: the typed telemetry record, the metrics registry, the
flight recorder and the layer spans (copies of ``repro/obs/telemetry.py``,
``repro/obs/metrics.py`` and ``repro/obs/recorder.py``; a span's
``compiled`` counts kernel library loads, see ``recorder``).

The layer spans and counters (``span``, ``count``) are off until
``tracing()`` or a ``torch.profiler`` session turns them on; then every
span is an annotation in the profiler's trace and its totals go to
``TRACER.registry`` (``render_prom()``), per session
(``session_totals()``).  See ``recorder``."""

from .metrics import (Counter, EwmaHeat, Gauge, MetricsRegistry,
                      StreamingHistogram)
from .recorder import (TRACER, FlightRecorder, Span, count,
                       session_totals, span, tracing)
from .telemetry import PlaneTelemetry

__all__ = ["Counter", "EwmaHeat", "FlightRecorder", "Gauge",
           "MetricsRegistry", "PlaneTelemetry", "Span", "StreamingHistogram",
           "TRACER", "count", "session_totals", "span", "tracing"]
