"""Observability: the typed telemetry record, the metrics registry and
the flight recorder (copies of ``repro/obs/telemetry.py``,
``repro/obs/metrics.py`` and ``repro/obs/recorder.py``; a span's
``compiled`` counts kernel library loads, see ``recorder``)."""

from .metrics import (Counter, EwmaHeat, Gauge, MetricsRegistry,
                      StreamingHistogram)
from .recorder import FlightRecorder, Span
from .telemetry import PlaneTelemetry

__all__ = ["Counter", "EwmaHeat", "FlightRecorder", "Gauge",
           "MetricsRegistry", "PlaneTelemetry", "Span",
           "StreamingHistogram"]
