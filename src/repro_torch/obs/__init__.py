"""Observability: the typed telemetry record and the metrics registry
(copies of ``repro/obs/telemetry.py`` and ``repro/obs/metrics.py``).
The flight recorder is not ported yet."""

from .metrics import (Counter, EwmaHeat, Gauge, MetricsRegistry,
                      StreamingHistogram)
from .telemetry import PlaneTelemetry

__all__ = ["Counter", "EwmaHeat", "Gauge", "MetricsRegistry",
           "PlaneTelemetry", "StreamingHistogram"]
