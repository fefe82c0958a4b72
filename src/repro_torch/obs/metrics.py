"""Time-series metrics for the observability plane: counters, gauges,
log-bucketed streaming-quantile histograms, EWMA heat, and a registry
that renders Prometheus text exposition.

Design points:

* :class:`StreamingHistogram` is an HDR-style log-bucketed sketch: a
  sample lands in bucket ``ceil(log(x / min_bound) / log(growth))``, so
  memory is O(occupied buckets) — never the sample count — and any
  quantile is answerable with bounded RELATIVE error (±(growth-1)/2
  around the geometric bucket midpoint; the default ``growth=1.03``
  keeps p50/p99 within a few percent of ``numpy.percentile`` on the
  full sample, which the unit tests assert on a fixed draw).  This is
  what replaces the hand-rolled sorted-sample percentiles in
  ``benchmarks/bench_serving.py`` / ``fig11_tpcc_rounds.py`` and the
  unbounded ``TxnStats.latencies`` list.
* :class:`EwmaHeat` is the per-line/per-home exponential moving average
  the placement policies consume (``heat = (1-a)*heat + a*counts`` per
  update) — the ROADMAP's "ONLINE placement from a telemetry EWMA"
  signal.  The closed form after k constant-``c`` updates from zero is
  ``c * (1 - (1-a)^k)``; the tests pin the implementation to it.
* :class:`MetricsRegistry` keys series by (name, labels) and renders
  the whole set as Prometheus text exposition (``render_prom()``):
  ``# HELP`` / ``# TYPE`` per family, ``_bucket{le=...}`` cumulative
  buckets + ``_sum`` / ``_count`` for histograms — parseable by any
  Prom scraper (and by the parse-back unit test).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["Counter", "Gauge", "StreamingHistogram", "EwmaHeat",
           "MetricsRegistry"]


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment {amount} < 0")
        self.value += amount


class Gauge:
    """Set-to-current-value metric."""

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class StreamingHistogram:
    """Log-bucketed quantile sketch: p50/p99 without storing samples."""

    kind = "histogram"

    def __init__(self, growth: float = 1.03, min_bound: float = 1e-9):
        if growth <= 1.0:
            raise ValueError(f"growth={growth} must be > 1")
        self.growth = float(growth)
        self.min_bound = float(min_bound)
        self._log_g = math.log(growth)
        self._buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    # ---------------------------------------------------------- ingest
    def _index(self, x: float) -> int:
        if x <= self.min_bound:
            return 0
        return max(1, math.ceil(math.log(x / self.min_bound)
                                / self._log_g))

    def _upper(self, idx: int) -> float:
        return self.min_bound * self.growth ** idx

    def _rep(self, idx: int) -> float:
        """Geometric bucket midpoint — the value a quantile reports."""
        if idx == 0:
            return self.min_bound
        return self.min_bound * self.growth ** (idx - 0.5)

    def observe(self, x: float) -> None:
        x = float(x)
        idx = self._index(x)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1
        self.count += 1
        self.total += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)

    def merge(self, other: "StreamingHistogram") -> None:
        if (other.growth != self.growth
                or other.min_bound != self.min_bound):
            raise ValueError("histogram geometry mismatch")
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)

    # --------------------------------------------------------- queries
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], within the sketch's
        relative-error bound; 0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} outside [0, 1]")
        if not self.count:
            return 0.0
        target = q * (self.count - 1) + 1     # 1-based rank, like the
        cum = 0                               # sorted-sample index
        for idx in sorted(self._buckets):
            cum += self._buckets[idx]
            if cum >= target:
                # clamp to the observed range: exact ends beat bucket
                # midpoints at the extremes (q=0/q=1 are exact)
                return min(max(self._rep(idx), self._min), self._max)
        return self._max

    def percentile(self, p: float) -> float:
        return self.quantile(p / 100.0)

    def snapshot(self) -> dict:
        """Summary dict for bench ``meta`` / ``ServeStats`` embedding."""
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max, "mean": self.mean,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    # ------------------------------------------------- prom exposition
    def prom_buckets(self):
        """Cumulative (le, count) pairs over occupied buckets, ending
        with ('+Inf', count) — the Prometheus histogram series."""
        out, cum = [], 0
        for idx in sorted(self._buckets):
            cum += self._buckets[idx]
            out.append((f"{self._upper(idx):.9g}", cum))
        out.append(("+Inf", self.count))
        return out


class EwmaHeat:
    """Exponentially-weighted moving average over a counter vector —
    the recorder's per-line (and per-home) heat signal, consumed
    directly by ``placement.plan_rehome`` / ``plan_replication``."""

    def __init__(self, n: int, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha={alpha} outside (0, 1]")
        self.alpha = float(alpha)
        self.values = np.zeros(int(n), np.float64)
        self.updates = 0

    def update(self, counts) -> np.ndarray:
        counts = np.asarray(counts)
        if counts.shape != self.values.shape:
            raise ValueError(
                f"counts shape {counts.shape} != {self.values.shape}")
        # in-place: update() sits on the recorder's dispatch path, so
        # it must not allocate a fresh vector per span; one dispatch
        # touches few lines, so add through the nonzero index set when
        # it is sparse instead of materializing alpha*counts in full
        v = self.values
        v *= 1.0 - self.alpha
        nz = np.flatnonzero(counts)
        if nz.size * 4 < counts.size:
            v[nz] += self.alpha * counts[nz]
        elif nz.size:
            v += self.alpha * counts
        self.updates += 1
        return v

    def update1(self, c: float) -> np.ndarray:
        """Scalar fast path for length-1 vectors (the recorder's
        flat-plane home heat) — same EWMA, no ufunc dispatch."""
        v = self.values
        if v.shape != (1,):
            raise ValueError(f"update1 on shape {v.shape} != (1,)")
        v[0] = (1.0 - self.alpha) * v[0] + self.alpha * c
        self.updates += 1
        return v

    def top(self, k: int):
        """Hottest ``k`` indices, hottest first."""
        order = np.argsort(self.values)[::-1]
        return order[:k].astype(np.int64)


def _label_key(labels: dict | None):
    return tuple(sorted((labels or {}).items()))


def _label_str(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class MetricsRegistry:
    """Name+labels -> metric store with get-or-create accessors and
    Prometheus text rendering."""

    _KINDS = {"counter": Counter, "gauge": Gauge,
              "histogram": StreamingHistogram}

    def __init__(self):
        # name -> {"kind": str, "help": str,
        #          "series": {label_key: metric}}
        self._families: dict[str, dict] = {}

    def _get(self, kind: str, name: str, help: str, labels,
             **kwargs):
        fam = self._families.get(name)
        if fam is None:
            fam = {"kind": kind, "help": help, "series": {}}
            self._families[name] = fam
        elif fam["kind"] != kind:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{fam['kind']}, not {kind}")
        key = _label_key(labels)
        metric = fam["series"].get(key)
        if metric is None:
            metric = self._KINDS[kind](**kwargs)
            fam["series"][key] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None,
                  growth: float = 1.03,
                  min_bound: float = 1e-9) -> StreamingHistogram:
        return self._get("histogram", name, help, labels,
                         growth=growth, min_bound=min_bound)

    def families(self):
        return dict(self._families)

    def snapshot(self) -> dict:
        """Plain-dict view (bench meta embedding): histograms collapse
        to their summary snapshots, counters/gauges to values."""
        out: dict = {}
        for name, fam in sorted(self._families.items()):
            series = {}
            for key, metric in fam["series"].items():
                label = _label_str(key) or "_"
                series[label] = (metric.snapshot()
                                 if fam["kind"] == "histogram"
                                 else metric.value)
            out[name] = series
        return out

    def render_prom(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for name, fam in sorted(self._families.items()):
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for key, metric in sorted(fam["series"].items()):
                if fam["kind"] == "histogram":
                    for le, cum in metric.prom_buckets():
                        bl = _label_str(key + (("le", le),))
                        lines.append(f"{name}_bucket{bl} {cum}")
                    ls = _label_str(key)
                    lines.append(f"{name}_sum{ls} {metric.total:.9g}")
                    lines.append(f"{name}_count{ls} {metric.count}")
                else:
                    ls = _label_str(key)
                    lines.append(f"{name}{ls} {metric.value:.9g}")
        return "\n".join(lines) + "\n"
