"""What the metric readers under ``metrics/`` share.

A reader is ``read(ctx) -> float | None``.  ``ctx.setup_s`` is the
set-up time; ``ctx.window`` the measured window (``seconds``,
``batches``, ``latencies_s`` of every operation, the drivers' summed
``counts`` and the program's ``counters`` over the window);
``ctx.trace`` the traced window or None (``summary`` from
``lib/trace.py``, ``kernels`` {name: calls, bytes, device_s},
``rounds``).  None means there is nothing to read, and the harness
leaves the metric out of the line.
"""

from __future__ import annotations

import numpy as np

from perfbench.lib.peaks import HBM_BYTES_PER_S


def rate(ctx, count: str):
    n = ctx.window["counts"].get(count)
    return None if n is None else n / ctx.window["seconds"]


def p95_ms(ctx):
    lat = ctx.window["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else None


def per_batch(ctx, counter: str):
    c = ctx.window["counters"].get(counter)
    return None if c is None else c / ctx.window["batches"]


def _summary(ctx):
    return None if ctx.trace is None else ctx.trace["summary"]


def device_idle(ctx):
    s = _summary(ctx)
    if s is None or not s["launches"]:
        return None
    return 100.0 * (s["window_s"] - s["busy_s"]) / s["window_s"]


def copy_share(ctx):
    s = _summary(ctx)
    if s is None or not s["busy_s"]:
        return None
    return 100.0 * s["host_copy_s"] / s["busy_s"]


def launches_per_round(ctx):
    s = _summary(ctx)
    if s is None or not s["launches"] or not ctx.trace["rounds"]:
        return None
    return s["launches"] / ctx.trace["rounds"]


def roofline(ctx, kernel: str):
    """Share of the least time the calls' needed bytes take at the
    card's HBM rate in the kernel's device time, in %."""
    if ctx.trace is None:
        return None
    k = ctx.trace["kernels"].get(kernel)
    if not k or not k["calls"] or not k["device_s"]:
        return None
    return 100.0 * k["bytes"] / HBM_BYTES_PER_S / k["device_s"]
