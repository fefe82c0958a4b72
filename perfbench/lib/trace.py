"""Profiler arithmetic: what a traced window's events say.

Works on the events of a window run inside ``record_function(WINDOW)``,
as :func:`records` lists them.  Device activity is
every CUDA event that is not a user annotation: kernels, copies and
fills.  Busy time is the union of their intervals inside the window,
each instant counted once however many events cover it (the sum of the
events' durations is the same on one stream; it counts overlaps twice
where streams overlap).  Idle time is the window less busy time; each
idle gap is charged to the innermost of the harness's spans (names
starting ``SPAN``) that covers the gap's start, which says which layer's
host code the card was waiting for.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW = "pb:window"
SPAN = "pb:"
HOST_COPY = ("Memcpy HtoD", "Memcpy DtoH")
NAME_CHARS = 120


def records(prof) -> list:
    """``(name, on_card, start_us, end_us, is_annotation)`` of every
    event of a finished ``torch.profiler.profile``.  Reads the raw
    events (a tenth of a second for 10^5 of them) where this PyTorch
    has them, else the parsed ``FunctionEvent`` list (seconds)."""
    try:
        return [(e.name(), str(e.device_type()).endswith("CUDA"),
                 e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
                 bool(e.is_user_annotation()))
                for e in prof.profiler.kineto_results.events()]
    except AttributeError:
        return [(e.name, str(e.device_type).endswith("CUDA"),
                 e.time_range.start, e.time_range.end,
                 bool(e.is_user_annotation)) for e in prof.events()]


def union(intervals) -> list:
    """Disjoint sorted intervals covering ``intervals`` ((start, end))."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def gaps(busy, lo: float, hi: float) -> list:
    """The parts of ``[lo, hi)`` outside the disjoint sorted ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans, times) -> list:
    """For each of the sorted ``times``, the name of the innermost of
    the properly nested ``spans`` ((start, end, name)) that covers it,
    or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(events, kernel_names=()) -> dict | None:
    """The traced window's numbers from :func:`records`, in seconds: ``window_s``,
    ``busy_s``, ``launches`` (device events: kernels, copies, fills),
    ``host_copy_s``, ``device_ops`` ({name: seconds}), ``idle_by_span``
    ({span: seconds}) and ``kernel_s`` ({kernel: seconds} for each of
    ``kernel_names``, matched as a substring of the event's name).
    None when the events hold no window."""
    win = [e for e in events if not e[1] and e[0] == WINDOW]
    if not win:
        return None
    lo, hi = win[0][2], win[0][3]
    dev, spans = [], []
    for name, on_card, s, t, note in events:
        if on_card and not note:
            s, t = max(s, lo), min(t, hi)
            if t > s:
                dev.append((s, t, name))
        elif not on_card and name.startswith(SPAN) and name != WINDOW:
            spans.append((s, t, name[len(SPAN):]))
    busy = union((s, t) for s, t, _ in dev)
    ops = defaultdict(float)
    for s, t, name in dev:
        ops[name[:NAME_CHARS]] += (t - s) * 1e-6
    idle = gaps(busy, lo, hi)
    idle_by = defaultdict(float)
    for (s, t), name in zip(idle, innermost(spans, [s for s, _ in idle])):
        idle_by[name or "harness"] += (t - s) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "launches": len(dev),
        "host_copy_s": sum(t - s for s, t, n in dev
                           if n.startswith(HOST_COPY)) * 1e-6,
        "device_ops": dict(ops),
        "idle_by_span": dict(idle_by),
        "kernel_s": {k: sum(t - s for s, t, n in dev if k in n) * 1e-6
                     for k in kernel_names},
    }


def top(table: dict, n: int = 10) -> list:
    """The ``n`` largest entries of ``{name: seconds}`` as ``[name,
    seconds]`` pairs."""
    return [[k, v] for k, v in sorted(table.items(),
                                      key=lambda kv: -kv[1])[:n]]
