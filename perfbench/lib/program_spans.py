"""The program's own layer spans and counters over the traced window.

``repro_torch.obs`` keeps totals per tracing session: per span name the
calls, seconds and self seconds (less the spans nested in it), per
counter its sum.  ``torch.profiler`` turns the program's tracing on
while it records, and the spans outside the traced window find it off,
so the program's last session is the traced window.  A program without
those totals (a checkout older than them) gives None, and so does a
traced window with no device events, as the device readers do: the
metrics are then left out of the line.
"""

from __future__ import annotations


def last_session():
    """The program's last tracing session's totals, or None."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    totals = getattr(obs, "session_totals", None)
    return None if totals is None else totals()


def session(ctx):
    """The traced window's session totals and its batches, or None."""
    t = ctx.trace
    if t is None or not t["batches"] or not (t["summary"] or {}).get(
            "launches"):
        return None
    s = last_session()
    return None if s is None else (s, t["batches"])


def self_seconds_per_batch(ctx, names):
    """The self seconds of the spans ``names`` a batch; None if none
    of them ran."""
    got = session(ctx)
    if got is None:
        return None
    s, batches = got
    spans = [s["spans"][n] for n in names if n in s["spans"]]
    if not spans:
        return None
    return sum(x["self_seconds"] for x in spans) / batches


def counter_per_batch(ctx, name: str):
    got = session(ctx)
    if got is None or name not in got[0]["counters"]:
        return None
    return got[0]["counters"][name] / got[1]


def self_seconds_per_call(ctx, name: str):
    got = session(ctx)
    if got is None:
        return None
    sp = got[0]["spans"].get(name)
    if not sp or not sp["count"]:
        return None
    return sp["self_seconds"] / sp["count"]
