"""MiB of per-line telemetry counters copied to the host a batch in the
traced window: the program's counter ``plane.telemetry_bytes``."""

from perfbench.lib import program_spans


def read(ctx):
    b = program_spans.counter_per_batch(ctx, "plane.telemetry_bytes")
    return None if b is None else b / 2**20
