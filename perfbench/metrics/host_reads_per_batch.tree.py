"""Blocking reads of device values a batch in the traced window: the
program's counter ``plane.host_reads`` (each spin check and each copy
of a result or a telemetry counter to the host)."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.counter_per_batch(ctx, "plane.host_reads")
