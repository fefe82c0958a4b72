"""Coherence rounds a batch over the measured window (the round engine's
TRACE_COUNTS)."""

from perfbench.lib import readers


def read(ctx):
    return readers.per_batch(ctx, "rounds")
