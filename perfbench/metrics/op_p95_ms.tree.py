"""95th percentile, in ms, over every operation of the measured window, of
the time from the dispatch of the batch that carries it to its result on
the host (the benchmark's own clock)."""

from perfbench.lib import readers


def read(ctx):
    return readers.p95_ms(ctx)
