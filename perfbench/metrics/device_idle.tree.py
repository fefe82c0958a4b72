"""Share of the traced window in which no kernel, copy or fill ran on the
card (each instant counted once)."""

from perfbench.lib import readers


def read(ctx):
    return readers.device_idle(ctx)
