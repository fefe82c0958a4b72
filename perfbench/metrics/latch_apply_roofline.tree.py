"""K1's share of its roofline in the traced window: the bytes its calls
need at the card's HBM rate (kernels/latch_apply.py) over its device
time."""

from perfbench.lib import readers


def read(ctx):
    return readers.roofline(ctx, "latch_apply")
