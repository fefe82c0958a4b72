"""K2's share of its roofline in the traced window: the bytes its calls
need at the card's HBM rate (kernels/gcl_fetch.py) over its device time."""

from perfbench.lib import readers


def read(ctx):
    return readers.roofline(ctx, "gcl_fetch")
