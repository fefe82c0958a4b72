"""YCSB operations completed over the whole measured window, a second."""

from perfbench.lib import readers


def read(ctx):
    return readers.rate(ctx, "ycsb_ops")
