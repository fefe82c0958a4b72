"""Share of the card's busy time in the traced window spent in copies
between host and card."""

from perfbench.lib import readers


def read(ctx):
    return readers.copy_share(ctx)
