"""Read-modify-write steps a batch over the measured window
(DeviceBTree.stats['rmw_steps']): a leaf's updates take one step each."""

from perfbench.lib import readers


def read(ctx):
    return readers.per_batch(ctx, "rmw_steps")
