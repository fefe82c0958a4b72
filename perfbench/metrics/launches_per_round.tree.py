"""Device launches (kernels, copies, fills) a coherence round in the traced
window (torch.profiler)."""

from perfbench.lib import readers


def read(ctx):
    return readers.launches_per_round(ctx)
