"""Seconds from the process's start to the first timed batch: imports, the
traffic pool, the program's state, the kernels' load (and build, in a
checkout's first run) and the warm-up batches."""


def read(ctx):
    return ctx.setup_s
