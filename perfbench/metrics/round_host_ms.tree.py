"""Host time, in ms, issuing one coherence round in the traced window:
the self time of the program's span ``engine.round`` over its calls."""

from perfbench.lib import program_spans


def read(ctx):
    s = program_spans.self_seconds_per_call(ctx, "engine.round")
    return None if s is None else 1e3 * s
