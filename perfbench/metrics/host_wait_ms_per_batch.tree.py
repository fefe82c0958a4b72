"""Host time, in ms a batch, blocked on the card in the traced window:
the self time of the program's spans ``plane.spin_sync`` (a round's
completion check) and ``plane.result_copy`` (a verb's results to the
host)."""

from perfbench.lib import program_spans


def read(ctx):
    s = program_spans.self_seconds_per_batch(
        ctx, ("plane.spin_sync", "plane.result_copy"))
    return None if s is None else 1e3 * s
