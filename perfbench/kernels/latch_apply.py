"""K1, ``latch_apply``: the bytes one call needs.

``kernels/latch_ops.py:apply_batch(words [N, 2], requests)`` applies R
CAS/FAA requests (line, op, arg_hi, arg_lo, cmp_hi, cmp_lo, int32 each)
to the latch words in request order and returns each request's old word
and verdict.  What a call needs, whatever implements it:

* each slot's ``line`` (4 bytes; a line outside ``0 .. N-1`` marks an
  empty slot) and, for the R_v valid slots, their other five fields;
* the three results of every slot written once (old_hi, old_lo, ok);
* each of the D distinct valid lines' word read once and written once.

``4 R + 20 R_v + 12 R + 16 D`` bytes.  PERF.md's older bound for this
kernel counted today's copy of the whole ``[N, 2]`` table into a new
one (``16 N`` bytes, 32 MiB at the tree's 2^21 lines) that the call
returns: a kernel that applied the requests in place would read far over
100 % of that bound, so it is not counted here.

The round engine looks the kernel up as ``engine.apply_batch``; the hook
keeps each call's ``line`` tensor and the table's row count, and the
bytes are worked out after the traced window, when the tensors are read.
"""

from __future__ import annotations

import numpy as np

NAME = "latch_apply"
DEVICE_KERNEL = "latch_apply_kernel"
TARGETS = [("repro_torch.core.rounds.engine", "apply_batch")]


def capture(words, requests, *args, **kwargs):
    """What the hook keeps of a call: no device work."""
    return int(words.shape[0]), requests["line"]


def needed_bytes(n_lines: int, line) -> int:
    line = np.asarray(line).astype(np.int64)
    valid = (line >= 0) & (line < n_lines)
    r, r_v = line.shape[0], int(valid.sum())
    distinct = np.unique(line[valid]).shape[0]
    return 4 * r + 20 * r_v + 12 * r + 16 * distinct


def call_bytes(captured) -> int:
    n_lines, line = captured
    return needed_bytes(n_lines, line.cpu().numpy())
