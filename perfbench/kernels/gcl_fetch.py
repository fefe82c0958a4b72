"""K2, ``gcl_fetch``: the bytes one call needs.

``kernels/gcl_fetch.py:fetch(pages [P, E], words [P, 2], req_page,
bit_hi, bit_lo)`` gives each of R requests its page's payload row, old
latch word and grant verdict, and ORs the requests' reader bits into
the words.  What a call needs, whatever implements it:

* each slot's ``req_page`` (4 bytes; a page outside ``0 .. P-1`` marks
  an empty slot) and the R_v valid slots' two bit lanes;
* every slot's results written once: its payload row (``E`` elements
  of the pages' type, zeros for an empty slot) and old_hi, old_lo and
  granted;
* each of the D distinct valid pages' word read once and written once
  and its payload row read once.

``4 R + 8 R_v + R (row + 12) + D (16 + row)`` bytes, ``row`` the bytes
of a payload row.  PERF.md's older bound counted today's copy of the
whole ``[P, 2]`` words table into the ``new_words`` the call returns
(``16 P`` bytes); an in-place kernel needs none of it, so it is not
counted here.

The round engine looks the kernel up as ``engine.gcl_fetch_op``.
"""

from __future__ import annotations

import numpy as np

NAME = "gcl_fetch"
DEVICE_KERNEL = "gcl_fetch_kernel"
TARGETS = [("repro_torch.core.rounds.engine", "gcl_fetch_op")]


def capture(pages, words, req_page, *args, **kwargs):
    return (int(pages.shape[0]), int(pages.shape[1]) * pages.element_size(),
            req_page)


def needed_bytes(n_pages: int, row: int, req_page) -> int:
    page = np.asarray(req_page).astype(np.int64)
    valid = (page >= 0) & (page < n_pages)
    r, r_v = page.shape[0], int(valid.sum())
    distinct = np.unique(page[valid]).shape[0]
    return 4 * r + 8 * r_v + r * (row + 12) + distinct * (16 + row)


def call_bytes(captured) -> int:
    n_pages, row, page = captured
    return needed_bytes(n_pages, row, page.cpu().numpy())
