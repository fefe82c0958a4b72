"""8-byte global pointers (paper Sec. 3) and the GCL line allocator.

A copy of ``repro/dsm/address.py`` without its deprecated
``GlobalAddress`` shim: ``GAddr`` (``core/addressing.py``) is the
address vocabulary, and :class:`LineAllocator` hands out pool pages.
"""

from __future__ import annotations

import numpy as np

from ..core.addressing import GAddr, as_gaddr, home_of

__all__ = ["GAddr", "LineAllocator", "as_gaddr", "home_of"]


class LineAllocator:
    """Host-side allocator of GCL lines for node pages on either plane
    (flat or mesh-sharded — line indices are identical on both; only
    physical placement differs).

    Bump allocation with an explicit free list, and the same error
    contract ``SELCCKVPool.allocate`` adopted in PR 2: requests past
    ``n_lines`` RAISE instead of silently wrapping onto live lines, and
    ``free`` rejects double-frees and never-allocated lines — an
    allocator that recycles a line that is still latched corrupts the
    coherence directory in ways no invariant check can localize.

    ``start`` reserves a prefix of lines the allocator never hands out
    (e.g. an index's metadata line); ``top`` exposes the bump pointer so
    a persistent structure can record it and ``open()`` can resume with
    ``LineAllocator(n, start=..., top=recorded)`` (the free list is not
    persisted — freed-line recycling is per-session).
    """

    def __init__(self, n_lines: int, *, start: int = 0,
                 top: int | None = None):
        if not 0 <= start <= n_lines:
            raise ValueError(f"start={start} outside 0..{n_lines}")
        self.n_lines = int(n_lines)
        self.start = int(start)
        self.top = int(start if top is None else top)
        if not self.start <= self.top <= self.n_lines:
            raise ValueError(
                f"top={top} outside {self.start}..{self.n_lines}")
        self._freed: set[int] = set()

    @property
    def free_lines(self) -> int:
        return self.n_lines - self.top + len(self._freed)

    def alloc(self, n: int = 1) -> np.ndarray:
        """Allocate ``n`` lines (free-list first, then bump).  Raises
        ``ValueError`` on exhaustion — never wraps onto live lines."""
        if n < 0:
            raise ValueError(f"cannot allocate n={n} lines")
        if n > self.free_lines:
            raise ValueError(
                f"line allocator exhausted: {n} lines requested, "
                f"{self.free_lines} of {self.n_lines} free")
        out = []
        while self._freed and len(out) < n:
            out.append(self._freed.pop())
        fresh = n - len(out)
        out.extend(range(self.top, self.top + fresh))
        self.top += fresh
        return np.asarray(sorted(out), np.int32)

    def free(self, lines) -> None:
        """Return lines to the allocator.  Raises ``ValueError`` for a
        double-free or a line that was never allocated (outside
        ``start..top`` or in the reserved prefix)."""
        for line in np.atleast_1d(np.asarray(lines, np.int64)):
            line = int(line)
            if not self.start <= line < self.top:
                raise ValueError(
                    f"free of never-allocated line {line} "
                    f"(allocated range is {self.start}..{self.top - 1})")
            if line in self._freed:
                raise ValueError(f"double-free of line {line}")
            self._freed.add(line)

