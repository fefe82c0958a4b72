"""Typed global addresses — the paper's 8-byte global pointer (Sec. 3).

A copy of ``repro/core/addressing.py``.  ``GAddr(node_id, offset)`` is
a ``NamedTuple``, so it unpacks and compares like the raw pair; the
device side uses flat int32 line indices, and ``GAddr.flat`` /
``GAddr.from_flat`` convert, striping lines across homes like
``home_of``.
"""

from __future__ import annotations

from typing import NamedTuple

_OFFSET_BITS = 48
_OFFSET_MASK = (1 << _OFFSET_BITS) - 1


class GAddr(NamedTuple):
    """Global cache-line address: (memory NodeID, line offset)."""

    node_id: int
    offset: int

    # -- 8-byte wire format (paper Sec. 3: 16-bit node | 48-bit offset) ----
    def pack(self) -> int:
        return (self.node_id << _OFFSET_BITS) | (self.offset & _OFFSET_MASK)

    @classmethod
    def unpack(cls, v: int) -> "GAddr":
        return cls(v >> _OFFSET_BITS, v & _OFFSET_MASK)

    # -- flat (device-side) representation ---------------------------------
    def flat(self, n_homes: int) -> int:
        """Flat line index with round-robin striping: the inverse of
        ``from_flat`` and consistent with ``home_of`` (home = idx % homes)."""
        return self.offset * n_homes + self.node_id

    @classmethod
    def from_flat(cls, index: int, n_homes: int) -> "GAddr":
        return cls(index % n_homes, index // n_homes)

    def __repr__(self) -> str:  # keep benchmarks' CSV rows compact
        return f"GAddr({self.node_id}, {self.offset})"


def as_gaddr(value) -> GAddr:
    """Coerce a legacy ``(mid, line)`` tuple (or a GAddr) to a GAddr."""
    if isinstance(value, GAddr):
        return value
    mid, line = value
    return GAddr(mid, line)


def home_of(page_index: int, n_homes: int) -> int:
    """Home memory node of a flat page index (striped placement)."""
    return page_index % n_homes
