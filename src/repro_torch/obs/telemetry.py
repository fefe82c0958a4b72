"""`PlaneTelemetry` — ONE typed record for the fused loops' counters.

Pre-obs, telemetry was an ad-hoc dict: the sharded drivers returned six
loosely-named arrays in ``PlaneResult.stats``, the FLAT drivers returned
``{}`` (so every consumer grew an ``if res.stats:`` guard), and
``placement.py`` documented its inputs by dict-key spelling.  This
module is the schema both planes now share: every verb — flat or
sharded — returns one :class:`PlaneTelemetry` whose per-line counters
are diff-able bit-for-bit between a flat plane and any shard count on
the same op trace (the flat differential oracles assert exactly that).

Field geometry (S = home shards, 1 on a flat plane; L = lines):

* ``occupancy``     [S, S] — request-bucket entries SENT per (source,
  home) per round, summed over the spin (flat: ops presented per
  round, all in the single [0, 0] cell);
* ``deferred``      [S, S] — entries deferred on bucket overflow (flat:
  always 0 — nothing crosses a transport);
* ``served_per_home`` [S]  — ops served at each home's slab;
* ``replica_served``  [S]  — reads served from the source shard's local
  replica image (flat: 0 — the flat engine has no replica serve path);
* ``line_hits``       [L]  — served ops per LINE id (home-slot counters
  remapped through the directory; the placement probe signal);
* ``line_whits``      [L]  — the write subset of ``line_hits``.

The record is also a read-only mapping (``tele["line_hits"]``,
``dict(tele)``) so counter-dict call sites port mechanically, and
``__add__`` accumulates across verbs/batches (``sum(teles,
PlaneTelemetry.zeros(...))`` or plain ``a + b``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

__all__ = ["PlaneTelemetry"]

_LINE_KEYS = ("line_hits", "line_whits")


@dataclass(frozen=True)
class PlaneTelemetry:
    """Congestion/serve counters of one fused dispatch (or a sum)."""

    occupancy: np.ndarray        # [S, S] bucket entries sent
    deferred: np.ndarray         # [S, S] bucket-overflow defers
    served_per_home: np.ndarray  # [S] ops served at each home
    replica_served: np.ndarray   # [S] replica-served reads per source
    line_hits: np.ndarray        # [L] served ops per line
    line_whits: np.ndarray       # [L] served writes per line

    # ------------------------------------------------------ constructors
    @classmethod
    def zeros(cls, n_shards: int, n_lines: int) -> "PlaneTelemetry":
        s, l = int(n_shards), int(n_lines)
        return cls(occupancy=np.zeros((s, s), np.int64),
                   deferred=np.zeros((s, s), np.int64),
                   served_per_home=np.zeros((s,), np.int64),
                   replica_served=np.zeros((s,), np.int64),
                   line_hits=np.zeros((l,), np.int64),
                   line_whits=np.zeros((l,), np.int64))

    @classmethod
    def from_counters(cls, counters) -> "PlaneTelemetry":
        """Adopt a device counter dict (the fused drivers' trailing
        ``tele`` element, hit counters already remapped to LINE ids)."""
        return cls(**{f.name: np.asarray(counters[f.name], np.int64)
                      for f in fields(cls)})

    # --------------------------------------------------------- geometry
    @property
    def n_shards(self) -> int:
        return int(self.served_per_home.shape[0])

    @property
    def n_lines(self) -> int:
        return int(self.line_hits.shape[0])

    # ---------------------------------------------------------- totals
    @property
    def served(self) -> int:
        """All served ops: home serves plus replica serves."""
        return int(self.served_per_home.sum()
                   + self.replica_served.sum())

    @property
    def deferred_total(self) -> int:
        return int(self.deferred.sum())

    @property
    def write_fraction(self) -> float:
        hits = int(self.line_hits.sum())
        return float(self.line_whits.sum()) / hits if hits else 0.0

    # ------------------------------------------------------ accumulation
    def __add__(self, other) -> "PlaneTelemetry":
        if isinstance(other, int) and other == 0:   # sum() start value
            return self
        if not isinstance(other, PlaneTelemetry):
            return NotImplemented
        return PlaneTelemetry(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in fields(self)})

    __radd__ = __add__

    # ------------------------------------------------- mapping protocol
    def keys(self):
        return tuple(f.name for f in fields(self))

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self.keys():
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self.keys()

    def __iter__(self):
        return iter(self.keys())

    def items(self):
        return tuple((k, getattr(self, k)) for k in self.keys())

    def get(self, key, default=None):
        return getattr(self, key) if key in self.keys() else default

    def as_dict(self) -> dict:
        return dict(self.items())

    def __eq__(self, other) -> bool:
        if not isinstance(other, PlaneTelemetry):
            return NotImplemented
        return all(np.array_equal(getattr(self, f.name),
                                  getattr(other, f.name))
                   for f in fields(self))

    def __repr__(self) -> str:
        return (f"PlaneTelemetry(S={self.n_shards}, L={self.n_lines}, "
                f"served={self.served}, deferred={self.deferred_total}, "
                f"writes={int(self.line_whits.sum())})")
