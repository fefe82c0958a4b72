"""The loaded B-link tree: its payload image and the layout behind it.

A copy of the bottom-up builder that ``chip_smoke.py`` uses for its
phase 5, kept here so that later changes to that script do not move
the benchmark.  It writes keys ``0 .. n_keys-1`` with values
``key * 7 + 1`` into the port's node layout (one node a line of
``2 * (fanout + 1) + 6`` int32 lanes: leaf flag, key count, right link,
high-key flag, high key, ``fanout + 1`` key slots, ``fanout + 2`` value
or child slots), leaves of ``fill`` keys spread evenly, internal nodes
of ``fill + 1`` children, each level chained by right links with high
keys, and line 0 the tree's metadata.  This layout is the program's
input format; the reference reads the tree through :class:`Layout`
instead, which is the builder's own record of where each key went.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LEAF, NKEYS, RIGHT, HAS_HIGH, HIGH, KEYS_OFF = 0, 1, 2, 3, 4, 5
META_MAGIC = 0x0B713EE
M_MAGIC, M_ROOT, M_FANOUT, M_HEIGHT, M_TOP = 0, 1, 2, 3, 4


def width(fanout: int) -> int:
    """Payload lanes of one node line."""
    return 2 * (fanout + 1) + 6


def vals_off(fanout: int) -> int:
    return KEYS_OFF + fanout + 1


@dataclass
class Layout:
    """Where the builder put things.  ``levels`` runs from the root to
    the leaves, each ``(first_line, mins)``: the level's nodes are lines
    ``first_line + i``, node ``i`` holding keys from ``mins[i]`` up to
    the next node's.  ``leaf_start[j]`` is leaf ``j``'s first key."""

    n_keys: int
    n_lines: int
    fanout: int
    levels: list
    root: int
    height: int
    top: int

    @property
    def leaf_first_line(self) -> int:
        return self.levels[-1][0]

    @property
    def leaf_start(self) -> np.ndarray:
        return self.levels[-1][1]

    def paths(self, keys) -> np.ndarray:
        """``[len(keys), height]`` lines from the root to each key's
        leaf (the built tree has no splits, so no right-link hops)."""
        keys = np.asarray(keys, np.int64)
        out = np.empty((keys.shape[0], self.height), np.int64)
        for d, (first, mins) in enumerate(self.levels):
            out[:, d] = first + np.searchsorted(mins, keys, "right") - 1
        return out

    def leaf_slot(self, keys):
        """(leaf line, value lane) of each key."""
        keys = np.asarray(keys, np.int64)
        j = np.searchsorted(self.leaf_start, keys, "right") - 1
        return (self.leaf_first_line + j,
                vals_off(self.fanout) + keys - self.leaf_start[j])


def initial_values(n_keys: int) -> np.ndarray:
    return (np.arange(n_keys, dtype=np.int64) * 7 + 1).astype(np.int32)


def build(n_keys: int, n_lines: int, fanout: int, fill: int):
    """Returns ``(image [n_lines, W] int32, Layout)``."""
    cap = fanout + 1
    voff = vals_off(fanout)
    img = np.zeros((n_lines, width(fanout)), np.int32)
    mins = np.arange(n_keys, dtype=np.int64)
    ents = initial_values(n_keys).astype(np.int64)
    top, per, leaf = 1, fill, True
    levels = []
    while True:
        m = -(-len(mins) // per)
        counts = len(mins) // m + (np.arange(m) < len(mins) % m)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lines = top + np.arange(m)
        if lines[-1] >= n_lines:
            raise ValueError(f"{n_keys} keys do not fit {n_lines} lines")
        levels.append((int(lines[0]), mins[start].copy()))
        rows = img[lines[0]:lines[-1] + 1]
        slot = np.arange(per)
        ok = slot[None, :] < counts[:, None]
        at = np.minimum(start[:, None] + slot[None, :], len(mins) - 1)
        rows[:, LEAF] = int(leaf)
        rows[:, RIGHT] = np.append(lines[1:], -1)
        rows[:-1, HAS_HIGH] = 1
        rows[:-1, HIGH] = mins[start[1:]]
        if leaf:
            rows[:, NKEYS] = counts
            rows[:, KEYS_OFF:KEYS_OFF + per] = np.where(ok, mins[at], 0)
            rows[:, voff:voff + per] = np.where(ok, ents[at], 0)
        else:                          # keys: the mins of children 1..
            rows[:, NKEYS] = counts - 1
            kat = np.minimum(at + 1, len(mins) - 1)
            rows[:, KEYS_OFF:KEYS_OFF + per - 1] = np.where(
                ok[:, 1:], mins[kat[:, :-1]], 0)
            rows[:, voff:voff + per] = np.where(ok, ents[at], 0)
        assert per <= cap
        top += m
        if m == 1:
            break
        mins, ents = mins[start], lines.astype(np.int64)
        per, leaf = fill + 1, False
    root = int(lines[0])
    levels.reverse()
    height = len(levels)
    img[0, [M_MAGIC, M_ROOT, M_FANOUT, M_HEIGHT, M_TOP]] = \
        [META_MAGIC, root, fanout, height, top]
    return img, Layout(n_keys, n_lines, fanout, levels, root, height, top)
