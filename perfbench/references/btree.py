"""Plain NumPy reference of the B-link tree cells, and the comparison.

It imports nothing of the program.  From the benchmark's own inputs (the
builder's :class:`~perfbench.lib.btree_image.Layout`, the initial image
and the batches) it works out what a run has to produce under SELCC's
guarantees on a write-through plane:

* every lookup returns the value of the last update of its key that was
  acknowledged before the lookup's batch began (a batch runs its lookups
  before its updates), and finds every key;
* memory holds every acknowledged update (the last in slot order of a
  batch wins) and a line's version counts the writes granted on it, one
  a update, since an update is one read-modify-write of its leaf;
* the cache states follow MSI under the S/X latches.  A batch comes from
  one compute node ``n``.  Its descents read every line on each key's
  root-to-leaf path: ``n`` holds the line in S unless it holds M, and a
  holder of M elsewhere is downgraded to S.  Its updates then write their
  leaves: ``n`` holds each in M and every other copy is invalidated;
* the latch word of every line is the directory of its holders (the
  writer byte ``n + 1`` in bits 24-31 of the high lane, reader ``n``'s
  bit in the low lane for ``n < 32``, in the high lane for ``n >= 32``),
  and every holder's copy and version equal memory's.

Stale copies of invalidated lines are the program's to keep or drop;
nothing is compared there.
"""

from __future__ import annotations

import numpy as np

from perfbench.lib import btree_image

I, S, M = 0, 1, 2
WRITER_SHIFT = 24
# each number compared is exact: any difference fails the run
LIMITS = {"lookups_wrong": 0, "image_lines_wrong": 0, "versions_wrong": 0,
          "msi_wrong": 0, "words_wrong": 0, "copies_wrong": 0,
          "readback_wrong": 0}


def directory(cache_state: np.ndarray) -> np.ndarray:
    """Latch words ``[L, 2]`` (hi, lo) int32 of an MSI state ``[N, L]``."""
    hi = np.zeros(cache_state.shape[1], np.int64)
    lo = np.zeros(cache_state.shape[1], np.int64)
    for n in range(cache_state.shape[0]):
        s = cache_state[n] == S
        if n < 32:
            lo += np.where(s, 1 << n, 0)
        else:
            hi += np.where(s, 1 << (n - 32), 0)
        hi += np.where(cache_state[n] == M, (n + 1) << WRITER_SHIFT, 0)
    wrap = lambda x: (((x + 2**31) & 0xFFFFFFFF) - 2**31).astype(np.int32)
    return np.stack([wrap(hi), wrap(lo)], axis=1)


class TreeReference:
    """The tree's expected results, batch by batch."""

    def __init__(self, layout: btree_image.Layout, image: np.ndarray,
                 n_nodes: int):
        self.layout = layout
        self.image0 = image
        self.values = btree_image.initial_values(layout.n_keys)
        self.state = np.zeros((n_nodes, layout.n_lines), np.int8)
        self.version = np.zeros(layout.n_lines, np.int64)

    def read(self, node: int, lines) -> None:
        lines = np.unique(lines)
        mine = self.state[node, lines]
        self.state[node, lines] = np.where(mine == I, S, mine)
        for m in range(self.state.shape[0]):
            if m != node:
                held = self.state[m, lines]
                self.state[m, lines] = np.where(held == M, S, held)

    def write(self, node: int, lines) -> None:
        lines, counts = np.unique(lines, return_counts=True)
        self.state[:, lines] = I
        self.state[node, lines] = M
        self.version[lines] += counts

    def batch(self, node: int, keys, is_read, vals):
        """One batch: returns the lookups' expected ``(values, found)``."""
        keys = np.asarray(keys, np.int64)
        want = self.values[keys[is_read]]
        self.read(node, self.layout.paths(keys).ravel())
        upd = keys[~is_read]
        if upd.size:
            leaves, _ = self.layout.leaf_slot(upd)
            self.write(node, leaves)
            # the last update of a key in slot order wins
            last = len(upd) - 1 - np.unique(upd[::-1], return_index=True)[1]
            self.values[upd[last]] = np.asarray(vals)[~is_read][last]
        return want, np.ones(want.shape, bool)

    def memory(self) -> np.ndarray:
        """The expected payload image: the loaded image with every
        key's current value in its leaf slot."""
        img = self.image0.copy()
        changed = np.flatnonzero(
            self.values != btree_image.initial_values(self.layout.n_keys))
        line, lane = self.layout.leaf_slot(changed)
        img[line, lane] = self.values[changed]
        return img


def lookups_wrong(want, got) -> int:
    """Lookups of one batch whose value or found flag differs."""
    (wv, wf), (gv, gf) = want, got
    if gv is None:
        return int(wv.size)
    return int(((np.asarray(gv) != wv) | (np.asarray(gf) != wf)).sum())


def judge(layout, image, n_nodes: int, traffic, results, state):
    """Feeds the run's batches (``traffic.batch(i)`` for each of
    ``results``, the lookups' ``(values, found)`` or None a batch) to a
    fresh reference and compares; returns ``(reference, counts)``."""
    ref = TreeReference(layout, image, n_nodes)
    ref.read(0, [0])                      # open() reads the metadata line
    wrong = 0
    for i, got in enumerate(results):
        b = traffic.batch(i)
        want = ref.batch(b["node"], b["keys"], b["is_read"], b["vals"])
        if b["is_read"].any():
            wrong += lookups_wrong(want, got)
    return ref, compare(ref, wrong, state)


def compare(ref: TreeReference, n_lookups_wrong: int, state) -> dict:
    """Counts of what differs from ``ref``, after every batch has been
    fed to it: ``n_lookups_wrong`` is the lookups found wrong while the
    batches were fed (:func:`lookups_wrong`), ``state`` the final plane
    (an object with the leaves as host arrays and ``cache_rows(nodes,
    lines)``)."""
    want_mem = ref.memory()
    holders = np.nonzero(ref.state != I)
    out = {
        "lookups_wrong": int(n_lookups_wrong),
        "image_lines_wrong": int((state.mem_data != want_mem)
                                 .any(axis=1).sum()),
        "versions_wrong": int((state.mem_version != ref.version).sum()
                              + (state.cache_version[holders]
                                 != ref.version[holders[1]]).sum()),
        "msi_wrong": int((state.cache_state != ref.state).sum()),
        "words_wrong": int((state.words != directory(ref.state))
                           .any(axis=1).sum()),
    }
    rows = state.cache_rows(*holders)
    out["copies_wrong"] = int((rows != want_mem[holders[1]])
                              .any(axis=1).sum())
    return out
