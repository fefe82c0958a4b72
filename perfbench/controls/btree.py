"""The tree cells' control: the reference with coherence taken out.

It stands in the program's place and breaks the guarantee the
configuration states, that every acknowledged update reads back under
SELCC's latches: each compute node keeps the copy of a leaf it fetched
first and reads its own copy from then on, an update goes to memory and
to the updating node's copy only, other nodes' copies are neither
invalidated nor recorded in the latch words (every word stays 0).  Its
outputs go through the same comparison as the program's; a sound
comparison finds them wrong (``words_wrong`` in every cell, and stale
lookups, MSI states and copies where there are updates).
"""

from __future__ import annotations

import numpy as np

from perfbench.lib import btree_image
from perfbench.references.btree import I, M, S


class Control:
    def __init__(self, layout: btree_image.Layout, image: np.ndarray,
                 n_nodes: int):
        self.layout = layout
        self.image0 = image
        self.values = btree_image.initial_values(layout.n_keys)
        self.copies = np.repeat(self.values[None, :], n_nodes, axis=0)
        self.state = np.zeros((n_nodes, layout.n_lines), np.int8)
        self.version = np.zeros(layout.n_lines, np.int64)
        self.results = []
        self.state[0, 0] = S                  # the open's metadata read

    def _fetch(self, node: int, leaves) -> None:
        """The node's first copy of each leaf it did not hold."""
        new = np.unique(leaves[self.state[node, leaves] == I])
        if not new.size:
            return
        j = new - self.layout.leaf_first_line
        start = self.layout.leaf_start[j]
        stop = np.append(self.layout.leaf_start, self.layout.n_keys)[j + 1]
        keys = np.concatenate([np.arange(a, b) for a, b in zip(start, stop)])
        self.copies[node, keys] = self.values[keys]

    def batch(self, node: int, keys, is_read, vals) -> None:
        keys = np.asarray(keys, np.int64)
        paths = self.layout.paths(keys)
        self._fetch(node, paths[:, -1])
        look = keys[is_read]
        self.results.append((self.copies[node, look].copy(),
                             np.ones(look.shape, bool))
                            if look.size else None)
        touched = np.unique(paths)
        self.state[node, touched] = np.maximum(self.state[node, touched], S)
        upd = keys[~is_read]
        if upd.size:
            v = np.asarray(vals)[~is_read]
            self.values[upd] = v           # slot order: the last one wins
            self.copies[node, upd] = v
            leaves, _ = self.layout.leaf_slot(upd)
            self.state[node, np.unique(leaves)] = M
            np.add.at(self.version, leaves, 1)

    def host_state(self):
        """The final plane as the comparison reads it."""
        mem = self.image0.copy()
        line, lane = self.layout.leaf_slot(np.arange(self.layout.n_keys))
        mem[line, lane] = self.values
        control = self

        class State:
            words = np.zeros((self.layout.n_lines, 2), np.int32)
            cache_state = self.state
            cache_version = np.repeat(self.version[None, :],
                                      self.state.shape[0], axis=0)
            mem_version = self.version
            mem_data = mem

            @staticmethod
            def cache_rows(nodes, lines):
                rows = control.image0[lines].copy()
                j = lines - control.layout.leaf_first_line
                leaf = (j >= 0) & (j < control.layout.leaf_start.shape[0])
                j = j[leaf]
                start = control.layout.leaf_start[j]
                count = rows[leaf, btree_image.NKEYS]
                voff = btree_image.vals_off(control.layout.fanout)
                sub = rows[leaf]
                for s in range(int(count.max(initial=0))):
                    has = s < count
                    sub[has, voff + s] = control.copies[
                        nodes[leaf][has], start[has] + s]
                rows[leaf] = sub
                return rows
        return State


def run(config: dict, traffic, reference, n_batches: int) -> dict:
    """The control over the first ``n_batches`` batches, judged."""
    image, layout = btree_image.build(
        int(config["recordcount"]), int(config["lines"]),
        int(config["fanout"]), int(config["fill"]))
    c = Control(layout, image, int(config["nodes"]))
    for i in range(n_batches):
        b = traffic.batch(i)
        c.batch(b["node"], b["keys"], b["is_read"], b["vals"])
    return reference.judge(layout, image, int(config["nodes"]), traffic,
                           c.results, c.host_state())[1]
