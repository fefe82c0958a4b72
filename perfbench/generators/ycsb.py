"""The YCSB core-workload generator: batches of point lookups and updates.

Reads a traffic file's ``readproportion`` / ``updateproportion``,
``requestdistribution`` (``zipfian``, with ``zipfianconstant``),
``scrambled``, ``batch`` and ``work_seed``, and the configuration's
``recordcount`` and ``nodes``.  Batch ``i`` is drawn from generators of
its own, seeded by ``(work_seed, i)`` and ``(seed, i)``, so a batch is
the same whether it was drawn in set-up or later.  Each batch holds
exactly ``round(batch * readproportion)`` lookups, in a shuffled order,
so every seed gives the same sizes; the keys are chosen as YCSB's core
workload chooses them (``lib/zipf.py``: ranks over 10^10 items, hashed
onto the keys) when ``scrambled`` is true, and are Zipf ranks over the
keys otherwise; update values are drawn from ``1 .. 2^20 - 1``.  The
batches' compute nodes take turns: batch ``i`` comes from node
``i % nodes``.

The draws that set a batch's work (its Zipf ranks and which slots are
lookups) come from ``(work_seed, i)`` and are the same for every run;
the run's seed rotates the whole key space by an offset of its own,
shuffles each batch's slots and draws the update values.  Every seed
then meets the same hot-key multiplicities (a leaf's updates serialize,
so they set a batch's read-modify-write steps) on other keys, in another
order, with other values.

Compared with the repository's ``btree_kv_batches``: that one draws Zipf
ranks over the key count and maps them straight to keys (the hottest
keys 0-11 share leaf 0, so their updates serialize), draws each slot's
operation at random (the share of lookups varies from batch to batch),
and builds its CDF in a Python loop.
"""

from __future__ import annotations

import numpy as np

from perfbench.lib.zipf import KeyChooser


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int):
        if abs(mix["readproportion"] + mix["updateproportion"] - 1) > 1e-9:
            raise ValueError("this generator draws lookups and updates "
                             "only: readproportion + updateproportion "
                             "must be 1")
        self.n_keys = int(config["recordcount"])
        self.n_nodes = int(config["nodes"])
        self.size = int(mix["batch"])
        self.n_read = int(round(self.size * mix["readproportion"]))
        if mix["requestdistribution"] != "zipfian":
            raise ValueError("this generator draws zipfian requests only")
        self.chooser = KeyChooser(self.n_keys, float(mix["zipfianconstant"]),
                                  bool(mix["scrambled"]))
        self.seed = int(seed) % 2**64
        self.work_seed = int(mix["work_seed"]) % 2**64
        self.offset = int(np.random.default_rng([self.seed, 0]).integers(
            self.n_keys))
        self._cache: dict = {}

    def batch(self, i: int) -> dict:
        """``{"node", "keys" int32 [B], "is_read" bool [B], "vals" int32
        [B]}`` of batch ``i``."""
        got = self._cache.get(i)
        if got is not None:
            return got
        work = np.random.default_rng([self.work_seed, i, 1])
        mine = np.random.default_rng([self.seed, i, 1])
        keys = self.chooser.keys(work, self.size)
        is_read = np.zeros(self.size, bool)
        is_read[work.permutation(self.size)[:self.n_read]] = True
        order = mine.permutation(self.size)
        keys = (keys[order] + self.offset) % self.n_keys
        is_read = is_read[order]
        vals = mine.integers(1, 1 << 20, self.size, dtype=np.int32)
        got = {"node": i % self.n_nodes, "keys": keys.astype(np.int32),
               "is_read": is_read, "vals": vals}
        self._cache[i] = got
        return got

    def ops(self, b: dict) -> int:
        return int(b["keys"].shape[0])
