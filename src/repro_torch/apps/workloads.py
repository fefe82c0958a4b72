"""Device-batch workload generators for the paper's two applications.

A copy of the device-plane half of ``repro/apps/workloads.py``:
:class:`Zipf`, the YCSB-shaped key batches of the B-link tree
(:func:`btree_kv_batches`, Fig. 10) and the TPC-C-shaped transaction
batches of the device txn engine (:func:`device_txn_batches`, Fig. 11).
Same seeds, same draws.  The DES workers are not ported.

The one change: :class:`Zipf` builds its CDF with numpy instead of a
Python loop over two float lists (at 2^24 keys that loop takes about a
gigabyte and tens of seconds).  ``np.cumsum`` adds in the loop's order,
and the normalizer is ``math.fsum``, the correctly rounded sum that the
interpreter's compensated ``sum`` of floats approximates.
"""

from __future__ import annotations

import bisect
import math
import random
from dataclasses import dataclass

import numpy as np


class Zipf:
    """Ranks ``0 .. n-1`` drawn with probability ``∝ 1 / (rank+1)^theta``
    (rank 0 the hottest)."""

    def __init__(self, n: int, theta: float = 0.99):
        probs = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), theta)
        self.cdf = np.cumsum(probs / math.fsum(probs))

    def sample(self, rng: random.Random) -> int:
        return bisect.bisect_left(self.cdf, rng.random())

    def sample_batch(self, rng, size: int):
        """Vectorized draw (``rng`` is a ``numpy.random.Generator``)."""
        return np.searchsorted(self.cdf, rng.random(size)).astype(np.int32)


@dataclass
class TxnBatchConfig:
    """Fig. 11-shaped transaction workload for the device txn loop: each
    batch is B txns mixing NewOrder-style (read 2 tuples, write a
    district counter + order slot + items across several GCLs),
    Payment-style (3 writes), and OrderStatus-style read-only shapes
    over a Zipf-skewed tuple space, plus shuffled TO timestamps —
    clients assign their ts at txn BEGIN, so batch arrival order need
    not match, which is what makes TO aborts real."""
    n_gcls: int = 64
    tuples_per_gcl: int = 8
    batch: int = 16
    iters: int = 8
    max_group_lines: int = 4
    zipf_theta: float = 0.6
    n_nodes: int = 4


def device_txn_batches(cfg: TxnBatchConfig, seed: int = 0):
    """Pre-generated list of ``(txns, node, ts)`` batches — ``txns`` a
    list of host-style ``(read_set, write_set)`` tuple-id pairs capped
    to ``max_group_lines`` distinct GCLs by construction, ``node`` [B]
    the submitting compute node, ``ts`` [B] the shuffled client-side
    TO timestamps (globally unique across batches)."""
    rng = np.random.default_rng(seed)
    T = cfg.tuples_per_gcl
    n_tuples = cfg.n_gcls * T
    zipf = Zipf(cfg.n_gcls, cfg.zipf_theta) if cfg.zipf_theta else None

    def pick_gcls(k):
        if zipf is None:
            gs = rng.choice(cfg.n_gcls, size=min(k, cfg.n_gcls),
                            replace=False)
        else:
            gs = zipf.sample_batch(rng, k)
        return sorted(set(int(g) for g in gs))

    def pick_tuples(gcls, per_gcl):
        out = []
        for g in gcls:
            for s in rng.choice(T, size=min(per_gcl, T), replace=False):
                out.append(g * T + int(s))
        return out

    batches = []
    for b in range(cfg.iters):
        txns = []
        for _ in range(cfg.batch):
            shape = rng.random()
            if shape < 0.5:                          # NewOrder-style
                wg = pick_gcls(min(3, cfg.max_group_lines))
                rg = pick_gcls(1)
                writes = pick_tuples(wg, 2)
                reads = pick_tuples(rg, 2)
            elif shape < 0.85:                       # Payment-style
                wg = pick_gcls(min(2, cfg.max_group_lines))
                writes = pick_tuples(wg, 2)[:3]
                reads = []
            else:                                    # OrderStatus-style
                rg = pick_gcls(min(3, cfg.max_group_lines))
                writes = []
                reads = pick_tuples(rg, 2)
            assert all(t < n_tuples for t in reads + writes)
            txns.append((reads, writes))
        node = rng.integers(0, cfg.n_nodes, cfg.batch).astype(np.int32)
        ts = (b * cfg.batch
              + rng.permutation(cfg.batch)).astype(np.int32)
        batches.append((txns, node, ts))
    return batches


@dataclass
class BTreeBatchConfig:
    """YCSB-shaped key workload for the device B-link tree (Fig. 10):
    each batch is ``(keys [R], is_read [R], vals [R])`` with Zipf-skewed
    key choice — A/B/C are ``read_ratio`` 0.5 / 0.95 / 1.0."""
    n_keys: int = 4096
    r_slots: int = 64
    read_ratio: float = 0.5
    zipf_theta: float = 0.99
    iters: int = 8


def btree_kv_batches(cfg: BTreeBatchConfig, seed: int = 0):
    """Pre-generated key/val batches for ``index.DeviceBTree`` (and a
    host oracle): reads are point lookups, writes are upserts."""
    rng = np.random.default_rng(seed)
    zipf = Zipf(cfg.n_keys, cfg.zipf_theta) if cfg.zipf_theta else None
    out = []
    for _ in range(cfg.iters):
        if zipf is None:
            keys = rng.integers(0, cfg.n_keys,
                                cfg.r_slots).astype(np.int32)
        else:
            keys = zipf.sample_batch(rng, cfg.r_slots)
        is_read = rng.random(cfg.r_slots) < cfg.read_ratio
        vals = rng.integers(1, 1 << 20, cfg.r_slots).astype(np.int32)
        out.append((keys, is_read, vals))
    return out
