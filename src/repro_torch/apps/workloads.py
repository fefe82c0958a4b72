"""Workload generators: micro (Sec. 9.1), YCSB (Sec. 9.2), TPC-C-lite
(Sec. 9.3), the scripted cross-backend parity workload, and the batch
generators of the device plane.

A copy of ``repro/apps/workloads.py``.  The DES workers
(:func:`micro_worker`, :func:`ycsb_worker`, :func:`tpcc_worker`,
:func:`parity_worker`) are generators that drive a node of the host
DES's Table-1 facade (``repro_torch.core.SELCCLayer``) or a
:class:`~repro_torch.apps.txn.TxnEngine`; the batch generators
(:func:`device_rounds_batches`, :func:`device_txn_batches`,
:func:`btree_kv_batches`) return numpy arrays for the rounds plane, the
device transaction engine and the device B-link tree.  Same seeds, same
draws.

Scaled to DES size: the paper's 16M-op / 50M-key runs shrink ~100x; every
knob (sharing ratio, read ratio, zipf theta, locality) is preserved so
the figures' ratios reproduce, not their absolute x-axes.
"""

from __future__ import annotations

import bisect
import functools
import random
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.addressing import GAddr


@functools.lru_cache(maxsize=4)
def _zipf_cdf(n: int, theta: float) -> np.ndarray:
    """The reference's CDF bit for bit: Python's ``**`` (libm ``pow``;
    numpy's vectorised power differs in the last bit at some ranks), the
    interpreter's compensated ``sum`` of floats, and the running sum in
    rank order (``np.cumsum`` adds in that order).  Cached read-only:
    the applications draw several batch lists from one (n, theta), and
    at 2^24 ranks one CDF takes seconds."""
    probs = [1.0 / ((i + 1) ** theta) for i in range(n)]
    cdf = np.cumsum(np.asarray(probs) / sum(probs))
    cdf.setflags(write=False)
    return cdf


class Zipf:
    """Ranks ``0 .. n-1`` drawn with probability ``∝ 1 / (rank+1)^theta``
    (rank 0 the hottest)."""

    def __init__(self, n: int, theta: float = 0.99):
        self.cdf = _zipf_cdf(n, theta)

    def sample(self, rng: random.Random) -> int:
        return bisect.bisect_left(self.cdf, rng.random())

    def sample_batch(self, rng, size: int):
        """Vectorized draw (``rng`` is a ``numpy.random.Generator``)."""
        return np.searchsorted(self.cdf, rng.random(size)).astype(np.int32)


# ------------------------------------------------------------ DES workers

@dataclass
class MicroConfig:
    n_gcls: int = 24_000            # paper: 24M
    sharing_ratio: float = 1.0      # fraction accessible by all nodes
    read_ratio: float = 0.95
    locality: float = 0.0           # P(repeat previous address)
    zipf_theta: float = 0.0         # 0 = uniform
    ops_per_thread: int = 200


def micro_worker(node, gcls: Sequence[GAddr], cfg: MicroConfig,
                 node_id: int, n_nodes: int, thread: int, seed: int):
    """DES generator: one worker thread of the micro-benchmark."""
    rng = random.Random((seed * 7919 + node_id * 131 + thread) & 0x7FFFFFFF)
    n = len(gcls)
    n_shared = int(n * cfg.sharing_ratio)
    priv = (n - n_shared) // max(1, n_nodes)
    priv_base = n_shared + node_id * priv
    zipf = Zipf(n_shared, cfg.zipf_theta) if cfg.zipf_theta else None
    prev = None
    for _ in range(cfg.ops_per_thread):
        if prev is not None and rng.random() < cfg.locality:
            g = prev
        elif n_shared and (priv == 0 or rng.random() < cfg.sharing_ratio):
            i = zipf.sample(rng) if zipf else rng.randrange(n_shared)
            g = gcls[i]
        else:
            g = gcls[priv_base + rng.randrange(max(priv, 1))]
        prev = g
        if rng.random() < cfg.read_ratio:
            yield from node.op_read(g, thread=thread)
        else:
            yield from node.op_write(g, thread=thread)


@dataclass
class YCSBConfig:
    n_keys: int = 200_000           # paper: 50M
    read_ratio: float = 0.95
    zipf_theta: float = 0.99
    ops_per_thread: int = 100


def ycsb_worker(tree, cfg: YCSBConfig, node_id: int, thread: int,
                seed: int):
    """DES generator: one YCSB client thread over a ``BLinkTree``."""
    rng = random.Random((seed * 104729 + node_id * 31 + thread)
                        & 0x7FFFFFFF)
    zipf = Zipf(cfg.n_keys, cfg.zipf_theta) if cfg.zipf_theta else None
    for _ in range(cfg.ops_per_thread):
        k = zipf.sample(rng) if zipf else rng.randrange(cfg.n_keys)
        if rng.random() < cfg.read_ratio:
            yield from tree.lookup(k)
        else:
            yield from tree.insert(k, (node_id, thread))


# ------------------------------------------------- device rounds plane

@dataclass
class DeviceRoundsConfig:
    """YCSB-shaped workload for the device-resident rounds plane (flat
    or sharded): each batch is R op slots (node, line, is_write) with
    Zipf-skewed line choice — the same knobs as :class:`YCSBConfig`
    (read mix, theta), expressed as arrays instead of DES processes."""
    n_nodes: int = 4
    n_lines: int = 1024
    r_slots: int = 64
    read_ratio: float = 0.95
    zipf_theta: float = 0.99
    iters: int = 16
    payload_width: int = 0          # > 0: batches carry [R, W] write bytes


def device_rounds_batches(cfg: DeviceRoundsConfig, seed: int = 0):
    """Pre-generated list of ``(node, line, is_write)`` int32 batches for
    ``rounds.run_rounds`` / ``run_rounds_sharded``.  Duplicates are
    legal (the engine coalesces); contention comes from the Zipf skew
    exactly as in the YCSB figures.  With ``cfg.payload_width=W`` each
    batch widens to ``(node, line, is_write, wdata[R, W])`` — random
    nonzero values on write slots, zeros on reads — for driving a
    payload-plane state."""
    rng = np.random.default_rng(seed)
    zipf = Zipf(cfg.n_lines, cfg.zipf_theta) if cfg.zipf_theta else None
    out = []
    for _ in range(cfg.iters):
        node = rng.integers(0, cfg.n_nodes, cfg.r_slots).astype(np.int32)
        if zipf is None:
            line = rng.integers(0, cfg.n_lines,
                                cfg.r_slots).astype(np.int32)
        else:
            line = zipf.sample_batch(rng, cfg.r_slots)
        is_w = (rng.random(cfg.r_slots) >= cfg.read_ratio) \
            .astype(np.int32)
        if cfg.payload_width:
            wdata = rng.integers(
                1, 1 << 20,
                (cfg.r_slots, cfg.payload_width)).astype(np.int32)
            wdata *= is_w[:, None]
            out.append((node, line, is_w, wdata))
        else:
            out.append((node, line, is_w))
    return out


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


# ------------------------------------------------- cross-backend parity

def parity_worker(node, gcls: Sequence[GAddr], rounds: int, stride: int):
    """Deterministic, commutative workload for the backend parity tests:
    every op is an increment under an exclusive scope or a read under a
    shared scope, so the final memory image is interleaving-independent
    and must be bit-identical across selcc / sel / gam / rpc.

    Drives the full v2 surface on purpose: scope guards, batched
    ``xlocked_many``, ``h.value``/``h.store``, and ``h.release``.
    """
    reads = []
    for r in range(rounds):
        for i in range(0, len(gcls), stride):
            h = yield from node.xlocked(gcls[i])
            yield from h.store((h.value or 0) + 1)
            yield from h.release()
        # shared-scope sweep: every line observed under an S latch
        for g in gcls:
            h = yield from node.slocked(g)
            reads.append(h.value)
            yield from h.release()
        # batched multi-lock: increment a window atomically w.r.t. latches
        window = list(gcls[: min(4, len(gcls))])
        hs = yield from node.xlocked_many(window)
        for h in hs:
            yield from h.store((h.value or 0) + 1)
        yield from node.release_all(hs)
    return reads


# ------------------------------------------------------------- TPC-C-lite

@dataclass
class TPCCConfig:
    warehouses: int = 32            # paper: 256
    districts: int = 10
    customers: int = 300            # per district (scaled from 3000)
    stock: int = 1000               # per warehouse (scaled from 100k)
    txns_per_thread: int = 40
    distribution_ratio: float = 0.0  # P(cross-warehouse access)


class TPCCTables:
    """Tuple-id layout for the lite schema (ids feed TxnEngine)."""

    def __init__(self, cfg: TPCCConfig):
        self.cfg = cfg
        c = cfg
        self.wh0 = 0
        self.di0 = self.wh0 + c.warehouses
        self.cu0 = self.di0 + c.warehouses * c.districts
        self.st0 = self.cu0 + c.warehouses * c.districts * c.customers
        self.or0 = self.st0 + c.warehouses * c.stock
        self.n_tuples = self.or0 + c.warehouses * 4096   # order heap

    def warehouse(self, w):
        return self.wh0 + w

    def district(self, w, d):
        return self.di0 + w * self.cfg.districts + d

    def customer(self, w, d, cid):
        return self.cu0 + (w * self.cfg.districts + d) \
            * self.cfg.customers + cid

    def stock_item(self, w, i):
        return self.st0 + w * self.cfg.stock + i

    def order_slot(self, w, o):
        return self.or0 + w * 4096 + (o % 4096)

    def partition_of(self, t: int) -> int:
        """Warehouse that owns tuple t (2PC participant mapping)."""
        c = self.cfg
        if t >= self.or0:
            return (t - self.or0) // 4096
        if t >= self.st0:
            return (t - self.st0) // c.stock
        if t >= self.cu0:
            return (t - self.cu0) // (c.districts * c.customers)
        if t >= self.di0:
            return (t - self.di0) // c.districts
        return t - self.wh0


def tpcc_txn(tables: TPCCTables, q: int, rng: random.Random, home_w: int):
    """Returns (read_set, write_set) for query Q1..Q5 (paper's 3 update +
    2 read mix: Q1=NewOrder Q2=Payment Q4=Delivery update; Q3=OrderStatus
    Q5=StockLevel read)."""
    c = tables.cfg

    def pick_w():
        if rng.random() < c.distribution_ratio:
            return rng.randrange(c.warehouses)
        return home_w
    d = rng.randrange(c.districts)
    if q == 1:                                         # NewOrder
        w = pick_w()
        # a set, iterated as such: its order is the write set's order
        items = {tables.stock_item(pick_w(), rng.randrange(c.stock))
                 for _ in range(10)}
        reads = [tables.warehouse(w),
                 tables.customer(w, d, rng.randrange(c.customers))]
        writes = [tables.district(w, d),
                  tables.order_slot(w, rng.randrange(4096))] + list(items)
        return reads, writes
    if q == 2:                                         # Payment
        w = pick_w()
        return ([], [tables.warehouse(w), tables.district(w, d),
                     tables.customer(w, d, rng.randrange(c.customers))])
    if q == 3:                                         # OrderStatus (read)
        w = home_w
        return ([tables.customer(w, d, rng.randrange(c.customers))]
                + [tables.order_slot(w, rng.randrange(4096))
                   for _ in range(5)], [])
    if q == 4:                                         # Delivery
        w = home_w
        return ([], [tables.order_slot(w, rng.randrange(4096))
                     for _ in range(10)])
    # Q5: StockLevel (read-heavy scan)
    w = home_w
    return ([tables.district(w, d)]
            + [tables.stock_item(w, rng.randrange(c.stock))
               for _ in range(50)], [])


def tpcc_worker(engine, tables: TPCCTables, cfg: TPCCConfig, query: int,
                node_id: int, n_nodes: int, thread: int, seed: int):
    """DES generator: one TPC-C client thread over a ``TxnEngine``
    (``query`` 0 mixes Q1..Q5 uniformly)."""
    rng = random.Random((seed * 65537 + node_id * 257 + thread)
                        & 0x7FFFFFFF)
    homes = [w for w in range(cfg.warehouses) if w % n_nodes == node_id] \
        or [0]
    for _ in range(cfg.txns_per_thread):
        q = query if query else rng.choice([1, 2, 3, 4, 5])
        home_w = rng.choice(homes)
        reads, writes = tpcc_txn(tables, q, rng, home_w)
        yield from engine.run(reads, writes, thread=thread)
