"""The port's DES applications against the JAX package's, in process.

Exact throughout (the DES is plain Python, seeded; the generators are
numpy and Python ``random``):

* TPC-C-lite on the DES (``TPCCConfig(warehouses=4)``, every query,
  ``tests/test_apps.py``'s cluster) under 2PL, TO and OCC, plain, with
  a WAL and partitioned over 2PC (``partition_fn =
  tables.partition_of``, cross-warehouse txns): each engine's
  ``TxnStats`` (commits, aborts, abort reasons, latency sum, p50, p99),
  the simulated clock, the fabric's, nodes' and caches' counters and
  the whole heap, through ``tests/test_torch_des.py``'s ``_both``;
* ``micro_worker`` and ``ycsb_worker`` (over ``BLinkTree``) on every
  backend, the same way;
* ``Zipf`` draw for draw at the workers' sizes, ``tpcc_txn``'s sets
  (order included: NewOrder's items are a set) for every query,
  ``TPCCTables.partition_of`` over every tuple id, and
  ``device_rounds_batches``' arrays, with and without skew and payload;
* ``repro_torch.apps`` exports everything ``repro.apps`` does;
* ``chip_smoke.rounds_fig7_phase`` (Fig. 7's op stream through
  ``run_rounds``, flat, sharded and a CPU twin) at a small size.
"""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as japps  # noqa: E402
import repro_torch.apps as tapps  # noqa: E402
from repro.apps import workloads as jwl  # noqa: E402
from repro_torch.apps import workloads as twl  # noqa: E402
from test_torch_des import BACKENDS, _both  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


MODES = {"plain": {}, "wal": {"wal": True},
         "2pc": {"wal": True, "partitioned": True}}


def test_exports_cover_the_reference():
    assert set(japps.__all__) <= set(tapps.__all__)
    for name in ("DeviceRoundsConfig", "device_rounds_batches", "tpcc_txn",
                 "TxnStats"):
        assert name in tapps.__all__
    for cls in ("TxnConfig", "MicroConfig", "YCSBConfig", "TPCCConfig"):
        assert dataclasses.asdict(getattr(tapps, cls)()) == \
            dataclasses.asdict(getattr(japps, cls)()), cls
    assert dataclasses.asdict(tapps.DeviceRoundsConfig()) == \
        dataclasses.asdict(jwl.DeviceRoundsConfig())


# ------------------------------------------------------------- TPC-C

def _tpcc(core, apps, fifo, algo, mode, txns=12, seed=13):
    """``tests/test_apps.py``'s TPC-C cluster: 2 compute nodes, 2 memory
    nodes, 4 threads each, every query mixed."""
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=2, n_memory=2, threads_per_node=4,
        selcc=core.SELCCConfig(cache_capacity=4096)))
    cfg = apps.TPCCConfig(warehouses=4, txns_per_thread=txns,
                          distribution_ratio=0.5 if mode == "2pc" else 0.0)
    tables = apps.TPCCTables(cfg)
    engines = [apps.TxnEngine(layer, nd,
                              apps.TxnConfig(algo=algo, **MODES[mode]),
                              tables.n_tuples)
               for nd in layer.nodes]
    if mode == "2pc":
        for e in engines:
            e.partition_fn = tables.partition_of
    procs = [layer.env.process(apps.tpcc_worker(e, tables, cfg, 0, ni, 2,
                                                t, seed=seed))
             for ni, e in enumerate(engines) for t in range(4)]
    layer.env.run_until_complete(procs, hard_limit=2000)
    return layer, [(e.stats.commits, e.stats.aborts,
                    dict(e.stats.abort_reasons), e.stats.latency_sum,
                    e.stats.p50, e.stats.p99, e.stats.latency.count)
                   for e in engines]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("algo", ["2pl", "to", "occ"])
def test_tpcc_on_the_des_matches(algo, mode):
    fp, stats = _both(_tpcc, algo, mode)
    assert sum(s[0] + s[1] for s in stats) == 2 * 4 * 12
    assert sum(s[0] for s in stats) > 0
    if algo != "2pl":
        assert sum(s[1] for s in stats) > 0, "no abort exercised"
    assert fp["heap"][1]["txn:gcls"], "no GCL directory bound"


def test_partitioned_2pc_pays_more_flushes():
    """A cross-partition commit waits out 2 flushes a participant: the
    DES clock runs longer than with one WAL flush a commit."""
    (fp_wal, _), (fp_2pc, _) = (_both(_tpcc, "2pl", m) for m in
                                ("wal", "2pc"))
    assert fp_2pc["now"] > fp_wal["now"]


# ------------------------------------------------------ micro and YCSB

def _micro(core, apps, fifo, protocol, seed=4):
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=3, n_memory=2, threads_per_node=2, protocol=protocol,
        selcc=core.SELCCConfig(cache_capacity=64)))
    cfg = apps.MicroConfig(n_gcls=96, sharing_ratio=0.5, read_ratio=0.8,
                           locality=0.3, zipf_theta=0.99, ops_per_thread=40)
    gcls = layer.allocate_many(cfg.n_gcls)
    procs = [layer.env.process(apps.micro_worker(nd, gcls, cfg, nd.node_id,
                                                 3, t, seed))
             for nd in layer.nodes for t in range(2)]
    layer.env.run_until_complete(procs, hard_limit=500)
    return layer, layer.total_ops()


def _ycsb(core, apps, fifo, protocol, seed=5):
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=2, n_memory=2, threads_per_node=2, protocol=protocol,
        selcc=core.SELCCConfig(cache_capacity=64)))
    trees = [apps.BLinkTree(layer, nd, fanout=8) for nd in layer.nodes]
    cfg = apps.YCSBConfig(read_ratio=0.5, ops_per_thread=25)
    procs = [layer.env.process(apps.ycsb_worker(tr, cfg, i, t, seed))
             for i, tr in enumerate(trees) for t in range(2)]
    layer.env.run_until_complete(procs, hard_limit=500)
    return layer, [dict(tr.stats) for tr in trees]


@pytest.mark.parametrize("protocol", BACKENDS)
def test_micro_and_ycsb_workers_match(protocol):
    _, ops = _both(_micro, protocol)
    assert ops == 3 * 2 * 40
    _, tree_stats = _both(_ycsb, protocol)
    assert sum(s["splits"] for s in tree_stats) > 0


# ------------------------------------------------------------ generators

@pytest.mark.parametrize("n,theta", [
    (jwl.YCSBConfig().n_keys, jwl.YCSBConfig().zipf_theta),
    (int(jwl.MicroConfig().n_gcls * jwl.MicroConfig().sharing_ratio), 0.99),
    (1 << 20, 0.6)])
def test_zipf_draws_match_at_the_workers_sizes(n, theta):
    jz, tz = jwl.Zipf(n, theta), twl.Zipf(n, theta)
    np.testing.assert_array_equal(tz.cdf, np.asarray(jz.cdf))
    a, b = random.Random(7), random.Random(7)
    assert [tz.sample(a) for _ in range(5000)] == \
        [jz.sample(b) for _ in range(5000)]
    np.testing.assert_array_equal(
        tz.sample_batch(np.random.default_rng(8), 20000),
        jz.sample_batch(np.random.default_rng(8), 20000))


@pytest.mark.parametrize("ratio", [0.0, 0.4])
def test_tpcc_txn_and_partitions_match(ratio):
    jc = jwl.TPCCConfig(warehouses=4, distribution_ratio=ratio)
    tc = twl.TPCCConfig(warehouses=4, distribution_ratio=ratio)
    jt, tt = jwl.TPCCTables(jc), twl.TPCCTables(tc)
    assert vars(tt).keys() == vars(jt).keys()
    assert all(getattr(tt, k) == getattr(jt, k)
               for k in vars(jt) if k != "cfg")
    for q in range(1, 6):
        for seed in range(6):
            a, b = random.Random(seed), random.Random(seed)
            for home in range(4):
                got = twl.tpcc_txn(tt, q, a, home)
                assert got == jwl.tpcc_txn(jt, q, b, home), (q, seed)
                assert all(0 <= t < tt.n_tuples for t in got[0] + got[1])
    ids = range(tt.n_tuples)
    assert [tt.partition_of(t) for t in ids] == \
        [jt.partition_of(t) for t in ids]


@pytest.mark.parametrize("theta", [0.0, 1.1])
@pytest.mark.parametrize("width", [0, 6])
def test_device_rounds_batches_match(theta, width):
    kw = dict(n_nodes=8, n_lines=1024, r_slots=64, read_ratio=0.3,
              zipf_theta=theta, iters=5, payload_width=width)
    want = jwl.device_rounds_batches(jwl.DeviceRoundsConfig(**kw), seed=7)
    got = twl.device_rounds_batches(twl.DeviceRoundsConfig(**kw), seed=7)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert len(g) == len(w) == (4 if width else 3)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    if width:
        _, _, isw, wd = got[0]
        assert (wd[isw == 0] == 0).all() and (wd[isw == 1] > 0).all()


def test_chip_smoke_fig7_rounds_phase_on_cpu():
    """``chip_smoke.rounds_fig7_phase`` on the CPU: the bench's 1024 lines
    at R 64 and a 2^12-line payload run, flat against the twin over the
    touched lines and against four shards."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    res = cs.rounds_fig7_phase(torch.device("cpu"), runs=(
        (1024, 64, 0, False), (1024, 64, 0, True), (1 << 12, 256, 4, True)),
        iters=4)
    assert [r["lines"] for r in res["runs"]] == [1024, 1024, 1 << 12]
    for r in res["runs"]:
        assert r["rounds"] == r["sharded_rounds"]
        assert 1 < r["rounds_per_batch"] <= cs.FIG7_MAX_ROUNDS
        assert 0 < r["lines_touched"] < r["lines"]
