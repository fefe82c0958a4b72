"""The host DES and the ``SELCCLayer`` bridge: the port's copies against
the JAX package's.

Exact throughout (the DES is plain Python, seeded):

* the host-form latch-word helpers of ``core/coherence.py`` over seeded
  words;
* scripted and seeded workloads of ``tests/test_protocol.py``,
  ``test_system.py``, ``test_api_parity.py`` and ``test_fifo_mode.py``
  on both packages' ``SELCCLayer``, for every registered backend: the
  simulated clock, every node's and the fabric's counters, the cache
  statistics, the memory nodes' latch words and versions, the heap's
  objects and bindings, the recorded histories, and a clean teardown
  (``assert_released``) on both;
* ``SELCCLayer.as_plane(device="cpu")`` against the reference's
  ``as_plane()``: the same op batches give the same versions, payloads
  and state leaves; ``make_kv_pool`` opens a legacy pool.

Each package drives its own DES workers (``apps.parity_worker``);
``tests/test_torch_des_apps.py`` holds the port's copies of the
workloads and the transaction engine against the reference's with this
file's ``_both`` harness.
"""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps as japps  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.apps as tapps  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import coherence as jco  # noqa: E402
from repro.core.fifo_mode import FIFONode as JFIFONode  # noqa: E402
from repro_torch.core import coherence as tco  # noqa: E402
from repro_torch.core.fifo_mode import FIFONode as TFIFONode  # noqa: E402

BACKENDS = ["selcc", "sel", "gam", "rpc"]
PKGS = {"jax": (jcore, japps, JFIFONode), "port": (tcore, tapps, TFIFONode)}


# ----------------------------------------------------------- host form

def test_host_form_helpers_match():
    rng = random.Random(0)
    words = [0, jco.WORD_MASK, jco.READER_MASK, 1 << 63]
    words += [rng.getrandbits(64) for _ in range(200)]
    words += [jco.pack(rng.choice([None, *range(56)]),
                       rng.sample(range(56), rng.randrange(6)))
              for _ in range(200)]
    for name in ("MAX_NODES", "WRITER_SHIFT", "READER_MASK", "WORD_MASK",
                 "FREE", "STATE_NAMES", "PEER_EVENTS", "MSI_ON_PEER",
                 "LANE_READERS", "HI_READER_BITS", "WRITER_SHIFT_HI"):
        assert getattr(tco, name) == getattr(jco, name), name
    for w in words:
        for fn in ("writer_of", "readers_of", "has_readers", "holders_of",
                   "is_free", "to_lanes"):
            assert getattr(tco, fn)(w) == getattr(jco, fn)(w), (fn, w)
        d = rng.getrandbits(64)
        assert tco.faa(w, d) == jco.faa(w, d)
        hi, lo = jco.to_lanes(w)
        assert tco.from_lanes(hi, lo) == jco.from_lanes(hi, lo) == w
    for n in range(56):
        assert tco.writer_field(n) == jco.writer_field(n)
        assert tco.reader_bit(n) == jco.reader_bit(n)
        assert tco.pack(n, [n, 3]) == jco.pack(n, [n, 3])
    for st in range(3):
        for ev in range(3):
            assert tco.on_peer(st, ev) == jco.on_peer(st, ev)
    for bad in (-1, 56):
        for mod in (tco, jco):
            with pytest.raises(ValueError, match="out of range"):
                mod.reader_bit(bad)
            with pytest.raises(ValueError, match="out of range"):
                mod.writer_field(bad)


# ------------------------------------------------------- DES workloads

def _plain(obj):
    """A heap object as plain data: each package has its own classes
    (the B-link tree's ``_Node``), equal field by field."""
    if dataclasses.is_dataclass(obj):
        return type(obj).__name__, dataclasses.asdict(obj)
    return obj


def _fingerprint(layer):
    """Everything a run leaves that both packages must agree on."""
    def stats(obj):
        s = getattr(obj, "stats", None)
        return None if s is None else dict(vars(s))
    out = {"now": layer.env.now, "fabric": dict(vars(layer.fabric.stats)),
           "mem": [(dict(m.words), dict(m.mem_version))
                   for m in layer.fabric.mem],
           "nodes": [(stats(n), getattr(n, "history", None),
                      stats(getattr(n, "cache", None)))
                     for n in layer.nodes],
           "agents": [stats(a) for a in layer.agents],
           "heap": ({g: _plain(o) for g, o in layer.heap._objs.items()},
                    dict(layer.heap._bindings)),
           "cache": layer.cache_stats(), "ops": layer.total_ops(),
           "inv_ratio": layer.inv_ratio()}
    return out


def _both(run, *args, **kw):
    """``run(core, apps, fifo, ...)`` on each package; fingerprints and
    return values must be equal."""
    res = {}
    for name, mods in PKGS.items():
        layer, value = run(*mods, *args, **kw)
        layer.assert_released()
        res[name] = (_fingerprint(layer), value)
    assert res["port"][0] == res["jax"][0]
    assert res["port"][1] == res["jax"][1]
    assert res["port"][0]["now"] > 0
    return res["port"]


def _drive(core, apps, fifo, protocol="selcc", n_compute=4, threads=4,
           ops=60, n_gcls=64, read_ratio=0.5, cache=32, seed=1,
           **selcc_kw):
    """``tests/test_protocol.py``'s ``drive`` (at a smaller size)."""
    selcc = core.SELCCConfig(cache_capacity=cache, record_history=True,
                             **selcc_kw)
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=n_compute, n_memory=2, threads_per_node=threads,
        protocol=protocol, selcc=selcc, seed=seed))
    gcls = layer.allocate_many(n_gcls)
    procs = []
    for node in layer.nodes:
        for t in range(threads):
            def worker(node=node, t=t,
                       rng=random.Random(seed * 999 + node.node_id * 31
                                         + t)):
                for _ in range(ops):
                    g = gcls[rng.randrange(n_gcls)]
                    if rng.random() < read_ratio:
                        yield from node.op_read(g, thread=t)
                    else:
                        yield from node.op_write(g, thread=t)
            procs.append(layer.env.process(worker()))
    layer.env.run_until_complete(procs, hard_limit=500.0)
    hist = core.merge_histories(layer.nodes) \
        if protocol == "selcc" else None
    return layer, hist


@pytest.mark.parametrize("protocol", BACKENDS)
@pytest.mark.parametrize("seed,read_ratio", [(2, 0.5), (3, 0.1)])
def test_protocol_workload_matches(protocol, seed, read_ratio):
    fp, hist = _both(_drive, protocol=protocol, seed=seed,
                     read_ratio=read_ratio)
    assert fp["ops"] == 4 * 4 * 60
    if hist is not None:
        jcore.check_sequential_consistency(hist)
        tcore.check_sequential_consistency(hist)


def test_fairness_mechanisms_off_match():
    _both(_drive, read_ratio=0.3, seed=5, enable_handover=False,
          enable_lease=False, enable_spin_window=False)


def _mixed(core, apps, fifo, protocol, seed=21, read_ratio=0.9,
           locality=0.6):
    """``tests/test_system.py``'s ``_run_mixed`` (at a smaller size)."""
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=4, n_memory=2, threads_per_node=2, protocol=protocol,
        selcc=core.SELCCConfig(cache_capacity=128)))
    gcls = layer.allocate_many(256)
    procs = []
    for node in layer.nodes:
        for t in range(2):
            def worker(node=node, t=t,
                       rng=random.Random(seed + node.node_id * 17 + t)):
                prev = None
                for _ in range(60):
                    g = prev if (prev and rng.random() < locality) \
                        else gcls[rng.randrange(256)]
                    prev = g
                    if rng.random() < read_ratio:
                        yield from node.op_read(g, thread=t)
                    else:
                        yield from node.op_write(g, thread=t)
            procs.append(layer.env.process(worker()))
    layer.env.run_until_complete(procs, hard_limit=500)
    return layer, layer.throughput()


@pytest.mark.parametrize("protocol", BACKENDS)
def test_system_mixed_workload_matches(protocol):
    _both(_mixed, protocol)


def _parity(core, apps, fifo, protocol):
    """``tests/test_api_parity.py``'s scripted workload."""
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=2, n_memory=2, threads_per_node=2, protocol=protocol,
        selcc=core.SELCCConfig(cache_capacity=64)))
    gcls = layer.allocate_many(8)
    for g in gcls:
        layer.seed_object(g, 0)
    procs = [layer.env.process(apps.parity_worker(node, gcls, rounds=2,
                                                  stride=3))
             for node in layer.nodes]
    layer.env.run_until_complete(procs, hard_limit=50)
    return layer, {g: layer.heap.load(g) for g in gcls}


def _btree(core, apps, fifo, protocol):
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=2, n_memory=2, threads_per_node=2, protocol=protocol,
        selcc=core.SELCCConfig(cache_capacity=64)))
    tree = apps.BLinkTree(layer, layer.nodes[0], fanout=8)

    def work():
        for i in range(80):
            yield from tree.insert(i, i * 7)
        v = yield from tree.lookup(37)
        out = yield from tree.range_scan(10, 30)
        return v, out
    p = layer.env.process(work())
    layer.env.run_until_complete([p], hard_limit=200)
    return layer, p.value


@pytest.mark.parametrize("protocol", BACKENDS)
def test_api_parity_workloads_match(protocol):
    _, image = _both(_parity, protocol)
    assert any(v > 0 for v in image.values())
    _, (v, scan) = _both(_btree, protocol)
    assert v == 37 * 7 and [k for k, _ in scan] == list(range(10, 40))


def _fifo(core, apps, fifo_cls):
    """``tests/test_fifo_mode.py``'s drain case."""
    layer = core.SELCCLayer(core.ClusterConfig(
        n_compute=3, n_memory=2, threads_per_node=4,
        selcc=core.SELCCConfig(cache_capacity=512)))
    fifo = [fifo_cls(nd) for nd in layer.nodes]
    gcls = layer.allocate_many(64)
    procs = []
    for f in fifo:
        def worker(f=f, rng=random.Random(f.node_id)):
            for _ in range(60):
                yield from f.op_write(gcls[rng.randrange(64)])
            yield from f.drain()
        procs.append(layer.env.process(worker()))
    layer.env.run_until_complete(procs, hard_limit=500)
    totals = []

    def audit():
        t = 0
        for g in gcls:
            t += yield from fifo[0].node.op_read(g)
        totals.append(t)
    p = layer.env.process(audit())
    layer.env.run_until_complete([p], hard_limit=1000)
    return layer, (totals, [dict(vars(f.fstats)) for f in fifo])


def test_fifo_mode_matches():
    _, (totals, _) = _both(_fifo)
    assert totals == [180]


@pytest.mark.parametrize("protocol", BACKENDS)
def test_leaked_scope_is_detected_alike(protocol):
    for core in (jcore, tcore):
        layer = core.SELCCLayer(core.ClusterConfig(
            n_compute=2, n_memory=2, threads_per_node=2,
            protocol=protocol))
        g = layer.allocate()

        def leak(node=layer.nodes[0]):
            yield from node.slocked(g)
        p = layer.env.process(leak())
        layer.env.run_until_complete([p], hard_limit=10)
        with pytest.raises(AssertionError, match="leaked"):
            layer.assert_released()


def test_registry_and_allocator_contracts():
    assert tcore.available_protocols() == jcore.available_protocols()
    layer = tcore.SELCCLayer()
    g = layer.allocate()
    assert isinstance(g, tcore.GAddr) and tuple(g) == (0, 0)
    layer.free(g)
    with pytest.raises(ValueError, match="double free"):
        layer.free(g)
    with pytest.raises(ValueError, match="unknown protocol"):
        tcore.get_protocol("nope")
    with pytest.raises(AttributeError, match="side channel"):
        layer._btree_root  # noqa: B018


# ----------------------------------------------------------- the bridge

def _layers():
    cfg = dict(n_compute=4, n_memory=2, threads_per_node=2)
    return (jcore.SELCCLayer(jcore.ClusterConfig(**cfg)),
            tcore.SELCCLayer(tcore.ClusterConfig(**cfg)))


@pytest.mark.parametrize("write_back", [False, True])
def test_as_plane_matches_the_reference(write_back):
    jl, tl = _layers()
    for layer in (jl, tl):
        layer.allocate_many(20)
    jp = jl.as_plane(payload_width=4, write_back=write_back)
    tp = tl.as_plane(payload_width=4, write_back=write_back, device="cpu")
    assert tp.n_lines == jp.n_lines == 20 and tp.n_nodes == jp.n_nodes
    rng = np.random.default_rng(4)
    for _ in range(4):
        node = rng.integers(0, 4, 12).astype(np.int32)
        line = rng.integers(0, 20, 12).astype(np.int32)
        isw = (rng.random(12) < 0.4).astype(np.int32)
        wd = rng.integers(0, 1 << 30, (12, 4)).astype(np.int32)
        jr, tr_ = jp.ops(node, line, isw, wd), tp.ops(node, line, isw, wd)
        np.testing.assert_array_equal(tr_.version, jr.version)
        np.testing.assert_array_equal(tr_.data, jr.data)
        assert tr_.rounds == jr.rounds
        for k, v in jp.state.items():
            np.testing.assert_array_equal(tp.state[k].numpy(),
                                          np.asarray(v), k)
    tp.check()
    g = tl.allocate()
    assert tl.line_to_gaddr(tl.gaddr_to_line(g)) == g
    assert tl.gaddr_to_line(g) == jl.gaddr_to_line(g)
    st = tl.as_rounds_state(device="cpu")
    assert sorted(st) == sorted(jl.as_rounds_state())
    # a Mesh gives the sharded plane (lines padded to the shard count),
    # which serves the same ops as the flat plane; anything else raises
    from repro_torch.core.rounds import Mesh
    mesh = Mesh(4, device="cpu")
    sp = tl.as_plane(payload_width=4, write_back=write_back, mesh=mesh)
    fp = tl.as_plane(payload_width=4, write_back=write_back,
                     n_lines=sp.n_lines, device="cpu")
    assert sp.sharded and sp.n_shards == 4 and sp.n_lines % 4 == 0
    assert sp.n_lines >= tl.as_rounds_state(device="cpu")["words"].shape[0]
    assert sp.n_nodes == fp.n_nodes == 4
    for _ in range(3):
        node = rng.integers(0, 4, 10).astype(np.int32)
        line = rng.integers(0, 20, 10).astype(np.int32)
        isw = (rng.random(10) < 0.4).astype(np.int32)
        wd = rng.integers(0, 1 << 30, (10, 4)).astype(np.int32)
        a, b = sp.ops(node, line, isw, wd), fp.ops(node, line, isw, wd)
        np.testing.assert_array_equal(a.version, b.version)
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.telemetry.line_hits,
                                      b.telemetry.line_hits)
    for k, v in sp.flat_state().items():
        assert torch.equal(v, fp.state[k]), k
    with pytest.raises(TypeError, match="Mesh"):
        tl.as_plane(mesh=object(), device="cpu")


def test_make_kv_pool_opens_a_legacy_pool():
    from repro_torch.dsm.kvpool import KVPoolConfig
    cfg = KVPoolConfig(n_pages=8, page_size=4, n_kv_heads=2, head_dim=8,
                       n_replicas=2, cache_slots=4, dtype="float32")
    pool = tcore.SELCCLayer.make_kv_pool(cfg, device="cpu")
    assert pool.rounds_plane is None and pool.cfg == cfg
    page = pool.allocate(1)
    k = np.arange(16, dtype=np.float32).reshape(1, 2, 8)
    pool.append(page, [2], k, -k, replica=1)
    kk, vv, hit = pool.read(0, page)
    assert not hit[0]
    assert np.array_equal(kk[0, 2].numpy(), k[0])
    assert np.array_equal(vv[0, 2].numpy(), -k[0])
    # a Mesh-backed pool serves the same appends and reads; anything
    # else raises
    from repro_torch.core.rounds import Mesh
    sharded = tcore.SELCCLayer.make_kv_pool(cfg, mesh=Mesh(4, device="cpu"))
    assert sharded.device.type == "cpu" and sharded.cfg == cfg
    sharded.open_rounds_plane()
    assert sharded.rounds_plane.n_shards == 4
    page = sharded.allocate(1)
    sharded.append(page, [2], k, -k, replica=1)
    kk, vv, hit = sharded.read(0, page)
    assert not hit[0]
    assert np.array_equal(kk[0, 2].numpy(), k[0])
    assert np.array_equal(vv[0, 2].numpy(), -k[0])
    with pytest.raises(TypeError, match="Mesh"):
        tcore.SELCCLayer.make_kv_pool(cfg, mesh=object(), device="cpu")


def test_chip_smoke_bridge_phase_on_cpu():
    """``chip_smoke.py``'s DES bridge at a small size on the CPU."""
    import pathlib
    import sys
    from repro_torch.dsm.kvpool import KVPoolConfig
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    res = cs.bridge_phase(torch.device("cpu"), width=8, kv_cfg=KVPoolConfig(
        n_pages=8, page_size=4, n_kv_heads=2, head_dim=8, n_replicas=4,
        cache_slots=4))
    assert res["plane_lines"] > 0 and res["cache"]["hits"] > 0
