"""The flight recorder: the reference's recorder cases on the port's copy,
and a differential of the spans a plane dispatch leaves.

The cases of ``tests/test_obs.py`` (ring wraparound, heat-driven
``plan_rehome``, Chrome-trace export, plane spans, the serve loop's
histograms) run against ``repro_torch.obs``.  The differential drives
one ``ops`` / ``rmw`` / ``descent`` / ``evict`` / ``txn`` sequence
through a JAX flat plane and a port plane (CPU), each with a recorder
attached.  Exact: every span's ``verb``, ``batch``, ``rounds``,
``served``, ``deferred``, ``replica_served`` and ``attrs``, the EWMA
``line_heat`` and ``home_heat``, and ``snapshot()`` but for its
compile count: a span's ``compiled`` is the reference's jit-trace delta
and the port's kernel-library loads (none on the CPU), so the port's
is 0 by construction and the reference's is whatever JAX traced.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rounds as jr  # noqa: E402
from repro.obs import FlightRecorder as JRecorder  # noqa: E402
from repro_torch.core import rounds as tr  # noqa: E402
from repro_torch.core.rounds import txn as ttxn  # noqa: E402
from repro_torch.core.rounds.placement import plan_rehome  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import (FlightRecorder, PlaneTelemetry,  # noqa: E402
                             Span)


def _i32(*xs):
    return np.asarray(xs, np.int32)


def _tele(line_hits, line_whits=None, n_shards=4):
    hits = np.asarray(line_hits, np.int64)
    served = np.zeros(n_shards, np.int64)
    served[0] = hits.sum()
    return PlaneTelemetry.from_counters({
        "occupancy": np.zeros((n_shards, n_shards), np.int64),
        "deferred": np.zeros((n_shards, n_shards), np.int64),
        "served_per_home": served,
        "replica_served": np.zeros(n_shards, np.int64),
        "line_hits": hits,
        "line_whits": (np.zeros_like(hits) if line_whits is None
                       else np.asarray(line_whits, np.int64)),
    })


# ------------------------------------------- the reference's recorder cases

def test_recorder_ring_wraparound():
    rec = FlightRecorder(capacity=4)
    for i in range(10):
        rec.record("ops", duration=1e-4, batch=(8,), rounds=i)
    assert len(rec) == 4 and rec.total == 10 and rec.dropped == 6
    spans = rec.spans()
    assert [s.index for s in spans] == [6, 7, 8, 9]
    assert [s.rounds for s in spans] == [6, 7, 8, 9]
    assert all(isinstance(s, Span) for s in spans)
    c = rec.registry.counter("plane_dispatches_total",
                             labels={"verb": "ops"})
    assert c.value == 10
    assert rec.snapshot()["dropped"] == 6
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_recorder_heat_drives_plan_rehome():
    l, s = 16, 4
    hits = np.zeros(l, np.int64)
    hits[[0, 4, 8]] = [90, 60, 30]
    hits[[1, 5]] = [2, 1]
    rec = FlightRecorder(capacity=16)
    for _ in range(3):
        rec.record("ops", duration=1e-4, batch=(8,), rounds=2,
                   telemetry=_tele(hits, n_shards=s))
    heat = rec.line_heat
    assert heat is not None and heat.shape == (l,)
    assert rec.home_heat is not None and rec.home_heat.shape == (s,)
    perm = np.arange(l)
    lines, homes, _ = plan_rehome(heat, perm, s, max_moves=8,
                                  min_gain=0.5)
    ref = plan_rehome(hits, perm, s, max_moves=8)
    assert lines.tolist() == ref[0].tolist()
    assert homes.tolist() == ref[1].tolist()
    assert 0 not in set(homes.tolist())
    lines2, _, _ = plan_rehome(_tele(hits, n_shards=s), perm, s,
                               max_moves=8)
    assert lines2.tolist() == ref[0].tolist()
    # a tensor directory (plane.state["home"]) plans the same
    lines3, _, _ = plan_rehome(torch.from_numpy(hits),
                               torch.arange(l, dtype=torch.int32), s,
                               max_moves=8)
    assert lines3.tolist() == ref[0].tolist()


def test_chrome_trace_export_is_valid(tmp_path):
    rec = FlightRecorder(capacity=8)
    rec.record("ops", duration=2e-3, batch=(4,), rounds=3,
               telemetry=_tele([1, 0, 2, 0], n_shards=1))
    rec.record("txn", duration=1e-3, batch=(2, 3), rounds=5,
               attrs={"algo": "2pl"})
    path = tmp_path / "trace.json"
    doc = rec.export_chrome_trace(str(path))
    parsed = json.loads(path.read_text())
    assert parsed == doc
    evs = parsed["traceEvents"]
    assert len(evs) == 2
    for ev in evs:
        assert ev["ph"] == "X" and ev["cat"] == "plane"
        assert ev["dur"] > 0 and ev["ts"] >= 0
        assert {"rounds", "served", "deferred", "batch",
                "dispatch"} <= set(ev["args"])
    assert evs[0]["name"] == "ops" and evs[0]["args"]["served"] == 3
    assert evs[1]["args"]["algo"] == "2pl"
    assert evs[1]["args"]["batch"] == [2, 3]
    assert parsed["otherData"]["spans_total"] == 2


def test_plane_spans_add_no_builds():
    """Spans of a warm plane report no kernel library loads; attaching
    the recorder changes nothing the plane computes."""
    plane = tr.DevicePlane.open(tr.make_state(2, 4, payload_width=1,
                                              device="cpu"), n_nodes=2)

    def _store(data, line, val):
        return torch.where((line >= 0)[:, None], val, data)

    def drive():
        plane.ops(_i32(0, 1), _i32(0, 1), _i32(1, 0),
                  np.asarray([[5], [0]], np.int32))
        plane.rmw(_i32(1), _i32(0), modify=_store,
                  operands=(np.asarray([[9]], np.int32),))
        plane.evict(_i32(1), _i32(0))

    drive()
    loads = _build.LOADS
    rec = FlightRecorder(capacity=16)
    plane.attach_recorder(rec)
    drive()
    assert _build.LOADS == loads
    assert rec.total == 3
    ops_s, rmw_s, evict_s = rec.spans()
    assert (ops_s.verb, rmw_s.verb, evict_s.verb) == ("ops", "rmw",
                                                      "evict")
    assert all(s.compiled == 0 for s in rec.spans())
    assert ops_s.served == 2 and ops_s.batch == (2,)
    assert rmw_s.served == 2
    assert evict_s.served == 0
    assert rec.line_heat is not None and rec.line_heat.shape == (4,)
    assert rec.line_heat[0] > rec.line_heat[2]
    reg = rec.registry
    assert reg.counter("plane_dispatches_total",
                       labels={"verb": "ops"}).value == 1
    assert reg.counter("plane_compile_events_total").value == 0
    assert "plane_dispatch_seconds_bucket" in reg.render_prom()
    plane.attach_recorder(None)
    drive()
    assert rec.total == 3
    plane.check()


def test_span_counts_kernel_library_loads(monkeypatch):
    """``compiled`` is the change of ``_build.LOADS`` over a dispatch."""
    plane = tr.DevicePlane.open(tr.make_state(2, 4, device="cpu"),
                                recorder=FlightRecorder(8))
    real = tr.run_rounds

    def loading(*a, **kw):
        _build.LOADS += 2
        return real(*a, **kw)
    import repro_torch.core.rounds.driver as drv
    monkeypatch.setattr(drv, "run_rounds", loading)
    plane.ops(_i32(0), _i32(1), _i32(0))
    assert plane.recorder.spans()[-1].compiled == 2
    assert plane.recorder.snapshot()["compile_events"] == 2


def test_serve_loop_histograms():
    from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool
    from repro_torch.serve import ServeLoop, ToyLM
    cfg = KVPoolConfig(n_pages=24, page_size=4, n_kv_heads=2,
                       head_dim=4, n_replicas=2, dtype="float32")
    pool = SELCCKVPool(cfg, device="cpu")
    pool.open_rounds_plane()
    rec = FlightRecorder(capacity=64)
    loop = ServeLoop(pool, ToyLM(cfg), n_slots=2, max_pages=4,
                     queue_capacity=8, recorder=rec)
    reqs = [loop.submit([1, 2], 3) for _ in range(3)]
    assert loop.drain(timeout=120)
    assert all(r.generated for r in reqs)
    st = loop.stats()
    assert st.queue_wait is not None and st.queue_wait["count"] == 3
    assert st.tpot is not None and st.tpot["count"] == 6
    prom = loop.render_prom()
    assert "serve_queue_wait_seconds_count 3" in prom
    assert "serve_tpot_seconds_count 6" in prom
    assert "plane_dispatches_total" in prom
    assert rec.total > 0
    assert {"rmw"} <= set(rec.snapshot()["verbs"])


# ------------------------------------------------ JAX plane vs port plane

def _jax_next(data, key):
    """Descent transition: lane 0 names the next line, -1 a leaf."""
    nxt = data[:, 0]
    return nxt < 0, jnp.zeros(nxt.shape, bool), nxt


def _port_next(data, key):
    nxt = data[:, 0]
    return nxt < 0, torch.zeros(nxt.shape, dtype=torch.bool), nxt


def _jax_store(data, line, val):
    return jnp.where((line >= 0)[:, None], val, data)


def _port_store(data, line, val):
    return torch.where((line >= 0)[:, None], val, data)


def _drive(plane, store, step, n_nodes, n_lines, width):
    """A seeded mixed-verb sequence; lines 0..7 take ops, RMWs,
    descents and evictions, lines 8.. the transactions."""
    rng = np.random.default_rng(3)
    chain = np.arange(8, dtype=np.int32)
    wd = np.zeros((8, width), np.int32)
    wd[:, 0] = np.where(chain >= 7, -1, chain + 1)
    plane.ops(chain % n_nodes, chain, np.ones(8, np.int32), wd)
    for b in range(6):
        r = 6
        node = rng.integers(0, n_nodes, r).astype(np.int32)
        line = rng.integers(0, 8, r).astype(np.int32)
        line[rng.random(r) < 0.2] = -1
        isw = (rng.random(r) < 0.5).astype(np.int32)
        wd = np.zeros((r, width), np.int32)
        # lane 0: a chain 0 -> 1 -> ... -> 7 -> leaf
        wd[:, 0] = np.where(line >= 7, -1, line + 1)
        wd[:, 1:] = rng.integers(0, 1000, (r, width - 1))
        plane.ops(node, line, isw, wd)
        rl = np.unique(rng.integers(0, 8, 3)).astype(np.int32)
        val = np.zeros((rl.size, width), np.int32)
        val[:, 0] = np.where(rl >= 7, -1, rl + 1)
        val[:, 1] = 100 + b
        plane.rmw(rng.integers(0, n_nodes, rl.size).astype(np.int32), rl,
                  modify=store, operands=(val,))
        roots = rng.integers(0, 8, 4).astype(np.int32)
        roots[0] = -1
        plane.descent(rng.integers(0, n_nodes, 4).astype(np.int32),
                      np.zeros(4, np.int32), roots, transition=step)
        plane.evict(node[:2], line[:2])
    g = 3
    glines = np.array([[8, 9, -1], [9, 11, 12], [10, -1, -1],
                       [8, 12, -1]], np.int32)
    t = 4                               # txn_payload_width(4) lanes
    rmask = np.ones((4, g, t), np.int32)
    wmask = np.zeros((4, g, t), np.int32)
    wmask[:, 0, 0] = 1
    for algo in ("2pl", "to"):
        plane.txn(np.arange(4, dtype=np.int32) % n_nodes, glines, rmask,
                  wmask, np.arange(4, dtype=np.int32) + 1, algo=algo)


def test_spans_and_heat_match_the_reference():
    n_nodes, n_lines = 3, 16
    width = ttxn.txn_payload_width(4)
    jrec, trec = JRecorder(256), FlightRecorder(256)
    jp = jr.DevicePlane.open(jr.make_state(n_nodes, n_lines,
                                           payload_width=width),
                             n_nodes=n_nodes, recorder=jrec)
    tp = tr.DevicePlane.open(tr.make_state(n_nodes, n_lines,
                                           payload_width=width,
                                           device="cpu"),
                             n_nodes=n_nodes, recorder=trec)
    _drive(jp, _jax_store, _jax_next, n_nodes, n_lines, width)
    _drive(tp, _port_store, _port_next, n_nodes, n_lines, width)
    js, ts = jrec.spans(), trec.spans()
    assert len(js) == len(ts) == 1 + 6 * 4 + 2
    fields = ("index", "verb", "batch", "rounds", "served", "deferred",
              "replica_served", "attrs")
    for a, b in zip(js, ts):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields], (a, b)
        assert b.compiled == 0
    assert {s.verb for s in ts} == {"ops", "rmw", "descent", "evict",
                                    "txn"}
    assert any(s.served for s in ts if s.verb == "descent")
    np.testing.assert_array_equal(trec.line_heat, jrec.line_heat)
    np.testing.assert_array_equal(trec.home_heat, jrec.home_heat)
    snap_j, snap_t = jrec.snapshot(), trec.snapshot()
    assert snap_t.pop("compile_events") == 0
    snap_j.pop("compile_events")
    assert snap_t == snap_j
    for k, v in jp.state.items():
        np.testing.assert_array_equal(tp.state[k].numpy(), np.asarray(v),
                                      k)
    # one registry each, the same counts
    for name in ("plane_rounds_total", "plane_dispatches_total"):
        for verb in ("ops", "rmw", "descent", "evict", "txn"):
            lbl = {"verb": verb}
            assert trec.registry.counter(name, labels=lbl).value == \
                jrec.registry.counter(name, labels=lbl).value
