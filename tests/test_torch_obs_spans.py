"""The layer spans and counters of ``repro_torch.obs`` inside the plane
and the round engine, on the CPU.

Tracing off: a tree batch leaves the registry as it was and makes no
annotation.  Under ``torch.profiler``: the spans appear, nested under
their verb, each as often as its annotation; ``engine.round`` runs once
a round.  On a clock the test drives, seconds and self seconds are
exact.  The counters are exact: a descent copies ``8 L + 16`` bytes of
telemetry and makes ``steps + 1 + 12`` blocking reads.  Sessions keep
their own totals, and the registry keeps the newest two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from _torch_threads import _one_thread  # noqa: E402,F401
from repro_torch import obs  # noqa: E402
from repro_torch.obs import recorder  # noqa: E402
from repro_torch.core import rounds  # noqa: E402
from repro_torch.core.rounds import engine  # noqa: E402
from repro_torch.index import DeviceBTree  # noqa: E402

N_LINES = 512
VERBS = ("plane.ops", "plane.rmw", "plane.descent", "plane.txn",
         "plane.evict")
INNER = ("engine.round", "plane.spin_sync", "plane.result_copy",
         "plane.telemetry_copy")


def _tree():
    tree = DeviceBTree.create(4, N_LINES, fanout=16, device="cpu")
    keys = np.arange(200, dtype=np.int32)
    tree.insert_batch(keys, keys * 3 + 1)
    return tree


def _rounds_run():
    return sum(n for k, n in engine.TRACE_COUNTS.items() if k[0] == "round")


def _batch(tree, node=1):
    keys = np.arange(0, 200, 3, dtype=np.int32)
    vals, found = tree.lookup_batch(keys, node=node)
    assert found.all() and (vals == keys * 3 + 1).all()
    tree.insert_batch(keys[:16], keys[:16] + 7, node=node)


def test_the_profilers_flag_turns_tracing_on():
    """``obs`` reads the profiler's own flag at each site; this pins its
    name on the installed PyTorch."""
    assert profiler._is_profiler_enabled is False
    assert not obs.TRACER.active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        assert obs.TRACER.active()
    assert not obs.TRACER.active()
    with obs.tracing():
        assert obs.TRACER.active()
    assert not obs.TRACER.active()


def test_a_batch_with_tracing_off_writes_nothing(monkeypatch):
    tree = _tree()
    made = []
    real = profiler.record_function

    def counting(*args, **kwargs):
        made.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(profiler, "record_function", counting)
    before = obs.TRACER.registry.snapshot()
    session = obs.TRACER.session
    _batch(tree)
    assert made == []
    assert obs.TRACER.registry.snapshot() == before
    assert obs.TRACER.session == session


def _annotations(prof):
    """{name: [(start_ns, end_ns)]} of the program's spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("plane.", "engine.")):
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_spans_under_the_profiler():
    tree = _tree()
    r0 = _rounds_run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _batch(tree)
    rounds_run = _rounds_run() - r0
    got = _annotations(prof)
    assert {"plane.descent", "plane.rmw", *INNER} <= set(got)
    verbs = sorted(iv for v in VERBS for iv in got.get(v, []))
    for name in ("engine.round", "plane.spin_sync"):
        for s, e in got[name]:
            assert any(vs <= s and e <= ve for vs, ve in verbs), name
    totals = obs.session_totals()
    assert totals["session"] == obs.TRACER.session
    spans = totals["spans"]
    assert len(got["engine.round"]) == rounds_run \
        == spans["engine.round"]["count"]
    assert {name: len(ivs) for name, ivs in got.items()} == \
        {name: sp["count"] for name, sp in spans.items()}


def _clock(monkeypatch, step_ns=0):
    """Puts the spans on a clock the test drives: ``now[0]`` ns, which
    each read then advances by ``step_ns``."""
    now = [0]

    def read():
        now[0] += step_ns
        return now[0] - step_ns
    monkeypatch.setattr(recorder, "_clock", read)
    return now


def test_self_seconds_subtract_the_nested_spans(monkeypatch):
    """Seconds and self seconds of a verb > round > copy and verb >
    spin nest, exact: a span's self time loses its children's time, not
    its grandchildren's."""
    now = _clock(monkeypatch)
    ms = 1_000_000
    with obs.tracing():
        with obs.span("plane.rmw"):
            now[0] += 5 * ms
            for _ in range(3):
                with obs.span("engine.round"):
                    now[0] += 2 * ms
                    with obs.span("plane.result_copy"):
                        now[0] += 7 * ms
                with obs.span("plane.spin_sync"):
                    now[0] += 1 * ms
            now[0] += 4 * ms
    spans = obs.session_totals()["spans"]
    want = {"plane.rmw": (1, 39, 9), "engine.round": (3, 27, 6),
            "plane.result_copy": (3, 21, 21), "plane.spin_sync": (3, 3, 3)}
    assert set(spans) == set(want)
    for name, (n, secs, own) in want.items():
        assert spans[name] == {"count": n,
                               "seconds": pytest.approx(secs * 1e-3),
                               "self_seconds": pytest.approx(own * 1e-3)}


def test_a_descents_spans_on_a_driven_clock(monkeypatch):
    """A real descent on a clock that ticks 1 us a read: the verb holds
    ``steps`` rounds and ``steps + 1`` spin checks (one read each side
    of each), a result copy and a telemetry copy, so it lasts ``1 + 2 x
    (2 steps + 3)`` ticks and keeps ``1 + (2 steps + 3)`` of them."""
    tree = _tree()
    _clock(monkeypatch, step_ns=1000)
    b = 64
    with obs.tracing():
        res = tree.plane.descent(
            np.full(b, 2, np.int32), np.arange(b, dtype=np.int32) * 2,
            np.full(b, tree.root, np.int32),
            transition=tree.codec.descend_step, path_cap=16)
    steps = res.rounds
    assert steps > 1
    us = 1e-6
    spans = obs.session_totals()["spans"]
    want = {"plane.descent": (1, (4 * steps + 7) * us, (2 * steps + 4) * us),
            "engine.round": (steps, steps * us, steps * us),
            "plane.spin_sync": (steps + 1, (steps + 1) * us,
                                (steps + 1) * us),
            "plane.result_copy": (1, us, us),
            "plane.telemetry_copy": (1, us, us)}
    assert set(spans) == set(want)
    for name, (n, secs, own) in want.items():
        assert spans[name] == {"count": n, "seconds": pytest.approx(secs),
                               "self_seconds": pytest.approx(own)}, name


def test_counters_of_one_descent_are_exact():
    tree = _tree()
    b = 64
    keys = np.arange(b, dtype=np.int32) * 2
    with obs.tracing():
        res = tree.plane.descent(
            np.full(b, 2, np.int32), keys, np.full(b, tree.root, np.int32),
            transition=tree.codec.descend_step, path_cap=16)
    c = obs.session_totals()["counters"]
    assert c["plane.telemetry_bytes"] == 8 * N_LINES + 16
    assert c["plane.host_reads"] == res.rounds + 1 + 12
    spans = obs.session_totals()["spans"]
    assert spans["engine.round"]["count"] == res.rounds
    assert spans["plane.spin_sync"]["count"] == res.rounds + 1
    assert spans["plane.descent"]["count"] == 1


def test_counters_of_ops_and_rmw_are_exact():
    plane = rounds.DevicePlane.open(
        rounds.make_state(4, 64, payload_width=4, device="cpu"))
    node = np.array([0, 1, 2, 3], np.int32)
    line = np.array([5, 5, 9, 11], np.int32)
    with obs.tracing():
        res = plane.ops(node, line, np.array([1, 1, 0, 1], np.int32),
                        np.ones((4, 4), np.int32))
        c = obs.session_totals()["counters"]
        assert c["plane.host_reads"] == res.rounds + 1 + 2 + 6
        assert c["plane.telemetry_bytes"] == 8 * 64 + 16
        rmw = plane.rmw(np.array([0, 1], np.int32),
                        np.array([3, 4], np.int32),
                        modify=lambda d, ln: d + 1)
    c = obs.session_totals()["counters"]
    # two spin phases (each one check more than its rounds), two result
    # copies and six telemetry copies
    assert c["plane.host_reads"] == res.rounds + 9 + rmw.rounds + 2 + 8
    assert c["plane.telemetry_bytes"] == 2 * (8 * 64 + 16)


def test_sharded_shards_are_rounds_too():
    mesh = rounds.Mesh(4, device="cpu")
    plane = rounds.DevicePlane.open(
        rounds.make_sharded_state(4, 64, mesh, payload_width=4), mesh)
    r0 = _rounds_run()
    with obs.tracing():
        plane.ops(np.arange(8, dtype=np.int32) % 4,
                  np.arange(8, dtype=np.int32) * 7 % 64,
                  np.ones(8, np.int32), np.ones((8, 4), np.int32))
    spans = obs.session_totals()["spans"]
    assert spans["engine.round"]["count"] == _rounds_run() - r0 > 0
    assert spans["plane.ops"]["count"] == 1


def test_sessions_keep_their_own_totals():
    tree = _tree()
    with obs.tracing():
        tree.lookup_batch(np.arange(8, dtype=np.int32))
    first = obs.TRACER.session
    one = obs.session_totals()
    tree.lookup_batch(np.arange(8, dtype=np.int32))        # tracing off
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            tree.lookup_batch(np.arange(8, dtype=np.int32))
    two = obs.session_totals()
    assert two["session"] == first + 1
    for name in ("plane.descent", "plane.telemetry_copy"):
        assert one["spans"][name]["count"] == 1
        assert two["spans"][name]["count"] == 2
    assert two["counters"]["plane.telemetry_bytes"] == \
        2 * one["counters"]["plane.telemetry_bytes"]

    def descents(session):
        line = f'trace_span_total{{session="{session}",span="plane.descent"}}'
        got = [ln for ln in obs.TRACER.registry.render_prom().splitlines()
               if ln.startswith(line + " ")]
        return float(got[0].split()[1]) if got else None
    assert (descents(first), descents(first + 1)) == (1, 2)
    # a new switch-on is a new session even with no site between; the
    # registry then keeps the last two sessions and drops the first
    with obs.tracing():
        tree.lookup_batch(np.arange(8, dtype=np.int32))
    assert obs.TRACER.session == first + 2
    assert (descents(first), descents(first + 1),
            descents(first + 2)) == (None, 2, 1)
