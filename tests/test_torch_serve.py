"""The slice as a whole: the JAX ServeLoop and the port's, one trace.

The mixed trace of ``tests/test_serve.py`` (a shared prefix seeded with
``write_pages``, 3 slots) runs tick by tick through the JAX
``ServeLoop``/``SELCCKVPool`` and through the port's on the CPU, for an
fp32 and a bf16 pool.  Exact: generated tokens, every tick's coherence
rounds, the final rounds-state leaves, the KV readback of every
completion against ``ToyLM.expected_pages``, zero leaked pages.  Within
2e-5 (fp32 attention, summation order): each completion's last attend
output.  Finally a JAX pool state carried across by ``convert`` serves
a further request exactly as the JAX pool does.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.dsm import kvpool as jkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.rounds import check_invariants  # noqa: E402
from repro_torch.dsm import kvpool as tkv  # noqa: E402
from test_serve import _mixed_trace  # noqa: E402

from _torch_serve_side import (GEOM, _host_f32,  # noqa: E402,F401
                               _shared_prefix, _Side)


def _jax_pool(dtype):
    pool = jkv.SELCCKVPool(jkv.KVPoolConfig(dtype=dtype, **GEOM))
    pool.open_rounds_plane()
    return pool


def _port_pool(dtype):
    pool = tkv.SELCCKVPool(tkv.KVPoolConfig(dtype=dtype, **GEOM),
                           device="cpu")
    pool.open_rounds_plane()
    return pool


def _lockstep(jside, tside, trace):
    jreqs, treqs = jside.submit(trace), tside.submit(trace)
    while jside.loop.has_work() or tside.loop.has_work():
        jside.tick()
        tside.tick()
    assert tside.rounds == jside.rounds
    for j, t in zip(jreqs, treqs):
        assert len(t.generated) == t.max_new
        assert t.generated == j.generated
        kp, vp, wr = tside.model.expected_pages(t)
        k, v = tside.readback[t.rid]
        np.testing.assert_array_equal(k[wr], kp[wr])
        np.testing.assert_array_equal(v[wr], vp[wr])
        np.testing.assert_allclose(tside.attn[t.rid], jside.attn[j.rid],
                                   rtol=0, atol=2e-5)
    jstate = {k: np.asarray(v) for k, v in jside.pool.rounds_state.items()}
    tstate = convert.to_numpy(tside.pool.rounds_state)
    assert sorted(jstate) == sorted(tstate)
    for k in jstate:
        assert tstate[k].dtype == jstate[k].dtype, k
        np.testing.assert_array_equal(tstate[k], jstate[k], err_msg=k)
    check_invariants(tside.pool.rounds_state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_trace_matches_jax(dtype):
    jside = _Side(jserve, _jax_pool(dtype))
    tside = _Side(tserve, _port_pool(dtype))
    _lockstep(jside, tside, _mixed_trace(jside.shared))
    assert tside.pool.pages_in_use == len(tside.shared)   # zero leaked
    assert jside.pool.pages_in_use == len(jside.shared)

    # carry the JAX pool across and serve more requests on both.  A
    # set's pop order depends on its history, so the JAX free list is
    # rebuilt from the same sorted pages the carried pool starts from
    alloc = jside.pool._alloc
    freed = sorted(alloc._freed)
    alloc._freed = set(freed)
    carried = convert.pool_from_arrays(
        tside.pool.cfg, {k: np.asarray(v) for k, v in
                         jside.pool.rounds_state.items()},
        alloc_top=alloc.top, alloc_freed=freed, device="cpu")
    jnext = _Side(jserve, jside.pool, prefix=False)
    tnext = _Side(tserve, carried, prefix=False)
    jnext.shared = tnext.shared = tuple(jside.shared)
    _lockstep(jnext, tnext, [([3, 1, 4, 1, 5], 6, True, 4),
                             ([2, 7], 3, False, 0)])


def test_serve_recorder_spans_match_jax():
    """``ServeLoop(recorder=)``: the same trace leaves the same spans
    (verb, batch, rounds, serve totals), heat and snapshot on both
    packages (but the compile count: jit traces there, kernel library
    loads here, none on the CPU), and the loop's Prometheus text
    carries the plane's metrics."""
    from repro.obs import FlightRecorder as JRecorder
    from repro_torch.obs import FlightRecorder
    jrec, trec = JRecorder(512), FlightRecorder(512)
    jside = _Side(jserve, _jax_pool("float32"), recorder=jrec)
    tside = _Side(tserve, _port_pool("float32"), recorder=trec)
    _lockstep(jside, tside, _mixed_trace(jside.shared))
    fields = ("verb", "batch", "rounds", "served", "deferred",
              "replica_served")
    assert trec.total == jrec.total > 0
    assert [[getattr(s, f) for f in fields] for s in trec.spans()] == \
        [[getattr(s, f) for f in fields] for s in jrec.spans()]
    assert all(s.compiled == 0 for s in trec.spans())
    np.testing.assert_array_equal(trec.line_heat, jrec.line_heat)
    np.testing.assert_array_equal(trec.home_heat, jrec.home_heat)
    snap_t, snap_j = trec.snapshot(), jrec.snapshot()
    snap_t.pop("compile_events")
    snap_j.pop("compile_events")
    assert snap_t == snap_j and {"ops", "rmw"} <= set(snap_t["verbs"])
    assert "plane_dispatches_total" in tside.loop.render_prom()
    assert tside.pool.rounds_plane.recorder is trec


def test_sync_oracle_matches_engine():
    """The port's gang-batch oracle (two host-synced plane calls per
    append) emits the engine's tokens."""
    trace = _mixed_trace((), n=5, seed=3)
    eng = _Side(tserve, _port_pool("float32"), prefix=False)
    ereqs = eng.submit(trace)
    assert eng.loop.drain(timeout=120)
    pool = _port_pool("float32")
    sync = tserve.SyncBatchServer(pool, tserve.ToyLM(pool.cfg, n_q_heads=4),
                                  n_slots=3, max_pages=4)
    oreqs = [tserve.ServeRequest(prompt=tuple(p), max_new=g)
             for p, g, _, _ in trace]
    sync.serve(oreqs)
    assert [r.generated for r in oreqs] == [r.generated for r in ereqs]
    assert sync.plane_calls == 2 * sync.steps
    assert pool.pages_in_use == 0
