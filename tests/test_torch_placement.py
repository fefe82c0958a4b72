"""Placement and layout: the port's planners, the flat ``rehome`` /
``replicate`` verbs and the stripe helpers against the JAX package's.

Exact throughout (integer state and plain-numpy policies):

* ``plan_rehome`` / ``plan_replication`` on seeded hit signals (raw
  counts, EWMA heat, a ``PlaneTelemetry``) return the reference's picks;
* a seeded op trace on a flat plane with a home directory and a replica
  plane, with ``replicate`` (on and off) and ``rehome`` calls between
  batches, leaves every state leaf, version and payload equal to the
  JAX flat plane's after every call, and the guards of both verbs raise
  the reference's errors;
* ``stripe_state`` / ``unstripe_state`` equal the reference's with and
  without a home directory, and round-trip.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import rounds as jr  # noqa: E402
from repro.core.rounds import placement as jpl  # noqa: E402
from repro.core.rounds import state as jst  # noqa: E402
from repro_torch.core import rounds as tr  # noqa: E402
from repro_torch.core.rounds import placement as tpl  # noqa: E402
from repro_torch.core.rounds import state as tst  # noqa: E402
from repro_torch.obs import EwmaHeat  # noqa: E402


def _same_state(j, t, where=""):
    assert sorted(j) == sorted(t), where
    for k, v in j.items():
        a = np.asarray(v)
        b = t[k].cpu().numpy()
        assert b.dtype == a.dtype, (where, k)
        np.testing.assert_array_equal(b, a, err_msg=f"{where}: {k}")


# ------------------------------------------------------------- planners

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_rehome_matches(seed):
    rng = np.random.default_rng(seed)
    l, s = 64, 4
    hits = rng.zipf(1.5, l).astype(np.int64)
    perm = rng.permutation(l).astype(np.int32)
    heat = EwmaHeat(l, alpha=0.3)
    for _ in range(3):
        heat.update(hits)
    for signal in (hits, heat.values):
        for kw in ({}, {"max_moves": 3}, {"min_gain": 5.0}):
            want = jpl.plan_rehome(signal, perm, s, **kw)
            got = tpl.plan_rehome(signal, perm, s, **kw)
            for a, b in zip(want, got):
                assert b.dtype == a.dtype
                np.testing.assert_array_equal(b, a)
            got = tpl.plan_rehome(torch.from_numpy(np.asarray(signal)),
                                  torch.from_numpy(perm), s, **kw)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="match in length"):
        tpl.plan_rehome(hits[:-1], perm, s)


def _telemetries(seed):
    """The same PlaneTelemetry, from a JAX and a port flat plane."""
    rng = np.random.default_rng(seed)
    jp = jr.DevicePlane.open(jr.make_state(4, 32, payload_width=2))
    tp = tr.DevicePlane.open(tr.make_state(4, 32, payload_width=2,
                                           device="cpu"))
    node = rng.integers(0, 4, 48).astype(np.int32)
    line = (rng.zipf(1.3, 48) % 32).astype(np.int32)
    isw = (rng.random(48) < 0.1).astype(np.int32)
    wd = rng.integers(0, 99, (48, 2)).astype(np.int32)
    return (jp.ops(node, line, isw, wd).telemetry,
            tp.ops(node, line, isw, wd).telemetry)


@pytest.mark.parametrize("seed", [3, 4])
def test_plan_replication_matches(seed):
    jt, tt = _telemetries(seed)
    for kw in ({}, {"top_k": 3}, {"max_write_frac": 0.0},
               {"min_hits": 3.0}):
        want = jpl.plan_replication(jt, **kw)
        got = tpl.plan_replication(tt, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        want = jpl.plan_replication(jt.line_hits * 0.5, jt.line_whits,
                                    **kw)
        got = tpl.plan_replication(tt.line_hits * 0.5,
                                   torch.from_numpy(tt.line_whits), **kw)
        np.testing.assert_array_equal(got, want)
    assert tpl.plan_replication(tt).size > 0
    for mod in (jpl, tpl):
        with pytest.raises(ValueError, match="line_whits required"):
            mod.plan_replication(np.ones(4))
        with pytest.raises(ValueError, match="match in shape"):
            mod.plan_replication(np.ones(4), np.ones(3))


# -------------------------------------------------- the placement verbs

@pytest.mark.parametrize("write_back", [False, True])
def test_rehome_and_replicate_in_a_trace(write_back):
    n_nodes, n_lines, width = 4, 16, 3
    geom = dict(write_back=write_back, payload_width=width,
                home_directory=True, replicas=True)
    jp = jr.DevicePlane.open(jr.make_state(n_nodes, n_lines, **geom))
    tp = tr.DevicePlane.open(tr.make_state(n_nodes, n_lines, **geom,
                                           device="cpu"))
    rng = np.random.default_rng(7)
    for b in range(8):
        node = rng.integers(0, n_nodes, 10).astype(np.int32)
        line = rng.integers(0, n_lines, 10).astype(np.int32)
        line[rng.random(10) < 0.1] = -1
        isw = (rng.random(10) < 0.3).astype(np.int32)
        wd = rng.integers(-99, 99, (10, width)).astype(np.int32)
        jres, tres = jp.ops(node, line, isw, wd), tp.ops(node, line, isw,
                                                         wd)
        np.testing.assert_array_equal(tres.version, jres.version)
        np.testing.assert_array_equal(tres.data, jres.data)
        _same_state(jp.state, tp.state, f"ops {b}")
        picks = tpl.plan_replication(tres.telemetry, top_k=4,
                                     max_write_frac=0.5)
        np.testing.assert_array_equal(
            picks, jpl.plan_replication(jres.telemetry, top_k=4,
                                        max_write_frac=0.5))
        enable = b % 3 != 2
        jp.replicate(picks, enable=enable)
        tp.replicate(picks, enable=enable)
        _same_state(jp.state, tp.state, f"replicate {b}")
        plan = tpl.plan_rehome(tres.telemetry, tp.state["home"], 1)
        assert jp.rehome(*plan) == tp.rehome(*plan) == 0
        assert jp.rehome(line[line >= 0], np.zeros((line >= 0).sum()),
                         None) == 0
        assert tp.rehome(line[line >= 0],
                         np.zeros((line >= 0).sum())) == 0
        _same_state(jp.state, tp.state, f"rehome {b}")
        jp.evict(node[:2], line[:2])
        tp.evict(node[:2], line[:2])
        _same_state(jp.state, tp.state, f"evict {b}")
    assert tp.state["replica_ok"].any()
    tp.check()


def _raises_alike(call_j, call_t):
    with pytest.raises(ValueError) as ej:
        call_j()
    with pytest.raises(ValueError) as et:
        call_t()
    assert str(et.value) == str(ej.value)


def test_placement_guards_raise_the_references_errors():
    bare_j = jr.DevicePlane.open(jr.make_state(2, 8))
    bare_t = tr.DevicePlane.open(tr.make_state(2, 8, device="cpu"))
    _raises_alike(lambda: bare_j.rehome([1], [0]),
                  lambda: bare_t.rehome([1], [0]))
    _raises_alike(lambda: bare_j.replicate([1]),
                  lambda: bare_t.replicate([1]))
    geom = dict(home_directory=True, replicas=True, payload_width=1)
    jp = jr.DevicePlane.open(jr.make_state(2, 8, **geom))
    tp = tr.DevicePlane.open(tr.make_state(2, 8, **geom, device="cpu"))
    for args, kw in ((([1, 2], [0]), {}),
                     (([1, 2], [0, 0]), {"victims": [3]}),
                     (([8], [0]), {}), (([-1], [0]), {}),
                     (([1], [1]), {}), (([1], [-1]), {})):
        _raises_alike(lambda: jp.rehome(*args, **kw),
                      lambda: tp.rehome(*args, **kw))
    for lines in ([8], [-1], [0, 9]):
        _raises_alike(lambda: jp.replicate(lines),
                      lambda: tp.replicate(lines))
    assert jp.rehome([], []) == tp.rehome([], []) == 0


# ------------------------------------------------------- stripe layout

@pytest.mark.parametrize("home", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_stripe_state_matches(home, n_shards):
    rng = np.random.default_rng(n_shards + 10 * home)
    n_nodes, n_lines, width = 3, 16, 2
    state = jr.make_state(n_nodes, n_lines, write_back=True,
                          payload_width=width, home_directory=home,
                          replicas=True)
    state = {k: np.asarray(v) for k, v in state.items()}
    for k, v in state.items():       # distinct values in every cell
        if v.dtype == bool:
            state[k] = rng.random(v.shape) < 0.5
        else:
            state[k] = rng.integers(-50, 50, v.shape).astype(v.dtype)
    if home:
        state["home"] = rng.permutation(n_lines).astype(np.int32)
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    want = jst.stripe_state(state, n_shards)
    got = tst.stripe_state(tstate, n_shards)
    _same_state(want, got, "stripe")
    back_j = jst.unstripe_state(want, n_shards)
    back_t = tst.unstripe_state(got, n_shards)
    _same_state(back_j, back_t, "unstripe")
    _same_state(state, back_t, "round trip")
    assert tst.LINE_AXIS == jst.LINE_AXIS
    assert tst.GLOBAL_LEAVES == jst.GLOBAL_LEAVES
    assert tst.has_home_directory(tstate) == jst.has_home_directory(state)
    assert tst.has_replicas(tstate) and jst.has_replicas(state)
    perm = torch.from_numpy(state.get(
        "home", np.arange(n_lines, dtype=np.int32)))
    np.testing.assert_array_equal(
        tst.slot_positions(perm, n_shards).numpy(),
        np.asarray(jst.slot_positions(perm.numpy(), n_shards)))
    x = torch.arange(n_lines * 2).reshape(2, n_lines)
    np.testing.assert_array_equal(
        tst.stripe_lines(x, n_shards, axis=1).numpy(),
        np.asarray(jst.stripe_lines(x.numpy(), n_shards, axis=1)))
    np.testing.assert_array_equal(
        tst.unstripe_lines(tst.stripe_lines(x, n_shards, 1), n_shards,
                           1).numpy(), x.numpy())


def test_chip_smoke_placement_phase_on_cpu():
    """``chip_smoke.py``'s placement check at a small size on the CPU:
    the recorded plane and its twin agree batch by batch, replicas are
    marked and valid, and the flat rehome refuses exactly the plans that
    name a shard other than 0."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    res = cs.placement_phase(torch.device("cpu"), n_lines=64, width=8,
                             batches=4, batch=32)
    assert res["replicated"] > 0 and res["replica_ok"] > 0
    assert res["spans"] == 8 and res["snapshot"]["verbs"] == {"ops": 8}
    assert (res["rehome_refused"] is None) == (max(res["rehome_to"]) == 0)
