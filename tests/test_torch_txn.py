"""The port's device transactions against the JAX package's, bit for bit.

Same batches (``device_txn_batches``, numpy seeds) through both
packages at the sizes of ``tests/test_txn_device.py`` (12 GCLs of 4
tuples, 8 txns a batch, at most 4 lines a txn, zipf 0.9, 3 nodes):

* ``run_txn_rounds`` for 2PL no-wait and TO — decisions, completion
  steps, retries, iterations, rounds, every state leaf and the telemetry
  equal, batch after batch;
* ``DeviceTxnEngine`` — the same, plus its ``TxnStats`` and final image;
* the ``encode_txns`` trim policy, the host-driven scheduler against
  the port's own loop, and the canonical-order validation;
* the port's copies of ``Zipf`` and ``device_txn_batches`` give the JAX
  package's draws for the same seeds.

The JAX side runs with ``backend="ref"``, as its own tests do.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.apps import txn_device as jtd  # noqa: E402
from repro.apps import workloads as jwl  # noqa: E402
from repro.core import rounds as jr  # noqa: E402
from repro.core.rounds import txn as jtxn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import txn_device as ttd  # noqa: E402
from repro_torch.apps import workloads as twl  # noqa: E402
from repro_torch.core import rounds as tr  # noqa: E402
from repro_torch.core.rounds import txn as ttxn  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


CFG = dict(n_gcls=12, tuples_per_gcl=4, batch=8, iters=3,
           max_group_lines=4, zipf_theta=0.9, n_nodes=3)
W = ttxn.txn_payload_width(CFG["tuples_per_gcl"])


def _assert_same_state(jstate, tstate, where):
    j = {k: np.asarray(v) for k, v in jstate.items()}
    t = convert.to_numpy(tstate)
    assert sorted(j) == sorted(t), where
    for k in j:
        assert t[k].dtype == j[k].dtype, (where, k)
        np.testing.assert_array_equal(t[k], j[k], err_msg=f"{where}: {k}")


def _batches(seed, **kw):
    return jwl.device_txn_batches(jwl.TxnBatchConfig(**{**CFG, **kw}),
                                  seed=seed)


def _dcfg(mod, algo):
    return mod.DeviceTxnConfig(algo=algo,
                               tuples_per_gcl=CFG["tuples_per_gcl"],
                               max_group_lines=CFG["max_group_lines"])


# ------------------------------------------------------------ workloads

@pytest.mark.parametrize("n,theta", [(12, 0.9), (64, 0.6), (4096, 0.99)])
def test_zipf_draws_match(n, theta):
    jz, tz = jwl.Zipf(n, theta), twl.Zipf(n, theta)
    np.testing.assert_array_equal(tz.cdf, np.asarray(jz.cdf))
    np.testing.assert_array_equal(
        tz.sample_batch(np.random.default_rng(1), 5000),
        jz.sample_batch(np.random.default_rng(1), 5000))
    import random
    a, b = random.Random(2), random.Random(2)
    assert [tz.sample(a) for _ in range(200)] == \
        [jz.sample(b) for _ in range(200)]


@pytest.mark.parametrize("seed", [0, 3])
def test_device_txn_batches_match(seed):
    for kw in ({}, dict(zipf_theta=0.0), dict(n_gcls=64, batch=16)):
        want = _batches(seed, **kw)
        got = twl.device_txn_batches(
            twl.TxnBatchConfig(**{**CFG, **kw}), seed=seed)
        assert len(got) == len(want)
        for (gt, gn, gts), (wt, wn, wts) in zip(got, want):
            assert gt == wt
            np.testing.assert_array_equal(gn, wn)
            np.testing.assert_array_equal(gts, wts)


# ---------------------------------------------------------- the driver

@pytest.mark.parametrize("algo", ["2pl", "to"])
def test_run_txn_rounds_matches(algo):
    jstate = jr.make_state(CFG["n_nodes"], CFG["n_gcls"], payload_width=W)
    tstate = tr.make_state(CFG["n_nodes"], CFG["n_gcls"], payload_width=W,
                           device="cpu")
    saw_retry = saw_abort = 0
    for i, (txns, node, ts) in enumerate(_batches(3)):
        glines, rmask, wmask, _ = jtd.encode_txns(txns, _dcfg(jtd, algo))
        jout = jtxn.run_txn_rounds(jstate, node, glines, rmask, wmask, ts,
                                   algo=algo, n_nodes=CFG["n_nodes"],
                                   max_iters=48)
        tout = ttxn.run_txn_rounds(tstate, node, glines, rmask, wmask, ts,
                                   algo=algo, n_nodes=CFG["n_nodes"],
                                   max_iters=48)
        jstate, tstate = jout[0], tout[0]
        where = f"{algo} batch {i}"
        _assert_same_state(jstate, tstate, where)
        for k, name in enumerate(("decision", "exec_step", "retries"), 1):
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]),
                                          f"{where}: {name}")
        assert (tout[4], tout[5], tout[6], tout[7]) == \
            (int(jout[4]), bool(jout[5]), bool(jout[6]), int(jout[7])), \
            where
        assert tout[5] and tout[6]
        for k in jout[8]:
            np.testing.assert_array_equal(tout[8][k].numpy(),
                                          np.asarray(jout[8][k]), k)
        saw_retry += int(tout[3].sum())
        saw_abort += int((~tout[1]).sum())
    assert saw_retry > 0
    assert (saw_abort > 0) == (algo == "to")
    tr.check_invariants(tstate)


@pytest.mark.parametrize("algo", ["2pl", "to"])
def test_engine_matches_jax(algo):
    jeng = jtd.DeviceTxnEngine(
        jr.DevicePlane.open(jr.make_state(CFG["n_nodes"], CFG["n_gcls"],
                                          payload_width=W),
                            n_nodes=CFG["n_nodes"]), _dcfg(jtd, algo))
    teng = ttd.DeviceTxnEngine(
        tr.DevicePlane.open(tr.make_state(CFG["n_nodes"], CFG["n_gcls"],
                                          payload_width=W, device="cpu"),
                            n_nodes=CFG["n_nodes"]), _dcfg(ttd, algo))
    for i, (txns, node, ts) in enumerate(_batches(7)):
        jres, jeff = jeng.run_batch(node, txns, ts=ts)
        tres, teff = teng.run_batch(node, txns, ts=ts)
        assert teff == jeff
        for fld in ("decision", "exec_step", "retries"):
            np.testing.assert_array_equal(getattr(tres, fld),
                                          getattr(jres, fld), fld)
        assert (tres.iters, tres.rounds) == (jres.iters, jres.rounds)
        for k, v in jres.telemetry.items():
            np.testing.assert_array_equal(tres.telemetry[k], v, k)
        _assert_same_state(jeng.plane.state, teng.plane.state,
                           f"{algo} batch {i}")
    js, ts_ = jeng.stats, teng.stats
    assert (ts_.commits, ts_.aborts, ts_.abort_reasons) == \
        (js.commits, js.aborts, js.abort_reasons)
    assert ts_.latency.count == js.latency.count == 3 * CFG["batch"]
    np.testing.assert_array_equal(teng.final_image(), jeng.final_image())
    teng.plane.check()
    img = teng.final_image()
    assert (img[:, ttxn.LOCK_LANE] == 0).all()       # every lock released
    assert img[:, ttxn.WRITES_LANE].any() if algo == "2pl" else \
        img[:, ttxn.HDR_LANES:].any()


# ----------------------------------------------------------- the rest

def test_encode_txns_trim_policy():
    cfg = ttd.DeviceTxnConfig(tuples_per_gcl=4, max_group_lines=2)
    # 3 write gcls (0, 2, 5) + read gcl 7: writes win, lowest first
    glines, rmask, wmask, eff = ttd.encode_txns(
        [([28, 1], [0, 8, 20, 1])], cfg)
    assert glines.tolist() == [[0, 2]]
    eff_r, eff_w = eff[0]
    assert eff_w == [0, 1, 8] and eff_r == [1]      # gcl 5, 7 trimmed
    assert wmask[0, 0].tolist() == [1, 1, 0, 0]     # tuples 0, 1
    assert wmask[0, 1].tolist() == [1, 0, 0, 0]     # tuple 8
    assert rmask.sum() == 0   # read 1 is in the write set: wmask wins
    glines, rmask, wmask, eff = ttd.encode_txns([([4, 5], [9])], cfg)
    assert glines.tolist() == [[1, 2]]
    assert eff[0] == ([4, 5], [9])
    assert rmask[0, 0].tolist() == [1, 1, 0, 0]
    assert wmask[0, 1].tolist() == [0, 1, 0, 0]
    # and the JAX package's encoding, on random txns that trip the cap
    rng = np.random.default_rng(4)
    txns = [(list(rng.integers(0, 48, rng.integers(0, 6))),
             list(rng.integers(0, 48, rng.integers(0, 6))))
            for _ in range(40)]
    jcfg = jtd.DeviceTxnConfig(tuples_per_gcl=4, max_group_lines=2)
    for got, want in zip(ttd.encode_txns(txns, cfg),
                         jtd.encode_txns(txns, jcfg)):
        if isinstance(want, list):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    lanes = ttd.host_record_lanes({"writes": 3, 9: (4, 5)}, 2, 4)
    np.testing.assert_array_equal(
        lanes, jtd.host_record_lanes({"writes": 3, 9: (4, 5)}, 2, 4))


@pytest.mark.parametrize("algo", ["2pl", "to"])
def test_host_driven_scheduler_matches_loop(algo):
    def engine():
        return ttd.DeviceTxnEngine(
            tr.DevicePlane.open(tr.make_state(
                CFG["n_nodes"], CFG["n_gcls"], payload_width=W,
                device="cpu"), n_nodes=CFG["n_nodes"]), _dcfg(ttd, algo))
    loop, host = engine(), engine()
    for txns, node, ts in _batches(5)[:2]:
        rl, _ = loop.run_batch(node, txns, ts=ts)
        glines, rmask, wmask, _ = ttd.encode_txns(txns, host.cfg)
        rh = ttxn.run_txn_batch_host(host.plane, node, glines, rmask,
                                     wmask, ts, algo=algo)
        for fld in ("decision", "exec_step", "retries"):
            np.testing.assert_array_equal(getattr(rl, fld),
                                          getattr(rh, fld), fld)
        assert (rl.iters, rl.rounds) == (rh.iters, rh.rounds)
        assert rh.telemetry is None
        _assert_same_state(loop.plane.state, host.plane.state, algo)


def test_batch_validation_raises():
    plane = tr.DevicePlane.open(tr.make_state(2, 8, payload_width=W,
                                              device="cpu"))
    node = np.zeros(2, np.int32)
    masks = np.zeros((2, 3, 4), np.int32)
    ts = np.arange(2, dtype=np.int32)

    def run(glines, algo="2pl", rmask=masks, **kw):
        return plane.txn(node, np.asarray(glines, np.int32), rmask, masks,
                         ts, algo=algo, **kw)
    with pytest.raises(ValueError, match="trail"):
        run([[1, -1, 3], [0, 2, -1]])
    with pytest.raises(ValueError, match="ascending"):
        run([[3, 1, -1], [0, 2, -1]])
    with pytest.raises(ValueError, match="ascending"):
        run([[1, 1, -1], [0, 2, -1]])
    with pytest.raises(ValueError, match="unknown txn algo"):
        run([[1, 3, -1], [0, 2, -1]], algo="occ")
    with pytest.raises(ValueError, match="payload_width"):
        run([[1, 3, -1], [0, 2, -1]], rmask=np.zeros((2, 3, 5), np.int32))
    with pytest.raises(ValueError, match="unknown txn algo"):
        ttxn.run_txn_batch_host(plane, node, np.full((2, 3), -1, np.int32),
                                masks, masks, ts, algo="occ")
    with pytest.raises(RuntimeError, match="scheduler iterations"):
        run([[1, 3, -1], [0, 2, -1]], max_iters=1)
    with pytest.raises(ValueError, match="payload_width"):
        ttd.DeviceTxnEngine(plane, ttd.DeviceTxnConfig(tuples_per_gcl=8))
    plane.state = tr.make_state(2, 8, payload_width=W, device="cpu")
    res = run([[1, 3, -1], [0, 2, -1]])       # a valid batch commits
    assert res.decision.tolist() == [True, True]
    assert res.exec_step.tolist() == [1, 1] and res.iters == 2


def test_chip_smoke_txn_phase_on_cpu():
    """``chip_smoke.py``'s phase 6 at a small size on the CPU: its serial
    replay agrees with the device's decisions and final image under both
    algorithms."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    res = cs.txn_phase(torch.device("cpu"), n_gcls=64, batch=24,
                       n_batches=2)
    assert res["2pl"]["commits"] == 48 and res["2pl"]["retries"] > 0
    assert res["to"]["aborts_by_reason"].get("ts", 0) > 0


def test_chip_smoke_finalize_latch_inputs():
    """The K1 case ``chip_smoke.py`` holds at the txn FINALIZE spin's
    shape covers what that spin sends: about half the slots empty, write
    CASes that hit and that miss, reader FAAs, and lines named once in
    each of the kernel's four request tiles of 1024, whose replies show
    the word carried from tile to tile (as a serial loop computes it)."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    from repro_torch.kernels.latch_ops import REQ_KEYS, latch_apply_plain
    n, r = 1 << 14, 4096
    words, req = cs.latch_app_inputs(n, r, "finalize")
    line, op = req["line"], req["op"]
    valid = line >= 0
    assert 0.4 < 1 - valid.mean() < 0.6
    _, old_hi, old_lo, ok = (t.numpy() for t in latch_apply_plain(
        torch.from_numpy(words), *[torch.from_numpy(req[k])
                                   for k in REQ_KEYS]))
    cas = valid & (op == 0)
    assert ok[cas].any() and not ok[cas].all() and (valid & (op != 0)).any()
    ls, counts = np.unique(line[valid], return_counts=True)
    hot = ls[counts > 1]
    assert len(hot) == 8 and (counts[counts > 1] == 4).all()
    mask = 0xFFFFFFFF
    for h in hot:
        at = np.nonzero(line == h)[0]
        assert sorted(set(at // 1024)) == [0, 1, 2, 3]
        w = (int(words[h, 0]) & mask) << 32 | int(words[h, 1]) & mask
        for i in at:                       # the word each request saw
            assert ((int(old_hi[i]) & mask) << 32
                    | int(old_lo[i]) & mask) == w
            arg = (int(req["arg_hi"][i]) & mask) << 32 \
                | int(req["arg_lo"][i]) & mask
            cmp = (int(req["cmp_hi"][i]) & mask) << 32 \
                | int(req["cmp_lo"][i]) & mask
            if op[i] == 0:
                assert bool(ok[i]) == (w == cmp)
                w = arg if w == cmp else w
            else:
                w = (w + arg) & (2**64 - 1)
