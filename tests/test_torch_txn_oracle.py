"""The device transaction engine against the DES ``TxnEngine``, inside
the port (``tests/test_txn_device.py``'s differential).

The device loop serializes a whole batch by ``(exec_step, slot)``: lock
hold intervals per line are disjoint, so the batch is serially
equivalent to running its txns one at a time in that order.  The oracle
is that serial run: the port's DES ``TxnEngine`` replaying the device's
effective tuple sets in device order, with the device's client
timestamps injected (``engine.run(..., ts=)``).  Decisions and the final
memory image (host ``GclHeap`` records rendered to lanes against a
protocol-fresh read-back) must be equal, for 2PL no-wait (retries, no
abort) and TO (aborts), on the flat plane and on ``Mesh(4)``.  The JAX
package's DES replays the same batches to the same decisions and image,
and ``chip_smoke.replay_txn`` (the smoke script's numpy oracle) agrees
with both.  ``test_chip_smoke_des_txn_oracle_on_cpu`` and
``test_chip_smoke_fig11_host_cell_on_cpu`` rehearse the smoke script's
``des_txn_oracle`` and ``des_fig11_cell`` at a small geometry.
"""

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.apps.txn as jtxn  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.apps as tapps  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.rounds import (DevicePlane, Mesh,  # noqa: E402
                                     make_sharded_state, make_state,
                                     txn_payload_width)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


CFG = tapps.TxnBatchConfig(n_gcls=12, tuples_per_gcl=4, batch=8, iters=3,
                           max_group_lines=4, zipf_theta=0.9, n_nodes=3)
W = txn_payload_width(CFG.tuples_per_gcl)


def _device_engine(algo, shards):
    if shards:
        mesh = Mesh(shards, device="cpu")
        plane = DevicePlane.open(make_sharded_state(
            CFG.n_nodes, CFG.n_gcls, mesh, payload_width=W), mesh)
    else:
        plane = DevicePlane.open(make_state(CFG.n_nodes, CFG.n_gcls,
                                            payload_width=W, device="cpu"))
    return tapps.DeviceTxnEngine(plane, tapps.DeviceTxnConfig(
        algo=algo, tuples_per_gcl=CFG.tuples_per_gcl,
        max_group_lines=CFG.max_group_lines))


class _Replay:
    """A DES oracle of either package: ONE memory node, so the host's
    sorted-GAddr latch order is the device's ascending line order and
    TO's abort-time partial updates land in the same tuples."""

    def __init__(self, core, engine_cls, config_cls, algo):
        self.layer = core.SELCCLayer(core.ClusterConfig(
            n_compute=CFG.n_nodes, n_memory=1, threads_per_node=4))
        self.engines = [engine_cls(self.layer, nd, config_cls(
            algo=algo, tuples_per_gcl=CFG.tuples_per_gcl),
            CFG.n_gcls * CFG.tuples_per_gcl) for nd in self.layer.nodes]

    def run(self, node, sets, ts):
        out = {}

        def one():
            out["ok"] = yield from self.engines[node].run(*sets, ts=ts)
        self.layer.env.run_until_complete([self.layer.env.process(one())])
        return out["ok"]

    def image(self):
        gcls = self.engines[0].gcls
        return np.stack([tapps.host_record_lanes(
            self.layer.heap.load(gcls[g]), g, CFG.tuples_per_gcl)
            for g in range(CFG.n_gcls)])


def _differential(algo, shards, seed=3):
    dev = _device_engine(algo, shards)
    port = _Replay(tcore, tapps.TxnEngine, tapps.TxnConfig, algo)
    ref = _Replay(jcore, jtxn.TxnEngine, jtxn.TxnConfig, algo)
    numpy_image = np.zeros((CFG.n_gcls, W), np.int32)
    retries = aborts = 0
    for txns, node, ts in tapps.device_txn_batches(CFG, seed=seed):
        res, effective = dev.run_batch(node, txns, ts=ts)
        assert len(res.decision) == len(txns)
        retries += int(res.retries.sum())
        aborts += int((~res.decision).sum())
        order = sorted(range(len(txns)),
                       key=lambda i: (int(res.exec_step[i]), i))
        for i in order:
            got = bool(res.decision[i])
            args = (int(node[i]), effective[i], int(ts[i]))
            assert port.run(*args) == got, (algo, i, effective[i])
            assert ref.run(*args) == got, (algo, i, "reference")
            assert cs.replay_txn(numpy_image, effective[i], int(ts[i]),
                                 algo, CFG.tuples_per_gcl) == got
    image = port.image()
    np.testing.assert_array_equal(dev.final_image()[:CFG.n_gcls], image)
    np.testing.assert_array_equal(ref.image(), image)
    np.testing.assert_array_equal(numpy_image, image)
    dev.plane.check()
    for r in (port, ref):
        r.layer.assert_released()
    return retries, aborts


@pytest.mark.parametrize("shards", [0, 4])
def test_2pl_decisions_and_image(shards):
    retries, aborts = _differential("2pl", shards)
    assert aborts == 0          # no-wait retries in the loop until commit
    assert retries > 0          # ... and the workload does conflict


@pytest.mark.parametrize("shards", [0, 4])
def test_to_decisions_and_image(shards):
    retries, aborts = _differential("to", shards)
    assert aborts > 0           # shuffled client ts: TO really aborts


def test_ts_override_decides_to():
    """``run(..., ts=)`` replaces the FAA-drawn timestamp: an older
    writer after a younger reader of the same tuple aborts."""
    rep = _Replay(tcore, tapps.TxnEngine, tapps.TxnConfig, "to")
    assert rep.run(0, ([5], []), 10)
    assert not rep.run(1, ([], [5]), 3)
    assert rep.run(2, ([], [5]), 11)
    eng = rep.engines[0]
    assert eng.stats.commits == 1 and rep.engines[1].stats.abort_reasons \
        == {"ts": 1}


def test_chip_smoke_des_txn_oracle_on_cpu():
    """``chip_smoke.des_txn_oracle`` at a small geometry on the CPU,
    flat and on four shards."""
    res = cs.des_txn_oracle(torch.device("cpu"), n_gcls=1 << 10, batch=32,
                            n_batches=2, sharded_batches=1)
    for plane in ("flat", "sharded"):
        for algo in ("2pl", "to"):
            r = res[plane][algo]
            assert r["txns"] == r["commits"] + r["aborts"] > 0
            assert r["lines_checked"] > 0
    assert res["flat"]["to"]["aborts"] > 0
    assert res["flat"]["2pl"]["retries"] > 0


def test_chip_smoke_fig11_host_cell_on_cpu():
    """``chip_smoke.des_fig11_cell`` (the bench's ``_des_cell``) at a
    small geometry: every txn commits or aborts, each algorithm aborts
    for its own reason."""
    res = cs.des_fig11_cell(n_gcls=1 << 10, batch=64, n_batches=2)
    for algo, reason in (("2pl", "nowait"), ("to", "ts"), ("occ", "occ")):
        r = res[algo]
        assert r["commits"] + r["aborts"] == 128 and r["commits"] > 0
        assert set(r["aborts_by_reason"]) <= {reason}
        assert r["des_time"] > 0
    assert res["occ"]["aborts"] > 0
