"""Device-batch transaction engine: Fig. 11 workloads on the rounds plane.

Counterpart of ``repro/apps/txn_device.py``.  A whole BATCH of
transactions runs through the device CC scheduler
(``core/rounds/txn.py``): tuples are encoded into GCL payload lanes
(lock word, writes counter, per-tuple (rts, wts) headers — the device
mirror of the host ``GclHeap`` record ``{"writes": n, tid: (rts, wts)}``),
and 2PL no-wait / TO execute on the device, aborts and retries included.

:func:`encode_txns` turns host-style ``(read_set, write_set)`` tuple-id
pairs into the loop's canonical ``(glines, rmask, wmask)`` arrays —
per-txn GCL lines sorted ascending (the deadlock-freedom contract), with
a deterministic cap policy when a txn touches more than
``max_group_lines`` GCLs: write lines win over read-only lines, lowest
line first; the EFFECTIVE per-txn sets come back to the caller so an
oracle replays exactly what the device ran.

:class:`DeviceTxnEngine` owns a :class:`DevicePlane` plus
:class:`TxnStats`: commits, terminal aborts by reason ("ts" for TO —
device 2PL no-wait retries in-loop until commit, so its no-wait
conflicts surface as attempts with reason "nowait"), and per-txn latency
samples (batch wall time — it's a gang engine)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.rounds.txn import HDR_LANES, WRITES_LANE, txn_payload_width
from .txn import TxnStats


@dataclass
class DeviceTxnConfig:
    algo: str = "2pl"                # 2pl | to
    tuples_per_gcl: int = 8
    max_group_lines: int = 4         # G: per-txn GCL cap (trim policy)


def encode_txns(txns, cfg: DeviceTxnConfig):
    """Host tuple-set txns -> device batch arrays.

    ``txns`` is a list of ``(read_set, write_set)`` tuple-id
    collections.  Returns ``(glines [B, G], rmask [B, G, T],
    wmask [B, G, T], effective)`` where ``effective`` is the per-txn
    ``(read_set, write_set)`` actually encoded (after the G-cap trim) —
    feed THAT to an oracle, not the input."""
    T = cfg.tuples_per_gcl
    G = cfg.max_group_lines
    B = len(txns)
    glines = np.full((B, G), -1, np.int32)
    rmask = np.zeros((B, G, T), np.int32)
    wmask = np.zeros((B, G, T), np.int32)
    effective = []
    for i, (read_set, write_set) in enumerate(txns):
        wset = set(write_set)
        rset = set(read_set)
        wg = sorted({t // T for t in wset})
        rg = sorted({t // T for t in rset} - set(wg))
        keep = (wg + rg)[:G]          # write lines win, lowest first
        keep_s = sorted(keep)
        eff_w = sorted(t for t in wset if t // T in keep)
        eff_r = sorted(t for t in rset if t // T in keep)
        effective.append((eff_r, eff_w))
        col = {g: j for j, g in enumerate(keep_s)}
        glines[i, :len(keep_s)] = keep_s
        for t in eff_w:
            wmask[i, col[t // T], t % T] = 1
        for t in eff_r:
            if t not in wset:
                rmask[i, col[t // T], t % T] = 1
    return glines, rmask, wmask, effective


def host_record_lanes(rec: dict, gcl_index: int,
                      tuples_per_gcl: int) -> np.ndarray:
    """Host ``GclHeap`` txn record -> the device line's payload lanes
    (lock word 0 — quiescent), for image differentials."""
    W = txn_payload_width(tuples_per_gcl)
    lanes = np.zeros(W, np.int32)
    lanes[WRITES_LANE] = rec.get("writes", 0)
    base = gcl_index * tuples_per_gcl
    for t in range(tuples_per_gcl):
        rts, wts = rec.get(base + t, (0, 0))
        lanes[HDR_LANES + 2 * t] = rts
        lanes[HDR_LANES + 2 * t + 1] = wts
    return lanes


@dataclass
class DeviceTxnEngine:
    """Gang transaction engine over a :class:`DevicePlane`, flat or
    sharded (``plane.txn`` pads B to the shard count); it runs on the
    plane's device.

    The plane must carry ``txn_payload_width(cfg.tuples_per_gcl)``
    payload lanes; its lines ARE the GCLs (line g holds tuples
    ``[g*T, (g+1)*T)``)."""

    plane: object
    cfg: DeviceTxnConfig
    stats: TxnStats = field(default_factory=TxnStats)

    def __post_init__(self):
        need = txn_payload_width(self.cfg.tuples_per_gcl)
        if self.plane.payload_width != need:
            raise ValueError(
                f"plane payload_width={self.plane.payload_width}; "
                f"tuples_per_gcl={self.cfg.tuples_per_gcl} needs "
                f"{need}")

    def run_batch(self, node_id, txns, ts=None):
        """Execute one batch of ``(read_set, write_set)`` txns from
        ``node_id`` (int or [B]); ``ts`` [B] are the TO timestamps
        (client-assigned at txn begin; defaults to arrival order).
        Returns ``(TxnBatchResult, effective_txns)``."""
        B = len(txns)
        glines, rmask, wmask, effective = encode_txns(txns, self.cfg)
        node = np.broadcast_to(np.asarray(node_id, np.int32),
                               (B,)).copy()
        if ts is None:
            ts = np.arange(B, dtype=np.int32)
        t0 = time.perf_counter()
        res = self.plane.txn(node, glines, rmask, wmask,
                             np.asarray(ts, np.int32),
                             algo=self.cfg.algo)
        wall = time.perf_counter() - t0
        per_txn = wall / max(B, 1)
        for i in range(B):
            self.stats.record(bool(res.decision[i]), per_txn,
                              None if res.decision[i] else "ts")
        # no-wait conflicts retried in-loop: count them as host-style
        # abort+retry attempts so host/device Fig. 11 rates line up
        nretries = int(res.retries.sum())
        if nretries:
            self.stats.aborts += nretries
            self.stats.abort_reasons["nowait"] = \
                self.stats.abort_reasons.get("nowait", 0) + nretries
        return res, effective

    def final_image(self) -> np.ndarray:
        """Every GCL's payload lanes, protocol-fresh (read through the
        plane from node 0) — the memory image differential tests
        compare against a host oracle."""
        n = self.plane.n_lines
        res = self.plane.ops(np.zeros(n, np.int32),
                             np.arange(n, dtype=np.int32),
                             np.zeros(n, np.int32))
        return np.asarray(res.data)
