"""Fault tolerance at fleet scale: failure detection, elastic remesh,
straggler mitigation; port of ``repro.runtime.fault`` (plain Python, the
same logic).

This container has one process, so the control plane is implemented
against an injectable clock/host-list and exercised by simulation tests —
the exact logic a multi-host launcher would run in its coordinator:

* ``FailureDetector`` — phi-style heartbeat monitor: a host is SUSPECT
  after ``suspect_after`` without a beat and DEAD after ``dead_after``;
  monotonic, flap-resistant (a beat resurrects a suspect, never a dead).
* ``plan_elastic_mesh`` — given dead hosts, shrink the DATA axis to the
  largest full rectangle (model/TP axis must stay intact: weights are
  sharded across it), return the survivor device grid + the new global
  batch scaling.  Restart = restore checkpoint with the new shardings
  (checkpoint/ckpt.restore does the resharding device_put).
* ``StragglerWatchdog`` — per-step deadline from an EWMA of step times;
  a step exceeding ``k * ewma`` flags its slowest host; after
  ``strikes`` consecutive flags the host is reported for replacement
  (hot-spare promotion), the standard large-fleet mitigation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


class FailureDetector:
    ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"

    def __init__(self, hosts, suspect_after: float = 10.0,
                 dead_after: float = 30.0, clock=time.monotonic):
        self.clock = clock
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        now = clock()
        self.last_beat = {h: now for h in hosts}
        self.dead: set = set()

    def beat(self, host) -> None:
        if host not in self.dead:
            self.last_beat[host] = self.clock()

    def state(self, host) -> str:
        if host in self.dead:
            return self.DEAD
        dt = self.clock() - self.last_beat[host]
        if dt >= self.dead_after:
            self.dead.add(host)
            return self.DEAD
        if dt >= self.suspect_after:
            return self.SUSPECT
        return self.ALIVE

    def sweep(self):
        """Returns (alive, suspect, dead) host lists."""
        out = {self.ALIVE: [], self.SUSPECT: [], self.DEAD: []}
        for h in list(self.last_beat):
            out[self.state(h)].append(h)
        return out[self.ALIVE], out[self.SUSPECT], out[self.DEAD]


@dataclass
class ElasticPlan:
    data_rows: list            # surviving data-axis row indices
    new_data_size: int
    batch_scale: float         # new_global_batch = old * batch_scale
    lost_rows: list


def plan_elastic_mesh(data_size: int, model_size: int, dead_hosts,
                      host_of_device=None) -> ElasticPlan:
    """Devices are arranged (data, model); a dead host kills its whole
    data ROW (TP groups must stay complete — weight shards live across
    the model axis).  Survivors keep training with a smaller data axis
    and proportionally smaller global batch (sync-SGD semantics are
    preserved by LR/batch rescaling at the trainer level)."""
    host_of_device = host_of_device or (lambda d, m: d)   # 1 host per row
    dead_rows = set()
    for d in range(data_size):
        for m in range(model_size):
            if host_of_device(d, m) in set(dead_hosts):
                dead_rows.add(d)
    rows = [d for d in range(data_size) if d not in dead_rows]
    if not rows:
        raise RuntimeError("no surviving data rows — cannot remesh")
    return ElasticPlan(
        data_rows=rows,
        new_data_size=len(rows),
        batch_scale=len(rows) / data_size,
        lost_rows=sorted(dead_rows),
    )


class StragglerWatchdog:
    def __init__(self, k: float = 2.0, strikes: int = 3,
                 ewma_alpha: float = 0.2):
        self.k = k
        self.strikes = strikes
        self.alpha = ewma_alpha
        self.ewma: float | None = None
        self.flags: dict = {}

    def observe(self, step_time: float, slowest_host=None):
        """Feed per-step wall time (+ optionally which host was slowest).
        Returns a host to replace, or None."""
        verdict = None
        if self.ewma is not None and step_time > self.k * self.ewma \
                and slowest_host is not None:
            n = self.flags.get(slowest_host, 0) + 1
            self.flags[slowest_host] = n
            if n >= self.strikes:
                verdict = slowest_host
                self.flags[slowest_host] = 0
        else:
            if slowest_host is not None:
                self.flags[slowest_host] = 0
        self.ewma = (step_time if self.ewma is None
                     else (1 - self.alpha) * self.ewma
                     + self.alpha * step_time)
        return verdict
