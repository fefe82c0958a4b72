"""Driver of the B-link tree cells: ``DeviceBTree`` over a flat plane.

Set-up builds the tree image in NumPy (``lib/btree_image.py``), carries
it to the card once as the payload of a write-through plane that
``make_state`` allocates there, and adopts it with ``DeviceBTree.open``.
A batch is one compute node's ``lookup_batch`` of its lookups, then its
``insert_batch`` of its updates (upserts of existing keys, so no
splits).  A lookup's latency runs from the batch's dispatch to the
lookup results on the host, an update's to ``insert_batch``'s return.

After the window the plane's final state and every lookup are held
against ``references/btree.py``, and every key the run updated is read
back through ``lookup_batch`` and held against the reference's values.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import btree_image
from perfbench.lib.hoststate import HostState
from perfbench.lib.program import rounds_run

# layer boundaries the traced run marks with spans: (module, name, span)
SPANS = [
    ("repro_torch.index.tree", "DeviceBTree.lookup_batch", "tree.lookup"),
    ("repro_torch.index.tree", "DeviceBTree.insert_batch", "tree.insert"),
    ("repro_torch.index.tree", "DeviceBTree._descend", "tree.descend"),
    ("repro_torch.index.tree", "DeviceBTree._rmw_insert", "tree.rmw_step"),
    ("repro_torch.core.rounds.plane", "DevicePlane._telemetry",
     "plane.telemetry_copy"),
    ("repro_torch.core.rounds.descent", "_round_impl", "engine.round"),
    ("repro_torch.core.rounds.driver", "coherence_round", "engine.round"),
]


class Cell:
    def __init__(self, config: dict, traffic, reference, device):
        from repro_torch.core import rounds
        from repro_torch.index import DeviceBTree
        self.traffic = traffic
        self.reference = reference
        self.n_nodes = int(config["nodes"])
        self.image, self.layout = btree_image.build(
            int(config["recordcount"]), int(config["lines"]),
            int(config["fanout"]), int(config["fill"]))
        state = rounds.make_state(self.n_nodes, int(config["lines"]),
                                  payload_width=self.image.shape[1],
                                  device=device)
        state["mem_data"].copy_(torch.from_numpy(self.image))
        self.tree = DeviceBTree.open(state, n_nodes=self.n_nodes)
        got = (self.tree.root, self.tree.height, self.tree.alloc.top)
        want = (self.layout.root, self.layout.height, self.layout.top)
        if got != want:
            raise RuntimeError(f"the tree opened as (root, height, top) "
                               f"{got}, the image holds {want}")
        self.results = []

    def run_batch(self, i: int):
        """Batch ``i`` (batches run in order from 0); returns each
        operation's latency in seconds and the batch's counts."""
        b = self.traffic.batch(i)
        keys, is_read, vals = b["keys"], b["is_read"], b["vals"]
        lat = np.empty(keys.shape[0])
        got = None
        t0 = time.perf_counter()
        if is_read.any():
            got = self.tree.lookup_batch(keys[is_read], node=b["node"])
            lat[is_read] = time.perf_counter() - t0
        if not is_read.all():
            self.tree.insert_batch(keys[~is_read], vals[~is_read],
                                   node=b["node"])
            lat[~is_read] = time.perf_counter() - t0
        self.results.append(got)
        return lat, {"ycsb_ops": int(keys.shape[0])}

    def counters(self) -> dict:
        return {"rounds": rounds_run(),
                "rmw_steps": int(self.tree.stats["rmw_steps"])}

    def check(self) -> dict:
        """Holds the run against the reference, reads every updated key
        back; frees the plane."""
        ref, out = self.reference.judge(
            self.layout, self.image, self.n_nodes, self.traffic,
            self.results, HostState(self.tree.plane.state))
        updated = [self.traffic.batch(i)["keys"][
            ~self.traffic.batch(i)["is_read"]]
            for i in range(len(self.results))]
        keys = np.unique(np.concatenate(updated))
        size = self.traffic.size
        bad = 0
        for a in range(0, len(keys), size):
            part = keys[a:a + size]
            vals, found = self.tree.lookup_batch(
                part, node=(a // size) % self.n_nodes)
            bad += int(((vals != ref.values[part]) | ~found).sum())
        out["readback_wrong"] = bad
        self.tree = None
        return out
