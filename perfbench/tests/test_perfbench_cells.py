"""Each cell at a tiny size on the CPU, held against its reference; the
planted faults of the timed path, the comparison's own soundness and the
controls, each of which has to read ``correct`` false."""

import io
import json

import numpy as np
import pytest

from perfbench import control
from perfbench.lib import btree_image, harness
from perfbench.lib.program import Patch
from perfbench.references import btree as tree_ref
from perfbench.tests._run import CELLS, run_cell, tiny

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_matches_its_reference(cell):
    rc, res, err = run_cell(cell)
    assert rc == 0, err
    assert res["correct"], err
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 == c["limit"]
               for c in res["checks"].values())
    e2e = {m["name"] for m in harness.Cell(cell)
           .metrics(False)}
    assert set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_host_metrics(cell):
    rc, res, err = run_cell(cell, trace=1)
    assert rc == 0 and res["correct"], err
    names = {m["name"] for m in harness.Cell(cell)
             .metrics(True)}
    host = {n for n in names if n.split(".")[0] in (
        "op_p95_ms", "rounds_per_batch", "rmw_steps_per_batch")}
    # no card here: the device metrics have nothing to read
    assert set(res["metrics"]) == host
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _state_unchanged(original):
    """A round that serves its slots but leaves the plane as it was."""
    def round_(state, *args, **kwargs):
        saved = {k: v.clone() for k, v in state.items()}
        _, *rest = original(state, *args, **kwargs)
        for k, v in saved.items():
            state[k].copy_(v)
        return (dict(state), *rest)
    return round_


def _half_descent(original):
    """Descents that leave the second half of their slots out."""
    def descent(self, node_id, key, root, **kwargs):
        root = np.array(root)
        root[len(root) // 2:] = -1
        return original(self, node_id, key, root, **kwargs)
    return descent


def _lookup_altered(original):
    def lookup(self, keys, node=0):
        vals, found = original(self, keys, node)
        vals = vals.copy()
        vals[0] += 1
        return vals, found
    return lookup


ROUND = [("repro_torch.core.rounds.engine", "_round_impl", _state_unchanged),
         ("repro_torch.core.rounds.descent", "_round_impl",
          _state_unchanged)]
FAULTS = {
    "state_unchanged": ROUND,
    "half_batch": [("repro_torch.core.rounds.plane", "DevicePlane.descent",
                    _half_descent)],
    "answer_altered": [("repro_torch.index.tree",
                        "DeviceBTree.lookup_batch", _lookup_altered)],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault):
    with Patch(FAULTS[fault]):
        rc, res, err = run_cell(cell)
    assert rc == 0, err
    assert res["correct"] is False, err
    assert res["checks"]["errors"]["value"] == 0, err


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = io.StringIO()
    control.main(["--workload", cell, "--batches", "12", "--seeds", "5",
                  "6", "7"], overrides=tiny(cell),
                 out=out)
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert len(lines) == 3
    assert not any(x["correct"] for x in lines)


def _tree_case(batches=6):
    cfg = {**harness.Cell("btree.ycsb-a").config,
           **tiny("btree.ycsb-a")["config"]}
    cell = harness.Cell("btree.ycsb-a", overrides=tiny("btree.ycsb-a"))
    gen = cell.generator.Traffic(cfg, cell.traffic, 3)
    image, layout = btree_image.build(cfg["recordcount"], cfg["lines"],
                                      cfg["fanout"], cfg["fill"])
    ref = tree_ref.TreeReference(layout, image, cfg["nodes"])
    ref.read(0, [0])
    results = []
    for i in range(batches):
        b = gen.batch(i)
        want = ref.batch(b["node"], b["keys"], b["is_read"], b["vals"])
        results.append((want[0].copy(), want[1].copy()))
    mem = ref.memory()

    class State:
        words = tree_ref.directory(ref.state)
        cache_state = ref.state
        cache_version = np.repeat(ref.version[None], cfg["nodes"], 0)
        mem_version = ref.version
        mem_data = mem

        @staticmethod
        def cache_rows(nodes, lines):
            return mem[lines]
    return layout, image, cfg, gen, results, State


def test_the_tree_comparison_reads_zero_on_the_reference_and_one_planted():
    layout, image, cfg, gen, results, state = _tree_case()
    _, counts = tree_ref.judge(layout, image, cfg["nodes"], gen, results,
                               state)
    assert all(v == 0 for v in counts.values()), counts
    results[3][0][5] += 1
    _, counts = tree_ref.judge(layout, image, cfg["nodes"], gen, results,
                               state)
    assert counts["lookups_wrong"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_at_a_tiny_size(cell, card):
    rc, res, err = run_cell(cell, device=str(card))
    assert rc == 0 and res["correct"], err


def test_a_window_that_reaches_the_pools_end_stops_there():
    # 1 warm-up batch and 4 of the window's: no batch is drawn inside it
    over = {"config": tiny("btree.ycsb-c")["config"],
            "traffic": {**tiny("btree.ycsb-c")["traffic"],
                        "pool_batches_per_s": 1}}
    rc, res, err = run_cell("btree.ycsb-c", seconds=4.0, overrides=over)
    assert rc == 0 and res["correct"], err
    assert res["attempted"] == 4 * 64
    assert "reached the pool's end (5 batches)" in err


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_window_holds_at_least_its_batches(cell):
    rc, res, err = run_cell(cell, trace=1)
    assert rc == 0 and res["correct"], err
    traced = [x for x in err.splitlines()
              if x.startswith("perfbench: traced")]
    assert int(traced[0].split(", ")[1].split()[0]) >= harness.TRACE_BATCHES
