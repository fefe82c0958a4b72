"""A cell, a traffic mix and a per-layer metric are added by files and
``BENCHMARK.json`` entries alone: in a copy of the benchmark, with no
file of it edited, the harness finds and runs them."""

import json
import shutil

import pytest

from perfbench.lib import harness
from perfbench.tests._run import run_cell, tiny

pytestmark = pytest.mark.usefixtures("one_thread")

METRIC = '''"""Operations a batch over the measured window."""


def read(ctx):
    return ctx.window["counts"]["ycsb_ops"] / ctx.window["batches"]
'''


def test_a_new_cell_and_metric_from_files_alone(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    traffic = json.loads((tmp_path / "perfbench" / "traffic"
                          / "ycsb-a.json").read_text())
    traffic.update(readproportion=0.95, updateproportion=0.05)
    (tmp_path / "perfbench" / "traffic" / "ycsb-b.json").write_text(
        json.dumps(traffic))
    (tmp_path / "perfbench" / "metrics" / "ops_per_batch.tree.py") \
        .write_text(METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "btree.ycsb-b", "config": "btree-ycsb-2p24",
        "traffic": "ycsb-b", "chips": 1, "why": "YCSB B, 95/5"})
    for m in bench["end_to_end"]:
        if m["name"] == "ycsb_ops_per_s":
            m["workloads"].append("btree.ycsb-b")
    bench["per_layer"].append({
        "name": "ops_per_batch.tree", "unit": "ops", "better": "higher",
        "source": "host_clock", "layer": "application entry",
        "moves": "ycsb_ops_per_s", "workloads": ["btree.ycsb-b"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell("btree.ycsb-b", tmp_path)
    assert cell.traffic["readproportion"] == 0.95
    assert "ops_per_batch.tree" in {m["name"] for m in cell.metrics(True)}
    rc, res, err = run_cell("btree.ycsb-b", trace=1, root=tmp_path,
                            overrides=tiny("btree"))
    assert rc == 0 and res["correct"], err
    assert res["metrics"]["ops_per_batch.tree"]["value"] == 64
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
