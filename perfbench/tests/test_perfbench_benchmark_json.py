"""``BENCHMARK.json`` against the contract the benchmark is checked by:
its keys, its names and units, that every file it names is there, and
that every per-layer metric moves an end-to-end metric its cells
report."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTHS = {"fieldcount", "fieldlength", "fanout", "key_bytes",
          "value_bytes"}


@pytest.fixture(scope="module")
def bench():
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(LINE.match(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_a_full_check_fits_its_time_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 \
        <= 43200


def test_entries_have_just_their_keys_and_legal_names(bench):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for part, want in keys.items():
        names = [e["name"] for e in bench[part]]
        assert len(names) == len(set(names))
        for e in bench[part]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"])
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert LINE.match(e[k]), (e["name"], k)
    all_names = [e["name"] for part in keys for e in bench[part]]
    metric_names = [e["name"] for e in bench["end_to_end"]
                    + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert all(NAME.match(n) for n in all_names)


def test_configs_and_cells(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    assert 1 <= len(configs) <= 24
    for c in configs.values():
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("perfbench/")
        json.loads(f.read_text())
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # a record's or a key's width is a shape, never a cut of scale
        assert not [k for k in c["reduced"] if k in WIDTHS
                    or k.endswith(("_dim", "_rank", "_bytes", "_size"))]
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in cells} == set(configs)
    for w in cells:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_metrics_have_readers_bounds_and_sources(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = {m["name"]: m for m in bench["end_to_end"]}["setup_s"]
    assert "workloads" not in setup
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "perfbench" / "metrics"
                / f"{m['name']}.py").is_file(), m["name"]


def test_every_per_layer_metric_moves_a_metric_its_cells_report(bench):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(cell):
        return {n for n, m in e2e.items()
                if "workloads" not in m or cell in m["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        mine = m.get("workloads", cells)
        assert mine and set(mine) <= set(cells)
        for cell in mine:
            assert m["moves"] in reports(cell), (m["name"], cell)
        layers.setdefault(m["layer"], m["layer"])
    for cell in cells:
        assert "setup_s" in reports(cell) and len(reports(cell)) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"]), cell
