"""The readers of the program's own spans and counters: the traced
window is the program's last tracing session, its ``engine.round``
count is the window's rounds, and each reader's arithmetic on a
hand-made window; none reads anything without device events."""

from types import SimpleNamespace

import pytest
import torch

from perfbench.lib import harness, program_spans
from perfbench.tests._run import CELLS, tiny

pytestmark = pytest.mark.usefixtures("one_thread")

READERS = ("round_host_ms.tree", "host_reads_per_batch.tree",
           "host_wait_ms_per_batch.tree", "telemetry_mib_per_batch.tree")


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_window_is_the_programs_last_session(cell):
    c = harness.Cell(cell, overrides=tiny(cell))
    gen = c.generator.Traffic(c.config, c.traffic, 2**31 + 5)
    program = c.driver.Cell(c.config, gen, c.reference,
                            torch.device("cpu"))
    run = harness.Run(program, lambda: None)
    run.batches(0.0, least=2)                     # tracing off
    trace = harness.traced(c, run, 0.1, least=3)
    s = program_spans.last_session()
    spans, counters = s["spans"], s["counters"]
    assert spans["engine.round"]["count"] == trace["rounds"] > 0
    n = {v: spans[v]["count"] if v in spans else 0
         for v in ("plane.descent", "plane.rmw", "plane.ops")}
    verbs = sum(n.values())
    assert n["plane.descent"] >= trace["batches"]
    assert counters["plane.telemetry_bytes"] == \
        verbs * (8 * int(c.config["lines"]) + 16)
    # a check a round and one more a spin (an RMW spins twice); six
    # telemetry copies a verb; six result copies a descent, two else
    checks = trace["rounds"] + n["plane.descent"] + 2 * n["plane.rmw"] \
        + n["plane.ops"]
    assert spans["plane.spin_sync"]["count"] == checks
    assert counters["plane.host_reads"] == checks + 6 * verbs \
        + 6 * n["plane.descent"] + 2 * (n["plane.rmw"] + n["plane.ops"])
    # no card here: the window has no device events, so nothing is read
    ctx = SimpleNamespace(trace=trace)
    assert trace["summary"]["launches"] == 0
    for name in READERS:
        assert c.reader(name).read(ctx) is None


def _ctx(launches=5):
    return SimpleNamespace(trace={"summary": {"launches": launches},
                                  "batches": 4, "rounds": 28})


SESSION = {"session": 3,
           "spans": {"engine.round": {"count": 28.0, "seconds": 0.2,
                                      "self_seconds": 0.14},
                     "plane.spin_sync": {"count": 32.0, "seconds": 0.03,
                                         "self_seconds": 0.03},
                     "plane.result_copy": {"count": 4.0, "seconds": 0.05,
                                           "self_seconds": 0.01}},
           "counters": {"plane.host_reads": 80.0,
                        "plane.telemetry_bytes": 4 * (16 * 2**20 + 16)}}


def test_each_readers_arithmetic(monkeypatch):
    monkeypatch.setattr(program_spans, "last_session", lambda: SESSION)
    cell = harness.Cell(CELLS[0])
    got = {n: cell.reader(n).read(_ctx()) for n in READERS}
    assert got["round_host_ms.tree"] == pytest.approx(1e3 * 0.14 / 28)
    assert got["host_reads_per_batch.tree"] == 20
    assert got["host_wait_ms_per_batch.tree"] == pytest.approx(
        1e3 * 0.04 / 4)
    assert got["telemetry_mib_per_batch.tree"] == 16 + 16 / 2**20
    for name in READERS:
        assert cell.reader(name).read(_ctx(launches=0)) is None
        assert cell.reader(name).read(SimpleNamespace(trace=None)) is None


def test_a_program_without_sessions_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "last_session", lambda: None)
    cell = harness.Cell(CELLS[0])
    for name in READERS:
        assert cell.reader(name).read(_ctx()) is None
    empty = {"session": 1, "spans": {}, "counters": {}}
    monkeypatch.setattr(program_spans, "last_session", lambda: empty)
    for name in READERS:
        assert cell.reader(name).read(_ctx()) is None


def test_the_readers_are_in_the_benchmark_for_both_cells():
    for cell in CELLS:
        names = {m["name"] for m in harness.Cell(cell).metrics(True)}
        assert set(READERS) <= names
