"""The profiler arithmetic on a hand-made window: busy time as a union,
host copies, launches, kernel time by name, and idle gaps charged to the
innermost span over each gap's start."""

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench.lib import trace


def ev(name, start, end, on_card=False, annotation=False):
    return (name, on_card, start, end, annotation)


def test_summary_of_a_hand_made_window():
    cuda = True
    events = [
        ev(trace.WINDOW, 0, 100, annotation=True),
        ev("pb:batch", 1, 99, annotation=True),
        ev("pb:engine.round", 5, 35, annotation=True),
        ev("pb:plane.telemetry_copy", 36, 90, annotation=True),
        ev("aten::add", 6, 7),
        ev("void latch_apply_kernel(int*)", 10, 20, cuda),
        ev("Memcpy DtoH (Device -> Pageable)", 15, 30, cuda),
        ev("other_kernel", 50, 60, cuda),
        ev("other_kernel", 95, 120, cuda),
        ev("pb:batch", 0, 100, cuda, annotation=True),
    ]
    s = trace.summarize(events, ["latch_apply_kernel"])
    assert abs(s["window_s"] - 100e-6) < 1e-12
    assert abs(s["busy_s"] - 35e-6) < 1e-12           # 10-30, 50-60, 95-100
    assert s["launches"] == 4
    assert abs(s["host_copy_s"] - 15e-6) < 1e-12
    assert abs(s["kernel_s"]["latch_apply_kernel"] - 10e-6) < 1e-12
    idle = s["idle_by_span"]
    assert abs(idle["harness"] - 10e-6) < 1e-12       # 0-10
    assert abs(idle["engine.round"] - 20e-6) < 1e-12  # 30-50
    assert abs(idle["plane.telemetry_copy"] - 35e-6) < 1e-12  # 60-95
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == \
        [["b", 3.0], ["c", 2.0]]


def test_no_window_no_summary():
    assert trace.summarize([ev("aten::add", 0, 1)]) is None


def test_innermost_span_of_nested_and_sibling_spans():
    spans = [(0, 100, "a"), (10, 20, "b"), (12, 15, "c"), (30, 40, "d")]
    got = trace.innermost(spans, [5, 11, 13, 16, 25, 35, 120])
    assert got == ["a", "b", "c", "b", "a", "d", None]


def test_records_of_a_real_profile():
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with record_function("pb:engine.round"):
                x.add_(1)
    recs = trace.records(prof)
    names = {r[0] for r in recs}
    assert {trace.WINDOW, "pb:engine.round", "aten::add_"} <= names
    win = [r for r in recs if r[0] == trace.WINDOW][0]
    assert not win[1] and win[4] and win[3] > win[2]
    s = trace.summarize(recs)
    assert s["launches"] == 0 and s["window_s"] > 0
