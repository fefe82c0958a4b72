"""K1's and K2's byte counts on hand-made calls (empty slots, lines out
of range, lines and pages named twice), and the traced window's hook on
the names the round engine looks the kernels up by."""

import numpy as np
import pytest
import torch

from perfbench.kernels import gcl_fetch, latch_apply
from perfbench.lib import harness
from perfbench.lib.program import resolve
from perfbench.tests._run import CELLS, tiny

pytestmark = pytest.mark.usefixtures("one_thread")


def test_latch_apply_counts_each_distinct_valid_line_once():
    # 6 slots: two empty, line 9 past the table's 8, line 3 twice
    line = np.array([-1, 3, 3, 9, 0, -1])
    assert latch_apply.needed_bytes(8, line) == \
        4 * 6 + 20 * 3 + 12 * 6 + 16 * 2
    assert latch_apply.needed_bytes(8, np.full(4, -1)) == 16 * 4
    assert latch_apply.needed_bytes(8, np.zeros(0, int)) == 0


def test_gcl_fetch_counts_each_distinct_valid_page_once():
    # 4 pages of 160 bytes, page 2 named twice, one empty, one past P
    page = np.array([2, 2, -1, 5, 1])
    row = 160
    assert gcl_fetch.needed_bytes(4, row, page) == \
        4 * 5 + 8 * 3 + 5 * (row + 12) + 2 * (16 + row)
    assert gcl_fetch.needed_bytes(4, row, np.full(3, -1)) == \
        3 * (4 + row + 12)


def test_captures_read_the_call_as_the_engine_makes_it():
    words = torch.zeros((8, 2), dtype=torch.int32)
    req = {"line": torch.tensor([-1, 3, 3, 9, 0, -1], dtype=torch.int32)}
    assert latch_apply.call_bytes(latch_apply.capture(words, req)) == \
        latch_apply.needed_bytes(8, req["line"].numpy())
    pages = torch.zeros((4, 40), dtype=torch.int32)
    page = torch.tensor([2, 2, -1, 5, 1], dtype=torch.int32)
    got = gcl_fetch.capture(pages, torch.zeros((4, 2), dtype=torch.int32),
                            page, page, page)
    assert gcl_fetch.call_bytes(got) == \
        gcl_fetch.needed_bytes(4, 160, page.numpy())


def test_the_hook_targets_are_where_the_engine_looks():
    for k in (latch_apply, gcl_fetch):
        for mod, attr in k.TARGETS:
            assert resolve(mod, attr) is not None, (mod, attr)


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_window_counts_every_kernel_call(name):
    cell = harness.Cell(name, overrides=tiny(name))
    gen = cell.generator.Traffic(cell.config, cell.traffic, 12)
    program = cell.driver.Cell(cell.config, gen, cell.reference,
                               torch.device("cpu"))
    run = harness.Run(program, lambda: None)
    run.batches(0.0, least=1)
    out = harness.traced(cell, run, 0.05)
    assert out["rounds"] > 0
    for k in ("latch_apply", "gcl_fetch"):
        assert out["kernels"][k]["calls"] == out["rounds"]
        assert out["kernels"][k]["bytes"] > 0
    # the hooks are gone once the window closes
    from repro_torch.core.rounds import engine
    from repro_torch.kernels.latch_ops import apply_batch
    assert engine.apply_batch is apply_batch
