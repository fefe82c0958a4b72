"""Running a cell inside a test and reading its result line."""

import io
import json

from perfbench.lib import harness

# tiny sizes of each configuration and its traffic, for the CPU
TINY = {"config": {"recordcount": 4096, "lines": 1024},
        "traffic": {"batch": 64, "warmup_batches": 1,
                    "pool_batches_per_s": 40}}
CELLS = ["btree.ycsb-c", "btree.ycsb-a"]


def tiny(cell: str) -> dict:
    return TINY


def run_cell(cell, seed=2**31 + 11, trace=0, seconds=0.3, root=None,
             device="cpu", overrides=None):
    """One run at the tiny size on ``device``, in this process (where
    other test modules may have loaded JAX: the hygiene test checks a
    clean process); returns (exit code, result dict or None, standard
    error)."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(
        ["--workload", cell, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace)],
        root=root or harness.ROOT, device=device,
        overrides=overrides or tiny(cell), trace_seconds=0.2,
        forbidden=(), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
