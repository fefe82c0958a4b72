"""The control of a cell: the reference with one guarantee broken, in the
program's place, judged by the cell's own comparison.

    python3 perfbench/control.py --workload <cell> --batches <n> --seeds <s> [<s> ...]

For each seed it draws the cell's traffic, runs the configuration's
control module (``controls/<control>.py``) over the first ``n`` batches
(as many as a run of the cell reaches) and prints one JSON line: the
seed, every number compared beside its limit, and ``correct``.  A sound
comparison reads ``correct`` false on every seed.  It needs no card;
the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench.lib import harness  # noqa: E402


def control(cell, seed: int, n_batches: int) -> dict:
    gen = cell.generator.Traffic(cell.config, cell.traffic, seed)
    mod = harness._module("controls", cell.config["control"])
    checks = mod.run(cell.config, gen, cell.reference, n_batches)
    limits = getattr(cell.reference, "LIMITS", {})
    table = {k: {"value": v, "limit": limits.get(k, 0)}
             for k, v in checks.items()}
    return {"seed": seed, "batches": n_batches,
            "correct": all(c["value"] <= c["limit"]
                           for c in table.values()),
            "checks": table}


def main(argv=None, root=harness.ROOT, overrides=None, out=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload, root, overrides)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = control(cell, seed, args.batches)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), file=out or sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
