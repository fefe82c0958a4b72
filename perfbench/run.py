"""Run one cell of the benchmark once (see ``perfbench/__init__.py``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the last line of standard output is the
result's JSON object, and the numbers compared for ``correct`` are the
last lines of standard error.
"""

import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root and the port's sources, in place of this folder
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], started=STARTED))
