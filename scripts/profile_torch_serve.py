"""Where the serving path's time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_serve.py [--out chiprun_out/profile_serve.txt]

Runs the serve phase of ``chip_smoke.py`` (48 seeded requests at
Qwen3-1.7B's attention width over the default ``KVPoolConfig``) three
times after the kernels are built:

1. plain, for the wall time;
2. under ``torch.profiler`` (CPU + CUDA): the device's busy time (sum of
   kernel and copy durations) against the wall time, and the top device
   kernels and host ops;
3. under ``cProfile``: the host functions of the port by cumulative time.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_serve.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    lines = [chip_smoke.card_line()]
    _build.build_all()

    t0 = time.perf_counter()
    res = chip_smoke.serve(dev)
    lines.append(f"plain serve: wall {time.perf_counter() - t0:.3f} s, "
                 f"{res}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.serve(dev)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events)
    lines.append(f"profiled serve: wall {wall:.3f} s, device busy "
                 f"{dev_us / 1e6:.3f} s ({100 * dev_us / 1e6 / wall:.2f} % "
                 f"of wall)")
    lines.append(events.table(sort_by="self_device_time_total",
                              row_limit=15))
    lines.append(events.table(sort_by="self_cpu_time_total", row_limit=25))

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    chip_smoke.serve(dev)
    pr.disable()
    lines.append(f"cProfile serve: wall {time.perf_counter() - t0:.3f} s")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(
        r"repro_torch|chip_smoke", 40)
    lines.append(buf.getvalue())

    text = "\n".join(lines)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text[:6000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
