"""One run of one cell: set-up, the measured window, the traced window,
the metrics and the check, and the result line.

``main(argv)`` reads ``--workload``, ``--seed``, ``--seconds`` and
``--trace`` and finds everything by name from ``BENCHMARK.json``:

* the cell's ``config`` entry names the configuration's file; the file
  names the ``driver``, ``reference`` and ``control`` modules;
* the cell's ``traffic`` is ``traffic/<traffic>.json``, whose
  ``generator`` names the module under ``generators/``;
* the metrics the cell reports are the end-to-end metrics whose
  ``workloads`` list it (or that have none) with ``--trace 0``, and with
  ``--trace 1`` the per-layer metrics whose ``workloads`` list it (or,
  without that key, that move one of its end-to-end metrics); each is
  read by ``metrics/<name>.py``'s ``read(ctx)``, and one that returns
  None is left out of the line;
* every ``kernels/*.py`` is hooked in the traced window.

A run: set-up (the traffic pool, the program's state, the warm-up
batches; ``setup_s`` counts from the process's start to the first timed
batch), then batches one after another (a closed loop: one batch
outstanding, each of its slots a client waiting for its reply) until
``--seconds`` have passed, the last batch ending the window.  Every
batch is drawn in set-up: the pool holds ``pool_batches_per_s`` (a
traffic file's key, about twice the rate the program reaches) times the
seconds to run, and a window that reaches the pool's end stops there,
so that no batch is drawn inside it.  With ``--trace 1`` the window is
followed by at least ``TRACE_SECONDS`` and ``TRACE_BATCHES`` more
batches under ``torch.profiler`` with the kernel hooks and the layer
spans on.
Then the program's outputs are held against the plain reference, every
number compared is printed beside its limit, and the result's JSON line
is the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from perfbench.lib import trace as tr
from perfbench.lib.program import Patch, rounds_run

ROOT = Path(__file__).resolve().parents[2]
TRACE_SECONDS = 3.0
TRACE_BATCHES = 8
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_loaded: dict = {}


def load(path: Path):
    """A module loaded from its file (names may hold dots)."""
    path = Path(path).resolve()
    mod = _loaded.get(path)
    if mod is None:
        name = "perfbench_file_" + "_".join(
            "".join(c if c.isalnum() else "_" for c in part)
            for part in path.relative_to(path.parents[1]).parts)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return mod


def _module(folder: str, name: str):
    return importlib.import_module(f"perfbench.{folder}.{name}")


def forbidden_modules(forbidden=FORBIDDEN) -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in forbidden)


def host_times() -> tuple:
    """(this process's CPU seconds, the machine's steal seconds): what
    the host's clock gave the window and what the hypervisor took."""
    t = os.times()
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        steal = float(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return t.user + t.system, steal


def host_probe() -> str:
    """How fast the host runs now, outside every timed span: a fixed
    Python loop and a copy of 16 MiB into fresh pageable memory (the
    shape of the plane's telemetry copies), each the best of three."""
    loop, copy = [], []
    src = np.ones(1 << 22, np.int32)
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for i in range(200_000):
            x += i & 7
        loop.append(time.perf_counter() - t)
        t = time.perf_counter()
        dst = np.empty_like(src)
        dst[:] = src
        copy.append(time.perf_counter() - t)
        del dst
    return (f"loop {0.2 / min(loop):.3f} M/s, fresh copy "
            f"{src.nbytes / min(copy) / 1e9:.3f} GB/s")


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc is not
    there)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


class Cell:
    """Everything a cell's name resolves to."""

    def __init__(self, name: str, root: Path = ROOT, overrides=None):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = bench
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"unknown workload {name!r} (have "
                             f"{sorted(by_name)})")
        self.name = name
        self.entry = by_name[name]
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((self.root / cfg["file"]).read_text())
        pb = self.root / "perfbench"
        self.traffic = json.loads(
            (pb / "traffic" / f"{self.entry['traffic']}.json").read_text())
        overrides = overrides or {}
        self.config.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.driver = _module("drivers", self.config["driver"])
        self.reference = _module("references", self.config["reference"])
        self.generator = _module("generators", self.traffic["generator"])
        self.kernels = [_module("kernels", p.stem)
                        for p in sorted((pb / "kernels").glob("*.py"))
                        if not p.stem.startswith("_")]
        self.metric_dir = pb / "metrics"

    def metrics(self, trace: bool) -> list:
        mine = lambda m: self.name in m["workloads"]
        e2e = [m for m in self.bench["end_to_end"]
               if "workloads" not in m or mine(m)]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (mine(m) if "workloads" in m else m["moves"] in moved)]

    def reader(self, name: str):
        return load(self.metric_dir / f"{name}.py")


def _capture(kernel, calls):
    def make(original):
        span = f"{tr.SPAN}kernel.{kernel.NAME}"

        def hooked(*args, **kwargs):
            import torch
            calls.append(kernel.capture(*args, **kwargs))
            with torch.profiler.record_function(span):
                return original(*args, **kwargs)
        return hooked
    return make


def _span(name):
    def make(original):
        span = tr.SPAN + name

        def spanned(*args, **kwargs):
            import torch
            with torch.profiler.record_function(span):
                return original(*args, **kwargs)
        return spanned
    return make


class Run:
    """The batches of one run, in order, and what they recorded."""

    def __init__(self, program, sync, pool: int | None = None):
        self.program, self.sync = program, sync
        self.pool = pool
        self.next = 0
        self.batch_s = []

    def batches(self, seconds: float, least: int = 1):
        """Runs batches until ``seconds`` have passed (and at least
        ``least``), or until the pool's last batch; returns (seconds
        taken, op latencies, summed counts, batches)."""
        lats, counts, n = [], {}, 0
        t0 = time.perf_counter()
        while (n < least or time.perf_counter() - t0 < seconds) and \
                (self.pool is None or self.next < self.pool):
            tb = time.perf_counter()
            lat, c = self.program.run_batch(self.next)
            self.batch_s.append(time.perf_counter() - tb)
            self.next += 1
            n += 1
            lats.append(lat)
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        self.sync()
        return (time.perf_counter() - t0,
                np.concatenate(lats) if lats else np.zeros(0), counts, n)


def traced(cell: Cell, run: Run, seconds: float,
           least: int = TRACE_BATCHES) -> dict:
    """``seconds`` and at least ``least`` batches under the profiler,
    the kernel hooks and the layer spans on."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    calls = {k.NAME: [] for k in cell.kernels}
    targets = [(mod, attr, _capture(k, calls[k.NAME]))
               for k in cell.kernels for mod, attr in k.TARGETS]
    targets += [(mod, attr, _span(name))
                for mod, attr, name in getattr(cell.driver, "SPANS", [])]
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    r0 = rounds_run()
    with Patch(targets):
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW):
                wall, lats, counts, n = run.batches(seconds, least)
    rounds = rounds_run() - r0
    t0 = time.perf_counter()
    summary = tr.summarize(tr.records(prof),
                           [k.DEVICE_KERNEL for k in cell.kernels])
    kernels = {k.NAME: {"calls": len(calls[k.NAME]),
                        "bytes": sum(k.call_bytes(c)
                                     for c in calls[k.NAME]),
                        "device_s": (summary or {}).get("kernel_s", {})
                        .get(k.DEVICE_KERNEL, 0.0)}
               for k in cell.kernels}
    return {"summary": summary, "kernels": kernels, "rounds": rounds,
            "batches": n, "wall_s": wall,
            "read_s": time.perf_counter() - t0}


def main(argv=None, *, started: float | None = None, root: Path = ROOT,
         device=None, overrides=None, trace_seconds: float = TRACE_SECONDS,
         forbidden=FORBIDDEN, out=None, err=None) -> int:
    """One run; returns the exit code.  ``device`` (``"cpu"``) skips
    the look for a card, as the CPU tests do; so does an empty
    ``forbidden`` the look for JAX's modules, which a test process that
    also holds the reference's tests has loaded."""
    t_top = time.perf_counter() if started is None else started
    age = process_age_s() - (time.perf_counter() - t_top) \
        if started is not None else 0.0
    out = out or sys.stdout
    err = err or sys.stderr
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, root, overrides)

    import torch
    import repro_torch  # noqa: F401  (a checkout without the port fails here)
    torch.set_num_threads(1)
    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available():
            print("perfbench: no CUDA device", file=err)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"perfbench: {cell.name} needs {chips} cards, "
                  f"{torch.cuda.device_count()} are here", file=err)
            return 2
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(dev)
    else:
        dev = torch.device(device)
        kind = f"{dev.type} (not a card)"
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    tm = cell.traffic
    seconds = args.seconds
    note = lambda *a: print("perfbench:", *a, file=err, flush=True)

    errors = []
    metrics, device_info, breakdown, checks = {}, {}, None, {}
    attempted = failed = 0
    try:
        marks = [("start", time.perf_counter())]
        gen = cell.generator.Traffic(cell.config, tm, args.seed)
        pool = window_end = int(tm["warmup_batches"]) + math.ceil(
            float(tm["pool_batches_per_s"]) * seconds)
        if args.trace:
            pool += max(TRACE_BATCHES, math.ceil(
                float(tm["pool_batches_per_s"]) * trace_seconds))
        for i in range(pool):
            gen.batch(i)
        marks.append(("traffic", time.perf_counter()))
        program = cell.driver.Cell(cell.config, gen, cell.reference, dev)
        sync()
        marks.append(("program", time.perf_counter()))
        run = Run(program, sync, window_end)
        run.batches(0.0, least=int(tm["warmup_batches"]))
        sync()
        marks.append(("warm-up", time.perf_counter()))
        setup_s = age + marks[-1][1] - t_top
        note(f"set-up {setup_s:.3f} s: before {marks[0][1] - t_top + age:.3f}"
             + "".join(f", {k} {t - marks[i][1]:.3f}"
                       for i, (k, t) in enumerate(marks[1:]))
             + f" ({pool} batches drawn)")

        # the set-up's objects (the traffic pool above all) are the
        # harness's: keep them out of the program's garbage collections
        gc.collect()
        gc.freeze()
        probe = host_probe()
        c0 = program.counters()
        first = len(run.batch_s)
        h0 = host_times()
        wall, lats, counts, n = run.batches(seconds)
        h1 = host_times()
        c1 = program.counters()
        attempted = int(lats.shape[0])
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        if run.next == window_end:
            note(f"the window reached the pool's end ({window_end} "
                 f"batches) after {wall:.3f} s: raise the traffic "
                 f"file's pool_batches_per_s")
        q = np.percentile(run.batch_s[first:], [0, 25, 50, 75, 100])
        note(f"window {wall:.3f} s, {n} batches, {attempted} operations; "
             f"a batch {' / '.join(f'{x:.4f}' for x in q)} s "
             f"(min / q1 / median / q3 / max); process CPU "
             f"{h1[0] - h0[0]:.3f} s, machine steal {h1[1] - h0[1]:.3f} s; "
             f"host before it: {probe}; after it: {host_probe()}")
        ctx = SimpleNamespace(
            setup_s=setup_s, trace=None,
            window={"seconds": wall, "batches": n, "latencies_s": lats,
                    "counts": counts,
                    "counters": {k: c1[k] - c0[k] for k in c1}})
        if args.trace:
            run.pool = pool
            ctx.trace = traced(cell, run, trace_seconds)
            s = ctx.trace["summary"]
            note(f"traced {ctx.trace['wall_s']:.3f} s, "
                 f"{ctx.trace['batches']} batches, read in "
                 f"{ctx.trace['read_s']:.3f} s")
            if s is not None:
                device_info.update(busy_s=s["busy_s"],
                                   window_s=s["window_s"])
                breakdown = {"device_ops": tr.top(s["device_ops"]),
                             "idle_gaps": tr.top(s["idle_by_span"])}
        for m in cell.metrics(bool(args.trace)):
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info = {"platform": "gpu" if dev.type == "cuda" else
                       dev.type, "kind": kind, "count": chips,
                       "memory_peak_bytes": int(peak), **device_info}
        del ctx
        t_check = time.perf_counter()
        checks = program.check()
        note(f"check {time.perf_counter() - t_check:.3f} s over "
             f"{run.next} batches")
    except Exception:                              # noqa: BLE001
        errors.append(traceback.format_exc())
        print(errors[-1], file=err)
        failed = attempted
    checks["errors"] = len(errors)
    limits = dict(getattr(cell.reference, "LIMITS", {}), errors=0)
    table = {k: {"value": v, "limit": limits.get(k, 0)}
             for k, v in checks.items()}
    correct = all(c["value"] <= c["limit"] for c in table.values())

    bad = forbidden_modules(forbidden)
    if bad:
        print(f"perfbench: modules of the JAX package or JAX are loaded: "
              f"{bad}", file=err)
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    for k, c in table.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
