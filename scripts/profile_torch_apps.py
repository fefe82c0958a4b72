"""Where the B-tree's and the transactions' time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_apps.py [--path btree|txn|scaling|all]
                                          [--out build/profiles/profile_apps.txt]

At ``chip_smoke.py``'s phase 5 and 6 sizes (a 2^24-key tree of fanout
16 on 2^21 lines, 4 nodes; 2^20 GCLs of 8 tuples, batches of 1024 txns)
it runs four windows after the kernels are built:

* ``btree_c``: 4 YCSB C batches of 1024 lookups; ``btree_a``: 1 YCSB A
  batch (half upserts), zipf 0.99, on the loaded tree;
* ``txn_2pl`` / ``txn_to``: 2 batches of 1024 txns each, zipf 0.6.

Each window runs twice on fresh draws (made before the clock starts):
plain, for the wall time and the host time per coherence round (wall /
rounds), and under ``torch.profiler`` (CPU + CUDA), for the device's
busy time (kernel and copy durations, each counted once:
``chip_smoke.device_busy_us``) against the wall, the device time,
share, launches and time a launch of K1 (``latch_apply_kernel``) and
of K2 (``gcl_fetch_kernel``) as the path calls them, the same of the
copies to the host, the launches per round (``cudaLaunchKernel``
calls / rounds) and the top device kernels.

``scaling``: K1 and K2 at R = 1024 (K2 with 160-byte rows, every slot
granted) over tables of 2^11 to 2^21 lines, on 20 calls a CUDA graph,
beside their bounds and ``index_select`` (``chip_smoke.latch_app_case``
and ``fetch_app_case``): both kernels touch the whole words table on
every call.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def profiled(make, run):
    """``run(make())`` (returns its coherence rounds) plainly and then,
    on fresh inputs, under the profiler; one summary line and the top
    device kernels.  Inputs are drawn outside the timed windows."""
    from torch.profiler import ProfilerActivity, profile
    inputs = make()
    t0 = time.perf_counter()
    rounds = run(inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inputs = make()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p_rounds = run(inputs)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_us = cs.device_busy_us(ev)
    k_ev = {k: [e for e in ev if f"{fn_}_kernel" in e.key]
            for k, fn_ in (("K1", "latch_apply"), ("K2", "gcl_fetch"))}
    k_us = {k: sum(e.self_device_time_total for e in es)
            for k, es in k_ev.items()}
    k_n = {k: sum(e.count for e in es) for k, es in k_ev.items()}
    d2h = [e for e in ev if e.key.startswith("Memcpy DtoH")]
    d2h_us = sum(e.self_device_time_total for e in d2h)
    launches = sum(e.count for e in ev if e.key.startswith("cudaLaunchKernel"))
    line = (f"plain: wall {wall:.4f} s, {rounds} rounds, host "
            f"{1e3 * wall / max(rounds, 1):.4f} ms a round; profiled: wall "
            f"{p_wall:.4f} s, {p_rounds} rounds, device busy "
            f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / p_wall:.3f} % of "
            f"wall); " + ", ".join(
                f"{k} {us / 1e3:.3f} ms ({100 * us / max(dev_us, 1e-9):.3f} "
                f"% of the device time) in {k_n[k]} launches, "
                f"{us / max(k_n[k], 1):.3f} us a launch"
                for k, us in k_us.items())
            + f"; copies to the host {sum(e.count for e in d2h)}, "
            f"{d2h_us / 1e3:.3f} ms ({100 * d2h_us / max(dev_us, 1e-9):.3f} "
            f"% of the device time); {launches} kernel launches "
            f"({launches / max(p_rounds, 1):.1f} a round)")
    return line, ev.table(sort_by="self_device_time_total", row_limit=12)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("btree", "txn", "scaling", "all"),
                    default="all")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles",
                                                  "profile_apps.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_apps: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.apps import (BTreeBatchConfig, DeviceTxnConfig,
                                  DeviceTxnEngine, TxnBatchConfig,
                                  btree_kv_batches, device_txn_batches)
    from repro_torch.core.rounds import (DevicePlane, make_state,
                                         txn_payload_width)
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    lines = [cs.card_line()]
    _build.build_all()
    seeds = iter(range(100, 200))

    if args.path in ("scaling", "all"):
        from repro_torch import kernels as K
        for lg in (11, 13, 15, 17, 19, 21):
            tag = f"2^{lg}"
            k1 = cs.latch_app_case(dev, K, 1 << lg, 1024, tag)
            k2 = cs.fetch_app_case(dev, K, 1 << lg, 40, 1024, 0.0, tag)
            lines.append(
                f"scaling L {tag}, R 1024: K1 ms_graph20 "
                f"{k1[f'ms_graph20_{tag}']} (bound {k1[f'bound_ms_{tag}']}, "
                f"words {100 * k1[f'words_share_{tag}']:.2f} %); K2 "
                f"ms_graph20 {k2[f'ms_graph20_{tag}']} (bound "
                f"{k2[f'bound_ms_{tag}']}, words "
                f"{100 * k2[f'words_share_{tag}']:.2f} %), index_select "
                f"ms_graph20 {k2[f'library_ms_graph20_{tag}']}")

    if args.path in ("btree", "all"):
        t0 = time.perf_counter()
        tree, oracle = cs.load_btree(dev)
        torch.cuda.synchronize()
        lines.append(f"btree: {cs.BTREE_KEYS} keys on {cs.BTREE_LINES} "
                     f"lines, height {tree.height}, loaded in "
                     f"{time.perf_counter() - t0:.3f} s")
        for name, ratio, iters in (("btree_c", 1.0, 4), ("btree_a", 0.5, 1)):
            def make():
                return btree_kv_batches(BTreeBatchConfig(
                    n_keys=cs.BTREE_KEYS, r_slots=1024, read_ratio=ratio,
                    zipf_theta=cs.YCSB_THETA, iters=iters),
                    seed=next(seeds))

            def run(batches):
                return sum(cs.run_ycsb(tree, oracle, batches)["rounds"])
            summary, table = profiled(make, run)
            lines += [f"{name}: {summary}", table]
        del tree

    if args.path in ("txn", "all"):
        w = txn_payload_width(cs.TXN_TUPLES)
        for algo in ("2pl", "to"):
            eng = DeviceTxnEngine(
                DevicePlane.open(make_state(cs.TXN_NODES, cs.TXN_GCLS,
                                            payload_width=w, device=dev)),
                DeviceTxnConfig(algo=algo, tuples_per_gcl=cs.TXN_TUPLES,
                                max_group_lines=cs.TXN_LINES_MAX))

            def make():
                return device_txn_batches(TxnBatchConfig(
                    n_gcls=cs.TXN_GCLS, tuples_per_gcl=cs.TXN_TUPLES,
                    batch=1024, iters=2, max_group_lines=cs.TXN_LINES_MAX,
                    zipf_theta=cs.TXN_THETA, n_nodes=cs.TXN_NODES),
                    seed=next(seeds))

            def run(batches):
                rounds = 0
                for txns, node, ts in batches:
                    # each batch's ts start past the last one's
                    ts = ts + np.int32(eng.stats.latency.count)
                    rounds += eng.run_batch(node, txns, ts=ts)[0].rounds
                return rounds
            summary, table = profiled(make, run)
            lines += [f"txn_{algo}: {summary}", table]
            del eng

    text = "\n".join(lines)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text[:20000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
