"""Where the LM serving path's time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_lm.py [--arch qwen3-1.7b mamba2-2.7b]
        [--out-dir build/profiles] [--src DIR] [--serve REPEATS]

(``--src``: profile the ``repro_torch`` package under DIR, for instance
an unpacked older commit, instead of this checkout's.  ``--serve``:
profile nothing; time the serve driver ``launch.serve.main`` instead,
REPEATS times for each architecture at ``chip_smoke.py`` phase 4's
requests, and print each run's tokens a second.  To compare two
commits, run it for each in turns within one chip call: other, this,
this, other.)

For each architecture, at its full published config with random bf16
weights (the port's ``init_params``, seed 0): one prefill of 4 prompts
of 512 tokens (with the serve driver's zero patch or frame embeddings
for the vlm and encdec families), the cache grown by 32 slots, then
decode steps, as ``repro_torch.launch.serve`` runs them.  Reports

1. plain: the prefill's wall time and the mean wall time of 16 decode
   steps (host clock around work that ends in a synchronize);
2. under ``torch.profiler`` (CPU + CUDA), one prefill and 8 decode
   steps: the device's busy time (sum of kernel and copy durations,
   each counted once: ``chip_smoke.device_busy_us``) against the wall
   time, the device kernels launched in one decode step and its device
   busy time, and the top device kernels and host ops;
3. under ``torch.profiler``, one prefill alone: its device time and the
   share of it spent in the prefill's kernel (K4 ``flash_attention``
   for the attention families, K5 ``ssd_intra`` for ssm).

Needs a CUDA device; prints the card's name and power limit first.
Writes the full tables to ``<out-dir>/profile_lm_<arch>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

BATCH, PROMPT, GEN = 4, 512, 32
SERVE_REQUESTS = {"qwen3-1.7b": 16}    # 8 for the others, as phase 4


def serve_runs(arch, repeats, src):
    """``launch.serve.main`` at the full config of ``arch``, ``repeats``
    times: tokens a second of each run (the driver's own clock, after
    its weights are made)."""
    from repro_torch.launch import serve
    n = SERVE_REQUESTS.get(arch, 8)
    runs = []
    for _ in range(repeats):
        res = serve.main(["--arch", arch, "--requests", str(n),
                          "--batch", str(BATCH), "--prompt-len",
                          str(PROMPT), "--gen", str(GEN)])
        runs.append(res["tokens"] / res["seconds"])
        del res
        torch.cuda.empty_cache()
    return {"src": src, "arch": arch, "tok_per_s": runs}


def profile_arch(arch, dev):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                         device=dev)
    batch = {"tokens": toks}
    # (an older package under --src has neither helper nor these families)
    if hasattr(serve, "frontend_stubs"):
        batch.update(serve.frontend_stubs(cfg, BATCH, PROMPT, dev))
    max_len = PROMPT + GEN + (serve.prefix_len(cfg) if hasattr(
        serve, "prefix_len") else 0)
    ctx = lm.NO_PARALLEL

    def prefill():
        logits, cache = lm.prefill(params, batch, cfg, ctx)
        return logits, serve.grow_cache(cfg, cache, max_len)

    def decode(cache, nxt, n):
        for _ in range(n):
            logits, cache = lm.decode_step(params, cache, nxt, cfg, ctx)
            nxt = logits.argmax(-1)[:, None]
        return cache, nxt

    logits, cache = prefill()                   # warm-up (kernel build)
    decode(cache, logits.argmax(-1)[:, None], 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode(cache, logits.argmax(-1)[:, None], 16)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    lines = [f"{arch}: prefill (B {BATCH}, S {PROMPT}) {prefill_s * 1e3:.3f} "
             f"ms wall; decode step (B {BATCH}) {step_ms:.3f} ms wall"]

    from torch.profiler import ProfilerActivity, profile
    n_dec = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = prefill()
        decode(cache, logits.argmax(-1)[:, None], n_dec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = chip_smoke.device_busy_us(events)
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    lines.append(f"{arch}: profiled prefill + {n_dec} decode steps: wall "
                 f"{wall:.3f} s, device busy {dev_us / 1e6:.4f} s "
                 f"({100 * dev_us / 1e6 / wall:.2f} % of wall), "
                 f"{n_kernels} device kernels and copies")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof1:
        decode(cache, logits.argmax(-1)[:, None], 1)
        torch.cuda.synchronize()
    per_step = sum(1 for e in prof1.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    step_us = chip_smoke.device_busy_us(prof1.key_averages())
    lines.append(f"{arch}: one decode step launches {per_step} device "
                 f"kernels and copies ({cfg.n_layers} layers), device busy "
                 f"{step_us / 1e3:.4f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof2:
        prefill()
        torch.cuda.synchronize()
    ev2 = prof2.key_averages()
    pf_us = chip_smoke.device_busy_us(ev2)
    needle = "ssd_intra" if cfg.family == "ssm" else "flash_attention"
    k_us = sum(e.self_device_time_total for e in ev2 if needle in e.key)
    lines.append(f"{arch}: one prefill's device time {pf_us / 1e3:.3f} ms, "
                 f"of which {needle} kernels {k_us / 1e3:.3f} ms "
                 f"({100 * k_us / pf_us:.2f} %)")
    tables = [events.table(sort_by="self_device_time_total", row_limit=15),
              events.table(sort_by="self_cpu_time_total", row_limit=20)]
    del params, cache, logits
    torch.cuda.empty_cache()
    return lines, tables


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3-1.7b", "mamba2-2.7b"])
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                      "profiles"))
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--serve", type=int, default=0, metavar="REPEATS")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    if not torch.cuda.is_available():
        print("profile_torch_lm: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), flush=True)
    _build.build_all()
    if args.serve:
        for arch in args.arch:
            print("serve " + json.dumps(serve_runs(arch, args.serve,
                                                   args.src)), flush=True)
        return 0
    os.makedirs(args.out_dir, exist_ok=True)
    for arch in args.arch:
        lines, tables = profile_arch(arch, dev)
        print("\n".join(lines), flush=True)
        print(tables[0][:3000], flush=True)
        with open(os.path.join(args.out_dir, f"profile_lm_{arch}.txt"),
                  "w") as f:
            f.write("\n".join(lines + tables) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
