"""End-to-end training driver; port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu --steps 20 --ckpt /tmp/ckpt

Runs on ``cuda`` unless ``--device cpu`` is given, with JAX's flags:
the data pipeline (``SyntheticLM``, the same tokens as JAX's for the same
seed and step) -> the train step (micro-batches, remat unless
``--smoke``, AdamW) -> async checkpoints every ``--ckpt-every`` steps
and at the end -> the straggler watchdog -> ``--resume`` from the newest
valid checkpoint.  Parameters are random, drawn from a
``torch.Generator`` seeded 0 on the device.  The encdec family, whose
loss needs encoder frames that the token pipeline does not make, gets
JAX's stand-in: zero bf16 ``enc_embeds`` of ``launch.specs``'
shape.  ``--production-mesh`` raises: the mesh waits for the sharded
stack (ROADMAP.md queue 1 item 9).

:func:`main` returns the run's record: per step the loss, grad norm,
learning rate, wall time (ms, synchronised) and kernel launches, and the
number of parameter leaves the first step's gradient missed.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import kernels, resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, SyntheticLM
from ..optim import AdamWConfig
from ..runtime import StragglerWatchdog
from ..train import TrainConfig, build_train_step, init_train_state
from .specs import train_inputs


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError("the production mesh waits for the "
                                  "sharded stack (ROADMAP.md queue 1 "
                                  "item 9)")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    tcfg = TrainConfig(
        micro_batches=args.micro,
        remat=not args.smoke,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                        total_steps=args.steps))
    step_fn, _, _ = build_train_step(cfg, tcfg, global_batch=args.batch,
                                     device=dev)
    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(0), dev)

    start = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr and args.resume:
        try:
            state, start = mgr.restore(state)
            print(f"[train] resumed from step {start}")
            start += 1
        except FileNotFoundError:
            pass

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=args.batch,
                                  seq_len=args.seq))
    extra = {}
    if cfg.family == "encdec":
        spec = train_inputs(cfg, args.seq, args.batch)["enc_embeds"]
        extra["enc_embeds"] = torch.zeros(spec.shape, dtype=spec.dtype,
                                          device=dev)
    dog = StragglerWatchdog()
    rec = {"arch": cfg.name, "start": start, "steps": [], "losses": [],
           "grad_norms": [], "lrs": [], "step_ms": [], "launches": [],
           "grads_missing": None, "tokens_per_step": args.batch * args.seq}
    t_start = time.time()
    for step in range(start, args.steps):
        batch = dict(data.batch_at(step), **extra)
        kernels.reset_launch_counts()
        _sync(dev)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        _sync(dev)
        dt = time.time() - t0
        dog.observe(dt, slowest_host=0)
        rec["steps"].append(step)
        rec["losses"].append(loss)
        rec["grad_norms"].append(gnorm)
        rec["lrs"].append(float(metrics["lr"]))
        rec["step_ms"].append(dt * 1e3)
        rec["launches"].append(kernels.launch_counts())
        if rec["grads_missing"] is None:
            rec["grads_missing"] = metrics["grads_missing"]
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:7.4f} "
                  f"gnorm {gnorm:7.3f} lr {float(metrics['lr']):.2e} "
                  f"{dt * 1e3:6.1f} ms", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(state, step)
    if mgr:
        mgr.save(state, args.steps - 1)
        mgr.wait()
    tot = time.time() - t_start
    print(f"[train] done: {args.steps - start} steps in {tot:.1f}s "
          f"({(args.steps - start) / max(tot, 1e-9):.2f} steps/s)")
    rec["seconds"] = tot
    rec["state"] = state
    return rec


if __name__ == "__main__":
    main()
