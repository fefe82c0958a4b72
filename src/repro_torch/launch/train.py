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
:func:`frontend_stand_ins`: seeded random bf16 ``enc_embeds`` of
``launch.specs``' shape (JAX's driver passes none, and its encdec loss
raises without them).  The step runs over ``make_local_mesh()``, or
with ``--production-mesh`` over ``make_production_mesh()`` (data 16,
model 16, every shard on the one device: the micro-batch count splits
the batch by the 16 data rows, and a moe config runs expert parallelism
over the 16 model shards), and the state is placed with the reference's
``state_specs`` and ``to_named``; the exchanges between cards wait for
several cards (ROADMAP.md queue 1 item 9).

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
from ..parallel.sharding import device_put, to_named
from ..runtime import StragglerWatchdog
from ..train import TrainConfig, build_train_step, init_train_state
from ..train.step import state_specs
from .mesh import make_local_mesh, make_production_mesh
from .specs import train_inputs


_STAND_IN_SEED = 1


def frontend_stand_ins(cfg, seq: int, batch: int, device):
    """Seeded N(0, 1) bf16 stand-ins on ``device`` for the inputs of
    ``train_inputs(cfg, seq, batch)`` that the token pipeline does not
    make: the vlm's patch and the encdec's frame embeddings.  Not the
    serve's zeros: a zero row reaches every rms norm of the rows it
    passes through as zeros, where the norm's gradient is rsqrt(eps) =
    1e3, and through the encoder's norms (or the norms at llava's patch
    rows) the backward overflows to NaN at full depth, in the JAX model
    as in the port's (ROADMAP.md, "Semantics the port fixed")."""
    gen = torch.Generator(device=device).manual_seed(_STAND_IN_SEED)
    return {k: torch.randn(sp.shape, generator=gen, device=device)
            .to(sp.dtype) for k, sp in train_inputs(cfg, seq, batch).items()
            if k not in ("tokens", "labels")}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_steps(step_fn, state, data, extra, steps, dev, *, start=0,
              log_every=1, mgr=None, ckpt_every=0):
    """The driver's loop: steps ``start`` .. ``steps - 1`` of ``step_fn``
    on ``data.batch_at(step)`` plus ``extra``, with the launch counts
    reset before each step, the straggler watchdog, and a checkpoint to
    ``mgr`` every ``ckpt_every`` steps.  Returns the record (without
    ``seconds``): per step the loss, grad norm, learning rate, wall time
    (ms, synchronised) and kernel launches, the parameter leaves the
    first step's gradient missed, and the final ``state``."""
    dog = StragglerWatchdog()
    rec = {"steps": [], "losses": [], "grad_norms": [], "lrs": [],
           "step_ms": [], "launches": [], "grads_missing": None}
    for step in range(start, steps):
        batch = dict(data.batch_at(step), **extra)
        kernels.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        _sync(dev)
        dt = time.perf_counter() - t0
        dog.observe(dt, slowest_host=0)
        rec["steps"].append(step)
        rec["losses"].append(loss)
        rec["grad_norms"].append(gnorm)
        rec["lrs"].append(float(metrics["lr"]))
        rec["step_ms"].append(dt * 1e3)
        rec["launches"].append(kernels.launch_counts())
        if rec["grads_missing"] is None:
            rec["grads_missing"] = metrics["grads_missing"]
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:7.4f} "
                  f"gnorm {gnorm:7.3f} lr {float(metrics['lr']):.2e} "
                  f"{dt * 1e3:6.1f} ms", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(state, step)
    rec["state"] = state
    return rec


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

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    mesh = (make_production_mesh(device=dev) if args.production_mesh
            else make_local_mesh(device=dev))
    tcfg = TrainConfig(
        micro_batches=args.micro,
        remat=not args.smoke,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                        total_steps=args.steps))
    step_fn, ctx, n_micro = build_train_step(cfg, mesh, tcfg,
                                             global_batch=args.batch)
    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
    state = device_put(state, to_named(mesh, state_specs(mesh, state, tcfg)))

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
    extra = frontend_stand_ins(cfg, args.seq, args.batch, dev) \
        if cfg.family == "encdec" else {}
    t_start = time.time()
    rec = run_steps(step_fn, state, data, extra, args.steps, dev,
                    start=start, log_every=args.log_every, mgr=mgr,
                    ckpt_every=args.ckpt_every)
    if mgr:
        mgr.save(rec["state"], args.steps - 1)
        mgr.wait()
    tot = time.time() - t_start
    print(f"[train] done: {args.steps - start} steps in {tot:.1f}s "
          f"({(args.steps - start) / max(tot, 1e-9):.2f} steps/s)")
    rec.update(arch=cfg.name, start=start, seconds=tot,
               tokens_per_step=args.batch * args.seq, mesh=mesh.shape,
               ep=ctx.ep, n_micro=n_micro)
    return rec


if __name__ == "__main__":
    main()
