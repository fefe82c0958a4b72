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
``state_specs`` and ``to_named``.

Started as ranks (``WORLD_SIZE`` set, as ``torchrun`` sets it, or by
``parallel.dist.spawn``), the driver joins the ranks' process group
(``--init-method``, ``env://`` by default) and the mesh's model axis is
split over the ranks, as ``launch.serve`` does: each rank draws the
parameters and keeps its model shards' experts and their optimizer
state, computes the whole batch's loss (the expert exchanges run
between the ranks, forward and backward), clips by the norm over every
rank's gradient and updates its own state; checkpoints hold the whole
state, written by rank 0, and restore on any world size.  Rank 0 prints
the log lines::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch deepseek-moe-16b --production-mesh --steps 8 --batch 4 \\
        --seq 512

:func:`main` returns the run's record: per step the loss, grad norm,
learning rate, wall time (ms, synchronised), kernel launches and the
collectives' calls and bytes, the number of parameter leaves the first
step's gradient missed, the rank and the world, and with
``--grad-digest`` the first step's gradient digests
(``train.step.grad_digest``).
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import kernels, resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..core.rounds.mesh import collective_counts, reset_collective_counts
from ..data import DataConfig, SyntheticLM
from ..optim import AdamWConfig
from ..parallel.dist import finish as dist_finish
from ..parallel.dist import in_ranks
from ..parallel.dist import init as dist_init
from ..parallel.sharding import device_put, expert_block, to_named
from ..runtime import StragglerWatchdog
from ..train import TrainConfig, build_train_step, init_train_state
from ..train.step import grad_digest, ranked_leaves, state_specs
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
              log_every=1, mgr=None, ckpt_every=0, verbose=True,
              first_grads=None):
    """The driver's loop: steps ``start`` .. ``steps - 1`` of ``step_fn``
    on ``data.batch_at(step)`` plus ``extra``, with the launch and
    collective counts reset before each step, the straggler watchdog,
    and a checkpoint to ``mgr`` every ``ckpt_every`` steps; the log
    lines only when ``verbose``; ``first_grads(grads)`` sees the first
    step's gradients.  Returns the record (without ``seconds``): per
    step the loss, grad norm, learning rate, wall time (ms,
    synchronised), kernel launches and collectives, the parameter
    leaves the first step's gradient missed, and the final ``state``."""
    dog = StragglerWatchdog()
    rec = {"steps": [], "losses": [], "grad_norms": [], "lrs": [],
           "step_ms": [], "launches": [], "collectives": [],
           "grads_missing": None}
    for step in range(start, steps):
        batch = dict(data.batch_at(step), **extra)
        kernels.reset_launch_counts()
        reset_collective_counts()
        _sync(dev)
        t0 = time.perf_counter()
        hook = first_grads if step == start else None
        state, metrics = step_fn(state, batch, **(
            {"grads_hook": hook} if hook else {}))
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
        rec["collectives"].append(collective_counts())
        if rec["grads_missing"] is None:
            rec["grads_missing"] = metrics["grads_missing"]
        if verbose and (step % log_every == 0 or step == steps - 1):
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
    ap.add_argument("--init-method", default="env://",
                    help="the ranks' rendezvous (with WORLD_SIZE set)")
    ap.add_argument("--grad-digest", action="store_true",
                    help="record the first step's gradient digests")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    group, joined = None, False
    if in_ranks():
        joined = not torch.distributed.is_initialized()
        group, dev = dist_init(init_method=args.init_method, device=dev)
    mesh = (make_production_mesh(device=dev, group=group)
            if args.production_mesh
            else make_local_mesh(device=dev, group=group))
    lead = mesh.rank == 0
    tcfg = TrainConfig(
        micro_batches=args.micro,
        remat=not args.smoke,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                        total_steps=args.steps))
    step_fn, ctx, n_micro = build_train_step(cfg, mesh, tcfg,
                                             global_batch=args.batch)
    # an expert-parallel rank draws every parameter, keeps its experts
    block = expert_block(cfg, ctx)
    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(0), dev,
                             **({"experts": block} if block else {}))
    named = to_named(mesh, state_specs(mesh, state, tcfg))
    state = device_put(state, named)

    start = 0
    mgr = CheckpointManager(args.ckpt, shardings=named) if args.ckpt \
        else None
    if mgr and args.resume:
        try:
            state, start = mgr.restore(state)
            if lead:
                print(f"[train] resumed from step {start}")
            start += 1
        except FileNotFoundError:
            pass

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=args.batch,
                                  seq_len=args.seq))
    extra = frontend_stand_ins(cfg, args.seq, args.batch, dev) \
        if cfg.family == "encdec" else {}
    digest, first_grads = {}, None
    if args.grad_digest:
        ranked = ranked_leaves(mesh, state["params"], tcfg)

        def first_grads(grads):
            digest.update(grad_digest(grads, ranked))
    t_start = time.time()
    rec = run_steps(step_fn, state, data, extra, args.steps, dev,
                    start=start, log_every=args.log_every, mgr=mgr,
                    ckpt_every=args.ckpt_every, verbose=lead,
                    first_grads=first_grads)
    if mgr:
        mgr.save(rec["state"], args.steps - 1)
        mgr.wait()
    tot = time.time() - t_start
    if lead:
        print(f"[train] done: {args.steps - start} steps in {tot:.1f}s "
              f"({(args.steps - start) / max(tot, 1e-9):.2f} steps/s)"
              + (f" on {mesh.world} ranks" if mesh.ranked else ""))
    if joined:
        dist_finish()
    rec.update(arch=cfg.name, start=start, seconds=tot,
               tokens_per_step=args.batch * args.seq, mesh=mesh.shape,
               ep=ctx.ep, n_micro=n_micro, rank=mesh.rank, world=mesh.world)
    if args.grad_digest:
        rec["grad_digest"] = digest
    return rec


if __name__ == "__main__":
    main()
