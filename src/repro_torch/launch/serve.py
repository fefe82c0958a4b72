"""Batched-request serving driver: prefill + greedy decode with the
serve step builders; port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu --requests 16 --gen 32

Runs on ``cuda`` unless ``--device cpu`` is given, over
``make_local_mesh()``, or with ``--production-mesh`` over
``make_production_mesh()``: (data 16, model 16), so a moe config runs
expert parallelism over 16 model shards, each routing its own tokens
against its own capacity, as the reference computes on 256 chips.  In
one process every shard lives on the one device.  Started as ranks
(``WORLD_SIZE`` set, as ``torchrun`` sets it), the driver joins the
ranks' process group (``--init-method``, ``env://`` by default;
:mod:`repro_torch.parallel.dist` picks the backend from the layout) and
the production mesh's model axis is split over the ranks: each rank
holds its model shards' experts and the rest of the model, the expert
exchanges run between the ranks, and rank 0 prints::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --production-mesh

Parameters are
random, drawn from a ``torch.Generator`` seeded 0 on the device; the
prompts are the JAX driver's (numpy seed 0), and so are the stand-ins of
the modality frontends: zero bf16 ``patch_embeds`` [b, n_patches, d] for
the vlm family and zero bf16 ``enc_embeds`` [b, max(1, prompt //
enc_ratio), d] for the encdec family.

The cache grows as the JAX driver grows it, with two differences (ROADMAP.md,
"Semantics the port fixed"): a vlm cache grows to n_patches + prompt +
gen slots, since its prefill already holds n_patches + prompt positions
(JAX grows it to prompt + gen and fails when gen < n_patches), and the
encoder's ``cross_k`` and ``cross_v`` are kept at the prefill's Se rows
(JAX pads them to (prompt + gen) // enc_ratio with zero keys that every
decode step attends to).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..models import lm
from ..parallel.dist import finish as dist_finish
from ..parallel.dist import in_ranks
from ..parallel.dist import init as dist_init
from ..parallel.sharding import expert_block
from ..train.step import build_serve_step
from .mesh import make_local_mesh, make_production_mesh


# leaves a decode step reads whole: never padded
KEEP = ("pos", "cross_k", "cross_v")


def grow_cache(cfg, cache, max_len):
    """The prefill cache (prompt-sized) copied into a decode cache of
    ``max_len`` slots (bf16, as ``init_decode_cache`` makes it); leaves
    whose shape does not grow, and the ``KEEP`` leaves, are kept as they
    are."""
    b = cache["pos"].shape[0]
    full = lm.init_decode_cache(cfg, b, max_len, device=cache["pos"].device)
    for k in cache:
        if k in full and k not in KEEP and cache[k].shape != full[k].shape \
                and cache[k].dim() == full[k].dim():
            full[k][tuple(slice(0, s) for s in cache[k].shape)] = cache[k]
        else:
            full[k] = cache[k]
    return full


def frontend_stubs(cfg, batch: int, prompt_len: int, device) -> dict:
    """The JAX driver's stand-ins for the modality frontends: zero bf16
    ``patch_embeds`` [batch, n_patches, d] (vlm) or ``enc_embeds``
    [batch, max(1, prompt_len // enc_ratio), d] (encdec); none for the
    other families."""
    if cfg.family == "vlm":
        shape = (batch, cfg.n_patches, cfg.d_model)
        key = "patch_embeds"
    elif cfg.family == "encdec":
        shape = (batch, max(1, prompt_len // cfg.enc_ratio), cfg.d_model)
        key = "enc_embeds"
    else:
        return {}
    return {key: torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def prefix_len(cfg) -> int:
    """Positions a prefill puts before the prompt's tokens (the vlm
    family's image patches)."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def main(argv=None) -> dict:
    """Serve ``--requests`` prompts in batches; returns what it prints
    (requests, tokens, seconds) plus the generated token ids
    ([requests, gen]), whether every logit was finite, the mesh's shape
    and the expert-parallel degree."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-method", default="env://",
                    help="the ranks' rendezvous (with WORLD_SIZE set)")
    ap.add_argument("--logits-out", default=None,
                    help="write the first batch's prefill and decode "
                         "logits (fp32) and its decode inputs to this .npz")
    ap.add_argument("--teacher", default=None,
                    help="feed the first batch the decode inputs of an "
                         "earlier run's --logits-out file")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    group, rank, joined = None, 0, False
    if in_ranks():
        joined = not torch.distributed.is_initialized()
        group, dev = dist_init(init_method=args.init_method, device=dev)
        rank = torch.distributed.get_rank(group)
    mesh = (make_production_mesh(device=dev, group=group)
            if args.production_mesh
            else make_local_mesh(device=dev, group=group))
    serve_step, serve_prefill, ctx = build_serve_step(cfg, mesh)
    # an expert-parallel rank draws every parameter, keeps its experts
    block = expert_block(cfg, ctx)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, **({"experts": block} if block else {}))
    teacher = (None if args.teacher is None
               else np.load(args.teacher)["inputs"])
    kept = []

    rng = np.random.default_rng(0)
    pending = [rng.integers(0, cfg.vocab, args.prompt_len).tolist()
               for _ in range(args.requests)]
    generated = []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    done = 0
    t0 = time.time()
    total_tokens = 0
    while pending:
        batch_reqs = pending[:args.batch]
        pending = pending[args.batch:]
        b = len(batch_reqs)
        toks = torch.tensor(batch_reqs, dtype=torch.int32, device=dev)
        logits, cache = serve_prefill(params, {
            "tokens": toks, **frontend_stubs(cfg, b, args.prompt_len, dev)})
        # grow the cache to prompt+gen (prefill returns prompt-sized),
        # after the patches of a vlm prompt
        cache = grow_cache(cfg, cache, prefix_len(cfg) + args.prompt_len
                           + args.gen)
        first = not generated
        finite &= torch.isfinite(logits).all()
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        out, fed = [], []
        for i in range(args.gen):
            if first and args.logits_out:
                kept.append(logits.float().cpu())
            if first and teacher is not None:
                nxt = torch.from_numpy(teacher[:, i:i + 1]).to(nxt)
            fed.append(nxt)
            logits, cache = serve_step(params, cache, nxt)
            finite &= torch.isfinite(logits).all()
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(nxt)
            total_tokens += b
        if first and args.logits_out:
            kept.append(logits.float().cpu())
            if rank == 0:
                np.savez(args.logits_out, logits=torch.stack(kept).numpy(),
                         inputs=torch.cat(fed, 1).cpu().numpy())
        generated.append(torch.cat(out, dim=1))
        done += b
        if rank == 0:
            print(f"[serve] {done}/{args.requests} requests, "
                  f"{total_tokens / (time.time() - t0):.0f} tok/s "
                  f"aggregate", flush=True)
    gen_ids = torch.cat(generated).cpu().numpy() if generated else \
        np.zeros((0, args.gen), np.int32)
    seconds = time.time() - t0
    if joined:
        dist_finish()
    if rank == 0:
        print(f"[serve] done: {done} requests, {total_tokens} tokens in "
              f"{seconds:.1f}s" + (f" on {mesh.world} ranks"
                                   if mesh.ranked else ""))
    return {"requests": done, "tokens": total_tokens, "seconds": seconds,
            "generated": gen_ids, "finite": bool(finite),
            "mesh": mesh.shape, "ep": ctx.ep, "ranks": mesh.world}


if __name__ == "__main__":
    main()
