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
holds its model shards' experts, the expert exchanges run between the
ranks, and tensor parallelism splits the rest (each rank holds its
block of every leaf the reference's specs shard over ``model``,
computes its heads, FFN columns, Mamba2 heads or RG-LRU width block,
and its cache holds the KV heads its q heads read and its share of the
recurrent state; ``models.lm``); rank 0
prints::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --production-mesh

With ``--data-ranks N`` the data axis is split over N of the ranks too
(``{"data": N, "model": W / N}``, data-major): a data rank prefills and
decodes its rows of each batch (``parallel.sharding.data_rows``: its
block where the data axis divides the batch, else every row), with its
own cache rows; it holds the parameters whole, as the reference's serve
driver places nothing (its experts are still cut along the model axis),
and the generated ids and ``--logits-out``'s rows are all-gathered over
the data ranks, so every rank returns the whole batch's::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen3-1.7b --production-mesh --data-ranks 4 --batch 16

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
from .. import tree as pt
from ..configs import get_config, get_smoke_config
from ..models import lm
from ..parallel.dist import finish as dist_finish
from ..parallel.dist import in_ranks
from ..parallel.dist import init as dist_init
from ..parallel.sharding import data_rows, expert_block
from ..train.step import build_serve_step, rank_cut
from .mesh import make_local_mesh, make_production_mesh, rank_layout


# the leaves a decode step writes at new positions: the attention K/V
GROW = ("k", "v")


def grow_cache(cfg, cache, max_len):
    """The prefill cache (prompt-sized) with its attention ``k`` and
    ``v`` copied into ``max_len`` slots (the ring's window at most; bf16,
    as ``init_decode_cache`` makes them); every other leaf is kept as it
    is (the position, a recurrent state or conv tail, which do not grow,
    a model rank's of them included, and the encoder's cross K/V, which
    a decode step reads whole)."""
    b = cache["pos"].shape[0]
    out = dict(cache)
    if "k" not in cache:
        return out
    full = lm.init_decode_cache(cfg, b, max_len, device=cache["pos"].device,
                                kv_heads=cache["k"].shape[-2])
    for k in GROW:
        if cache[k].shape != full[k].shape:
            full[k][tuple(slice(0, s) for s in cache[k].shape)] = cache[k]
            out[k] = full[k]
    return out


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
    ([requests, gen]), whether every logit was finite, the mesh's shape,
    the expert-parallel degree, the bytes of the parameters this rank
    holds and the KV heads its attention cache holds (None without
    one)."""
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
    ap.add_argument("--data-ranks", type=int, default=1,
                    help="ranks along the data axis, each serving its "
                         "rows; the rest of the world splits the model "
                         "axis")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    group, rank, joined = None, 0, False
    if in_ranks():
        joined = not torch.distributed.is_initialized()
        group, dev = dist_init(init_method=args.init_method, device=dev)
        rank = torch.distributed.get_rank(group)
    if group is None and args.data_ranks != 1:
        raise ValueError("--data-ranks needs the driver started as ranks")
    ranks = None if group is None else rank_layout(
        torch.distributed.get_world_size(group), args.data_ranks)
    mesh = (make_production_mesh(device=dev, group=group, ranks=ranks)
            if args.production_mesh
            else make_local_mesh(device=dev, group=group, ranks=ranks))
    serve_step, serve_prefill, ctx = build_serve_step(cfg, mesh)
    dp = ctx.dp_axis

    def whole_rows(x, split):
        """This rank's rows gathered into the batch's (over the data
        ranks) where they were its block."""
        return mesh.all_gather(x.contiguous(), 0, axis=dp) if split else x
    # an expert-parallel rank draws every parameter, keeps its experts;
    # a tensor-parallel one its model blocks, cut as each leaf is drawn
    block = expert_block(cfg, ctx)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, **({"experts": block} if block else {}),
                            **({"cut": rank_cut(cfg, mesh, (ctx.tp_axis,))}
                               if ctx.tp is not None else {}))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in pt.leaves(params))
    teacher = (None if args.teacher is None
               else np.load(args.teacher)["inputs"])
    kept = []

    rng = np.random.default_rng(0)
    pending = [rng.integers(0, cfg.vocab, args.prompt_len).tolist()
               for _ in range(args.requests)]
    generated, kv_heads = [], None
    finite = torch.ones((), dtype=torch.bool, device=dev)
    done = 0
    t0 = time.time()
    total_tokens = 0
    while pending:
        batch_reqs = pending[:args.batch]
        pending = pending[args.batch:]
        b = len(batch_reqs)
        rows = data_rows(mesh, b)
        split = len(rows) < b
        toks = torch.tensor(batch_reqs, dtype=torch.int32,
                            device=dev)[torch.from_numpy(rows).to(dev)]
        logits, cache = serve_prefill(params, {
            "tokens": toks,
            **frontend_stubs(cfg, len(rows), args.prompt_len, dev)},
            data_block=split)
        # grow the cache to prompt+gen (prefill returns prompt-sized),
        # after the patches of a vlm prompt
        cache = grow_cache(cfg, cache, prefix_len(cfg) + args.prompt_len
                           + args.gen)
        kv_heads = cache["k"].shape[-2] if "k" in cache else None
        first = not generated
        finite &= torch.isfinite(logits).all()
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        out, fed = [], []
        for i in range(args.gen):
            if first and args.logits_out:
                kept.append(whole_rows(logits.float(), split).cpu())
            if first and teacher is not None:
                nxt = torch.from_numpy(teacher[rows, i:i + 1]).to(nxt)
            fed.append(nxt)
            logits, cache = serve_step(params, cache, nxt, data_block=split)
            finite &= torch.isfinite(logits).all()
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(nxt)
            total_tokens += b
        if first and args.logits_out:
            kept.append(whole_rows(logits.float(), split).cpu())
            inputs = whole_rows(torch.cat(fed, 1), split)
            if rank == 0:
                np.savez(args.logits_out, logits=torch.stack(kept).numpy(),
                         inputs=inputs.cpu().numpy())
        generated.append(whole_rows(torch.cat(out, dim=1), split))
        done += b
        if rank == 0:
            print(f"[serve] {done}/{args.requests} requests, "
                  f"{total_tokens / (time.time() - t0):.0f} tok/s "
                  f"aggregate", flush=True)
    gen_ids = torch.cat(generated).cpu().numpy() if generated else \
        np.zeros((0, args.gen), np.int32)
    seconds = time.time() - t0
    # every data rank's rows finite (no collective without data ranks)
    finite = mesh.all_reduce((~finite).int().reshape(1), dp)[0] == 0
    if joined:
        dist_finish()
    if rank == 0:
        print(f"[serve] done: {done} requests, {total_tokens} tokens in "
              f"{seconds:.1f}s" + (f" on {mesh.world} ranks"
                                   if mesh.ranked else ""))
    return {"requests": done, "tokens": total_tokens, "seconds": seconds,
            "generated": gen_ids, "finite": bool(finite),
            "mesh": mesh.shape, "ep": ctx.ep, "ranks": mesh.world,
            "layout": dict(mesh.ranks), "param_bytes": param_bytes,
            "kv_heads": kv_heads}


if __name__ == "__main__":
    main()
