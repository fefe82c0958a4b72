"""Batched-request serving driver: prefill + greedy decode with the
serve step builders; port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu --requests 16 --gen 32

Runs on ``cuda`` unless ``--device cpu`` is given.  Parameters are
random, drawn from a ``torch.Generator`` seeded 0 on the device; the
prompts are the JAX driver's (numpy seed 0).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..models import lm
from ..train.step import build_serve_step


def grow_cache(cfg, cache, max_len):
    """The prefill cache (prompt-sized) copied into a decode cache of
    ``max_len`` slots (bf16, as ``init_decode_cache`` makes it); leaves
    whose shape does not grow are kept as they are."""
    b = cache["pos"].shape[0]
    full = lm.init_decode_cache(cfg, b, max_len, device=cache["pos"].device)
    for k in cache:
        if k in full and k != "pos" and cache[k].shape != full[k].shape \
                and cache[k].dim() == full[k].dim():
            full[k][tuple(slice(0, s) for s in cache[k].shape)] = cache[k]
        else:
            full[k] = cache[k]
    return full


def main(argv=None) -> dict:
    """Serve ``--requests`` prompts in batches; returns what it prints
    (requests, tokens, seconds) plus the generated token ids
    ([requests, gen]) and whether every logit was finite."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError("the production mesh waits for the "
                                  "sharded stack (ROADMAP.md queue 1 "
                                  "item 9)")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    serve_step, serve_prefill, _ = build_serve_step(cfg, dev)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)

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
        logits, cache = serve_prefill(params, {"tokens": toks})
        # grow the cache to prompt+gen (prefill returns prompt-sized)
        cache = grow_cache(cfg, cache, args.prompt_len + args.gen)
        finite &= torch.isfinite(logits).all()
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        out = []
        for _ in range(args.gen):
            logits, cache = serve_step(params, cache, nxt)
            finite &= torch.isfinite(logits).all()
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(nxt)
            total_tokens += b
        generated.append(torch.cat(out, dim=1))
        done += b
        print(f"[serve] {done}/{args.requests} requests, "
              f"{total_tokens / (time.time() - t0):.0f} tok/s aggregate",
              flush=True)
    gen_ids = torch.cat(generated).cpu().numpy() if generated else \
        np.zeros((0, args.gen), np.int32)
    seconds = time.time() - t0
    print(f"[serve] done: {done} requests, {total_tokens} tokens in "
          f"{seconds:.1f}s")
    return {"requests": done, "tokens": total_tokens, "seconds": seconds,
            "generated": gen_ids, "finite": bool(finite)}


if __name__ == "__main__":
    main()
