"""Perf hillclimb driver: re-count selected cells under tagged variants
(sharding policy + train config overrides) through the port's dry-run
and print each variant's roofline terms; port of
``repro.launch.hillclimb`` (its ``VARIANTS`` registry, the port's
``ShardingPolicy``, ``TrainConfig`` and ``AdamWConfig``).  Like the
dry-run it allocates nothing and needs no card.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen_v1_notp
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell all
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..optim import AdamWConfig
from ..parallel.sharding import ShardingPolicy
from ..train.step import TrainConfig
from .dryrun import RESULTS, run_cell

# variant registry: name -> (arch, shape, policy, tcfg)
VARIANTS = {
    # ---- llama3-405b train_4k ------------------------------------------
    # v1: sequence-sharded residuals (TP all-reduce -> RS/AG halves traffic,
    #     and norm/loss compute shards over 'model')
    "llama_v1_seqshard": (
        "llama3-405b", "train_4k",
        ShardingPolicy(seq_shard_resid=True),
        TrainConfig(opt=AdamWConfig(m_dtype="bfloat16", v_mode="int8"),
                    accum_dtype="bfloat16")),
    # v2: baseline sharding + single loss chunk (kills the 8x-per-micro
    #     head-grad partial all-reduce) + int8 first moment
    "llama_v2_chunk": (
        "llama3-405b", "train_4k",
        ShardingPolicy(),
        TrainConfig(opt=AdamWConfig(m_dtype="int8", v_mode="int8"),
                    accum_dtype="bfloat16", loss_chunk=4096)),
    # v3: + micro 16->4: FSDP param re-gather traffic /4 (activation
    #     carries grow 4x — measures the memory/traffic trade explicitly)
    "llama_v3_micro4": (
        "llama3-405b", "train_4k",
        ShardingPolicy(),
        TrainConfig(micro_batches=4,
                    opt=AdamWConfig(m_dtype="int8", v_mode="int8"),
                    accum_dtype="bfloat16", loss_chunk=4096)),

    # ---- qwen3-1.7b train_4k -------------------------------------------
    # v1: TP off — 'model' axis becomes pure DP (1 seq/chip), weights FSDP
    #     over 'data' only; kills the TP activation all-reduce entirely
    "qwen_v1_notp": (
        "qwen3-1.7b", "train_4k",
        ShardingPolicy(tp_enable=False),
        TrainConfig()),
    # v2: + replicate embed/head (0.6 GB — kills the vocab-partial logits
    #     all-reduce) and disable remat (no recompute pass: fewer FSDP
    #     gathers and ~25% less compute)
    "qwen_v2_replembed": (
        "qwen3-1.7b", "train_4k",
        ShardingPolicy(tp_enable=False, replicate_embed=True),
        TrainConfig(micro_batches=1, remat=False)),
    # v3: + int8 gradient compression on the 256-way data all-reduce
    "qwen_v3_gradcomp": (
        "qwen3-1.7b", "train_4k",
        ShardingPolicy(tp_enable=False, replicate_embed=True),
        TrainConfig(micro_batches=1, remat=False, compress_grads=True)),
    # v2b: replicate embed/head but keep remat
    "qwen_v2b_replembed_remat": (
        "qwen3-1.7b", "train_4k",
        ShardingPolicy(tp_enable=False, replicate_embed=True),
        TrainConfig(micro_batches=1, remat=True)),
    # v3: body pure-DP but vocab stays model-sharded: head grads become
    #     local vocab slices
    "qwen_v3_vocab_model": (
        "qwen3-1.7b", "train_4k",
        ShardingPolicy(tp_enable=False),
        TrainConfig(micro_batches=1, remat=True)),
    # v4: TP off + one loss chunk
    "qwen_v4_chunk4096": (
        "qwen3-1.7b", "train_4k",
        ShardingPolicy(tp_enable=False),
        TrainConfig(micro_batches=1, remat=True, loss_chunk=4096)),
    "qwen_v4b_chunk2048": (
        "qwen3-1.7b", "train_4k",
        ShardingPolicy(tp_enable=False),
        TrainConfig(micro_batches=1, remat=True, loss_chunk=2048)),

    # ---- llava decode_32k (the serving cell) ---------------------------
    # v1: no FSDP on params (decode re-gathers params every token
    #     otherwise)
    "llava_v1_nofsdp": (
        "llava-next-mistral-7b", "decode_32k",
        ShardingPolicy(fsdp_params=False),
        None),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    help="|".join(VARIANTS) + " or 'all'")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    names = list(VARIANTS) if args.cell == "all" else args.cell.split(",")
    for name in names:
        arch, shape, policy, tcfg = VARIANTS[name]
        rec = run_cell(arch, shape, False, Path(RESULTS), force=args.force,
                       tag=name, policy=policy, tcfg=tcfg)
        if rec.get("status") == "ok":
            rl = rec["roofline"]
            ma = rec["memory_analysis"]
            print(f"{name}: tc={rl['t_compute_s']:.3g} "
                  f"tm={rl['t_memory_s']:.3g} tx={rl['t_collective_s']:.3g} "
                  f"dom={rl['dominant']} "
                  f"roofline={rl['roofline_fraction']*100:.1f}% "
                  f"mem={ma['per_device_total']/1e9:.1f}GB")
        else:
            print(f"{name}: {rec.get('status')} {rec.get('error', '')[:200]}")


if __name__ == "__main__":
    main()
