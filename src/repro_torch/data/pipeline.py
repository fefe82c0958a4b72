"""Deterministic, resumable token pipeline; port of
``repro.data.pipeline`` (numpy only, the same code: the same tokens for
the same seed and step).

Synthetic LM data with learnable structure (orderable n-gram-ish stream,
so a real model shows a falling loss) — deterministic in (seed, step), so
a restart at step k reproduces batch k exactly (checkpoint-resume safety,
and every DP shard slices its own rows without coordination).

A file-backed mode memory-maps a token file and strides over it by
(step, shard) — same resume semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int = 512
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    path: str | None = None          # file-backed mode (np.int32 tokens)


class SyntheticLM:
    """Markov-ish synthetic stream: token_{t+1} depends on token_t plus
    periodic motifs — enough structure for loss to fall well below
    log(V) within a few hundred steps on a small model."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # sparse transition table: each token has 8 likely successors
        self.succ = rng.integers(0, v, (v, 8)).astype(np.int32)
        self.tokens_file = None
        if cfg.path:
            self.tokens_file = np.memmap(cfg.path, dtype=np.int32,
                                         mode="r")

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        cfg = self.cfg
        if self.tokens_file is not None:
            n = len(self.tokens_file)
            span = cfg.batch * (cfg.seq_len + 1)
            off = (step * n_shards + shard) * span % max(1, n - span)
            flat = np.array(self.tokens_file[off:off + span])
            toks = flat.reshape(cfg.batch, cfg.seq_len + 1)
        else:
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step * 131 + shard) & 0x7FFFFFFF)
            toks = np.empty((cfg.batch, cfg.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, cfg.vocab, cfg.batch)
            choices = rng.integers(0, 8, (cfg.batch, cfg.seq_len))
            noise = rng.random((cfg.batch, cfg.seq_len)) < 0.05
            rand = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq_len))
            for t in range(cfg.seq_len):
                nxt = self.succ[toks[:, t], choices[:, t]]
                toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_batches(cfg: DataConfig, start_step: int = 0, shard: int = 0,
                 n_shards: int = 1):
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield step, ds.batch_at(step, shard, n_shards)
        step += 1
