"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``src/repro_torch/csrc`` and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, and time it (CUDA events; the
   kernel and the library call as CUDA-graph replays of one call a
   graph, ``ms``, and the kernel also of 20 calls a graph,
   ``ms_graph20``; the plain version eagerly), beside its bound: the
   larger of bytes over 3.35 TB/s and operations over the card's peak
   for their type; print the launch floor of both timers (one 1-element
   ``add_``), the registers and spills of every K3, K4 and K5
   instantiation (no spill allowed for bf16 K4 at hd 128 or fp32 K5 at
   P 64), K4's, K3's and K5's achieved rates, their share of the bound
   and K3's and K4's time against SDPA's, and fp32 K4's time at K4's
   shape; K2 also at the serve's own mix of granted and empty rows and
   with rotating rows, and K2-K4's library calls on both timers; K4 also
   at recurrentgemma-2b's windowed shapes (hd 256, 10 q heads over one
   kv head, window 2048: its 512-token prefill and S 4096, where the
   window bites; :func:`flash_window_cases`), and at the vlm and encdec
   families' shapes (:func:`flash_cross_cases`: llava-next-mistral-7b's
   1664-position prefill; seamless-m4t-medium's cross-attention, 512
   rows over 128 encoder keys, and its decode step, 1 row; 512 rows at
   query offset 1152 over 1664 keys), each beside SDPA; then the
   backward kernels of the training path: K4's (:func:`check_flash_bwd`:
   Qwen3-1.7B's training shape, seamless's cross-attention, a window at
   hd 128, llava's offset and recurrentgemma-2b's windowed hd-256 heads
   at S 512 and 4096, from the forward's own log-sum-exp, bit-equal over
   two calls, beside autograd of SDPA; K4's forward with and without
   that output) and
   K5's at Mamba2-2.7B's training shape (:func:`check_ssd_bwd`), each
   against its plain backward, with no register spill in either;
3. serve ~48 seeded requests through ``SELCCKVPool`` + ``ServeLoop`` at
   the attention width of Qwen3-1.7B (16 query heads, 8 kv heads, head
   dim 128; ``src/repro/configs/qwen3_1p7b.py``) over the default pool
   (1024 pages x 16 tokens, 4 replicas, bf16: one layer's KV for 16,384
   tokens), checking every completion's KV readback bit for bit
   against ``ToyLM.expected_pages``, a sample of attend outputs against
   the plain kernel over the oracle bytes, the coherence invariants,
   the page accounting, and that every kernel launched during the run,
   each K2 call once; print K2's calls counted by (R, valid rows); then
   the same serve with a ``FlightRecorder(4096)`` on its loop and
   without, alternated twice (:func:`serve_with_recorder`: spans by verb
   equal to the dispatches the serve counts itself, no compile event,
   the Chrome trace loads back; walls and ``snapshot()`` printed);
3b. the legacy page-copy pool at ``KVPoolConfig()`` (:func:`legacy_phase`):
   32 sequences of 32 pages (sequence ``s`` owned by replica ``s % 4``),
   seeded bf16 K/V, a prefill of 480 tokens a sequence as one append a
   replica (3840 rows, K1's largest batch here), then 32 decode steps of
   one append a replica, a read by every replica of its own pages and
   four of sequence 0's (:func:`legacy_shared`: real reader bits that
   replica 0's appends evict, direct-mapped slot conflicts) and one
   attend with Qwen3-1.7B's 16 query heads; pages, versions, fills,
   evictions, every word and every hit mask against a numpy oracle
   (:class:`LegacyOracle`), each attend within 1e-4 of the plain kernel
   over the oracle's pages, and a CPU twin bit-equal in every leaf and
   hit mask; K1, K2 (exactly twice a read) and K3 launched; then K1, K2
   and K3 at this path's shapes (:func:`legacy_kernel_cases`, the
   ``*_legacy`` keys); then the placement verbs at the serve pool's
   geometry (:func:`placement_phase`: 1024 lines of 16384 lanes, 4
   nodes, a home directory and replicas, 2 x 16 zipf-0.99 batches of 256
   ops around ``replicate(plan_replication(...))`` and the flat
   ``rehome``, against a twin plane) and the DES bridge
   (:func:`bridge_phase`: the quickstart cluster's DES workload through
   the port's ``SELCCLayer``, ``as_plane`` on the card against a CPU
   twin, ``make_kv_pool()``'s legacy pool; then the DES workers,
   :func:`bridge_des_workers`: a micro run, YCSB over ``BLinkTree``,
   TPC-C over ``TxnEngine``, ``parity_worker`` over every backend with
   equal final images, and ``as_plane`` of the micro run's layer on the
   card against a CPU twin); then the sharded plane,
   four home shards on the card (:func:`sharded_phase`: the serve again
   over a mesh-backed pool, every dispatch's versions and the final
   unsharded state hashed equal to the flat serve's, its ``[4, 4]``
   occupancy printed; placement's traffic on a sharded plane beside a
   flat twin, with a real ``rehome``, replica serves and, under
   ``bucket_cap`` 16, deferrals; phase 5's tree and phase 6's
   transactions at 4 shards, against the oracle and a flat twin; K1-K3
   counted on the sharded calls alone), and ``distributed_latch_round``
   at the tree's 2^21 words against K1's plain version;
4. serve Qwen3-1.7B, Mamba2-2.7B, deepseek-moe-16b, starcoder2-7b,
   recurrentgemma-2b, llava-next-mistral-7b and seamless-m4t-medium at
   full published width and depth (``src/repro/configs/*.py``; random
   bf16 weights from a seeded ``torch.Generator`` on the card) through
   the port's ``launch.serve.main``: 16 requests (Qwen3) or 8, batch 4,
   prompt 512, 32 generated tokens each (llava's prompts after 1152 zero
   patch embeddings, seamless's over 128 zero frames, the JAX driver's
   stand-ins); check finite logits, every token, and that K4 ran exactly
   once per attention layer per prefill (28, 28, 32, the 8
   local-attention layers of recurrentgemma-2b, 32 for llava, and 36
   for seamless: 12 encoder, 12 decoder self- and 12 cross-attention
   layers) plus 12 times a decode step for seamless (cross-attention),
   and K5 once per layer (Mamba2); then, at full width and reduced
   depth, hold a prefill
   against its token-by-token replay through ``decode_step`` (the plain
   decode path; 4 layers and 512 tokens for Qwen3, Mamba2, deepseek and
   starcoder2, 2 layers and 128 tokens for dbrx-132b,
   command-r-plus-104b and llama3-405b, which one card does not hold
   whole, moe configs at the no-drop capacity factor), recurrentgemma-2b
   at 3 layers (r, r, a) and 2304 tokens, past its 2048 window and not a
   multiple of it, plus 8 ring decode steps after the prefill against
   the longer prefills; llava at 4 layers: 1152 random patch embeddings
   and 512 tokens, then 8 decode steps on the grown cache against
   prefills of the same patches and the tokens so far
   (:func:`vlm_continuation`); seamless at full depth over 128 random
   frames: a 512-token decode replay from the prefill's cross K/V, then
   8 steps on the grown cache against longer prefills
   (:func:`encdec_replay`); time the fp32 head product of a decode step;
   and hold one full-width deepseek ``moe_ffn`` on 2048 tokens against
   an independent per-token fp32 loop, drop sets equal
   (:func:`moe_card_check`);
5. the B-link tree at full scale (``benchmarks/fig10_btree_rounds.py``'s
   geometry: fanout 16, 4 nodes, write-through; ``n_lines`` 2^21):
   2^24 keys loaded as a tree image (:func:`btree_image`, leaves of 12
   keys, height 7) carried onto the card and adopted by
   ``DeviceBTree.open``; YCSB C (16 batches of 1024 lookups), YCSB A (4
   batches, half upserts) and one YCSB E ``scan_batch`` (64 starts, up
   to 100 pairs each), zipf 0.99, each result checked against the
   oracle, every upserted key read back and the loaded plane's
   coherence invariants checked; then 4096 uniform keys in batches of
   64 into a fresh tree, ``items()`` and ``check_invariants()`` against
   a dict; print walls, rates, rounds per batch and the K1/K2 launches;
6. device transactions at full scale (``fig11_tpcc_rounds.py``'s
   geometry with 2^20 GCLs of 8 tuples, 72-byte rows, 4 nodes, at most
   4 lines a txn, zipf 0.6): 8 batches of 1024 txns under 2PL and 8
   under TO, each batch's decisions and the final tuple image checked
   against a serial numpy replay of the generated txns in the device's
   completion order;
   print commits/s, aborts by reason, iterations, rounds and the K1/K2
   launches, each path's rates beside the sharded phase's;
6b. the reference's oracle of the device engine (:func:`des_txn_oracle`):
   a fresh engine at phase 6's geometry runs phase 6's first 2 batches
   under 2PL and TO, then its first batch on a 4-shard plane; the
   port's DES ``TxnEngine`` replays each batch's effective txns in the
   device's order with the client ts injected (one memory node), and
   :func:`replay_txn` beside it: decisions equal, and the touched GCLs'
   protocol-fresh read-back equal to the DES records and the replay's
   rows, every other line at its seed; then the Fig. 11 host cell
   (:func:`des_fig11_cell`): the same batches run concurrently on a DES
   cluster of 2 memory nodes and 8 threads under 2PL, TO and OCC,
   commits + aborts = txns, printed beside the card's commits/s (DES
   time units are not seconds);
6c. Fig. 7's rounds workload (:func:`rounds_fig7_phase`:
   ``device_rounds_batches`` with ``benchmarks/fig7_rounds.py``'s
   knobs, 8 nodes, read 0.3, zipf 1.1, 128 rounds at most, seed 7; 16
   batches at 1024 lines and R 64 and at 2^20 lines and R 1024,
   write-through and write-back, and a payload-width-16 run) through
   ``run_rounds`` flat and ``run_rounds_sharded`` on 4 shards, against
   a CPU twin over the touched lines: versions and final state equal,
   flat and sharded equal; rounds per batch and ops/s printed.  Phase 2
   also holds K1 and K2 at these two paths' shapes (K1 at the tree's
   descent round and the txn FINALIZE spin's 4096 slots, K2 at both
   paths' rows) and at a sharded home's (``*_shard``: 2^19 words, R
   1024);
7. train every family at full published width (:data:`TRAIN_RUNS`,
   :func:`train_run`; batch 4, 8 steps, ``--micro 1``, remat, lr 3e-4):
   Qwen3-1.7B, Mamba2-2.7B, recurrentgemma-2b and seamless-m4t-medium at
   full depth through the port's ``launch.train.main`` (seq 512, fp32
   AdamW states), llava-next-mistral-7b at full depth with int8 m and v
   over 1152 patches and 512 tokens, and deepseek-moe-16b at 4 layers,
   both through ``build_train_step``: finite losses and grad norms, a
   gradient for every parameter leaf, exactly ``lm.train_launches``'
   K4 or K5 forward and backward launches a step and nothing else; print
   step times, tokens/s, peak memory beside the state's own bytes, and
   the device's busy share over one more step under ``torch.profiler``,
   with K4's and K5's forward and backward device time in that step; at
   full width and reduced depth (:data:`TRAIN_PLAIN`), one step through
   the kernels against the same step with the plain versions forced on
   the card (:func:`train_plain_check`; recurrentgemma-2b at 2304
   positions, past its window); and a checkpoint saved and resumed on
   the card (:func:`train_resume_check`, Mamba2-2.7B at 1 layer);
7b. the sharded LM stack on the one card (:func:`sharded_lm_phase`):
   deepseek-moe-16b at full width and depth served through
   ``launch.serve.main --production-mesh`` ((data 16, model 16), EP 16:
   each of 16 model shards routes its 128 of a prefill's 2048 tokens
   against its own capacity, 16 slots against 244 flat; batch 4, prompt
   512, 32 generated tokens; K4 once per layer a prefill); one full-width
   ``moe_ffn`` on 2048 tokens under that mesh against the independent
   reference run once per shard, drop sets equal shard by shard
   (:func:`moe_card_check`); ``launch.train.main --production-mesh`` at 4
   layers, 8 steps, 1 micro-batch (:func:`sharded_train`: finite losses,
   every gradient, exact K4 forward and backward launches); and
   ``pipeline_forward`` with 4 stages and 8 micro-batches of a
   ``tanh(h @ w)`` stack at width 2048, 8 layers, within rtol 1e-5 of
   the unpipelined loop (:func:`pipeline_check`);
7c. the dry-run (:func:`dryrun_phase`): a child process started after
   the build counts, on fake tensors and the CPU only, (a) the
   production cells :data:`DRYRUN_CELLS` through ``launch.dryrun.run_cell``
   (each ``status == "ok"``; one line a cell: roofline terms, dominant
   term, bytes a device, fits_80GB) and (b) the steps of
   :data:`CARD_CELLS` on ``make_local_mesh()``: Qwen3-1.7B's train step
   at one 4096-token sequence and its decode step at batch 1 over a
   32768-token cache, at full width and depth, and Mamba2-2.7B's train
   step at 8 layers (K5).  The phase then runs (b) on the card
   (:func:`card_step_check`): ``FlopCounterMode`` over a step equal to
   the dry-run's products outside the kernels, exactly; K4's and K5's
   operations from their wrappers' counters equal to the dry-run's
   kernel terms, exactly; the median of 5 warmed steps no faster than
   the dry-run's roofline bound, K4 and K5 counted as the kernels do
   (the step's share of it, at most 1); the
   peak memory at least the predicted arguments and within
   :data:`DRYRUN_MEM_TOL` of the predicted peak;
7d. the ``shard_map`` bodies over ranks (:func:`ranks_phase`, after
   7c): the parent frees its cached memory and spawns :data:`RANKS` gloo
   ranks sharing the card (:func:`rank_main`; the kernels built above,
   each rank loads them), which run the serve over a mesh-backed pool on
   ``Mesh(4)`` split a shard a rank (hashes equal to phase 3's), phase
   5's tree on it (state hash equal to the one-process 4-shard run's),
   deepseek-moe-16b under ``--production-mesh`` with EP 16 as 4 ranks x
   4 model shards, teacher-forced on 7b's first batch and held to its
   logits, ``moe_card_check`` rank by rank, and the pipeline a stage a
   rank; then a world-1 nccl group runs both collectives; each rank's
   walls, launches and collective bytes are printed;
8. print the ``kernels`` JSON line (``launches`` counts every path:
   the serve, the legacy pool, the placement check, the DES bridge, the
   sharded plane, the LM serves, the tree, the transactions, the DES
   oracle, Fig. 7's rounds, the training runs and the sharded LM
   stack's serve and training (``sharded_lm_serve``,
   ``sharded_lm_train``), the dry-run's card steps
   (``dryrun_card``) and phase 7d's ranks (``ranks``), split
   by path in ``launches_by_path`` and, for
   training, by arch in ``train_launches_by_arch``), the script's wall
   time before it, then the result line.

Needs one CUDA device; exits 1 without one, before printing anything
on standard output.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside tensor cores
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 494.7e12              # H100 SXM TF32 tensor cores, dense
REPLAY_TOL = 2e-2                  # prefill vs decode replay, x max|logit|
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, iters=200, calls=1) -> float:
    """Device time of one ``fn()`` call: ``calls`` back-to-back calls
    captured in one CUDA graph, replayed ``iters`` times between two
    events (no host overhead), divided by ``iters * calls``.  With one
    call a graph, a kernel of a few microseconds also pays the replay's
    own cost; with many, only the gap between kernels in a graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (iters * calls)


def graph20_ms(fn) -> float:
    """``graph_ms`` with 20 calls a graph (the ``ms_graph20`` column)."""
    return graph_ms(fn, iters=50, calls=20)


def launch_floor() -> dict:
    """Both timers on one tiny torch elementwise kernel (``x.add_(1)``
    on a 1-element tensor): the least a launch costs on each."""
    x = torch.zeros(1, device="cuda")
    return {"ms": graph_ms(lambda: x.add_(1)),
            "ms_graph20": graph20_ms(lambda: x.add_(1))}


def eager_ms(fn, iters=20) -> float:
    """Time of one eager ``fn()`` call, host work included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def ptxas_functions(text: str) -> list:
    """(kernel, registers, spill bytes) for each entry function in the
    ``-Xptxas -v`` output of one source, names demangled where
    ``c++filt`` is installed."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif "spill" in line and name:
            w = line.split()
            spill = sum(int(n) for n, a, b in zip(w, w[1:], w[2:])
                        if a == "bytes" and b == "spill")
        elif "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            out.append((name, regs, spill))
            name = None
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(n for n, _, _ in out),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
        out = [(nm, r, sp) for nm, (_, r, sp) in zip(names, out)]
    return out


def device_busy_us(events) -> float:
    """Device time in a ``torch.profiler`` ``key_averages()``: the CUDA
    events' own durations (kernels, copies, fills), as the profiler's
    table totals them.  The aten op that issued a copy carries the
    copy's device time too, so a sum over every entry counts each copy
    twice."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation)


def bound_ms(n_bytes: float, n_flops: float = 0.0, peak=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------- phase 2: kernels

def check_latch(dev, K):
    """K1 at the serving round's shape: R = 32 requests on 1024 words,
    with same-line chains and lo->hi carries; exact."""
    from repro_torch.kernels.latch_ops import latch_apply_plain, REQ_KEYS
    rng = np.random.default_rng(SEED)
    n, r = 1024, 32
    words = rng.integers(-2**31, 2**31, (n, 2)).astype(np.int32)
    words[:8, 1] = -1                              # lo = 0xFFFFFFFF
    line = rng.integers(0, 8, r).astype(np.int32)  # long chains
    line[::7] = -1
    cmp = words[np.maximum(line, 0)]
    req_np = {"line": line, "op": rng.integers(0, 2, r).astype(np.int32),
              "arg_hi": rng.integers(-4, 4, r).astype(np.int32),
              "arg_lo": rng.integers(-2**31, 2**31, r).astype(np.int32),
              "cmp_hi": cmp[:, 0].copy(), "cmp_lo": cmp[:, 1].copy()}
    w = torch.from_numpy(words).to(dev)
    req = {k: torch.from_numpy(v).to(dev) for k, v in req_np.items()}
    got = K.apply_batch(w, req)
    want = latch_apply_plain(w, *[req[k] for k in REQ_KEYS])
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    assert err == 0, f"latch_ops disagrees with its plain version ({err})"
    n_bytes = 2 * n * 8 + 6 * r * 4 + 3 * r * 4
    bms, by = bound_ms(n_bytes)
    return {"name": "latch_ops", "max_abs_err": float(err),
            "ms": graph_ms(lambda: K.apply_batch(w, req)),
            "ms_graph20": graph20_ms(lambda: K.apply_batch(w, req)),
            "plain_ms": eager_ms(lambda: latch_apply_plain(
                w, *[req[k] for k in REQ_KEYS])),
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def fetch_cases(dev):
    """K2's inputs at the serving round's shape, R = 32 rows of W = 16384
    int32 lanes (64 KiB) from a 1024-page image: ``(pages, dense, serve,
    rotating)``, each case the argument list ``[words, req_page, bit_hi,
    bit_lo]`` after ``pages``.  dense: 28 rows valid, duplicates with
    unequal bits (the ``ms`` and ``ms_graph20`` case); serve: the
    serve's own mix, one valid row, zero bits as the round engine passes
    them; rotating: 20 dense cases over disjoint rows of the image."""
    rng = np.random.default_rng(SEED + 1)
    p, e, r = 1024, 16384, 32
    pages = torch.from_numpy(rng.integers(-2**31, 2**31, (p, e))
                             .astype(np.int32)).to(dev)
    words_np = rng.integers(0, 2**20, (p, 2)).astype(np.int32)
    words_np[::3, 0] |= 5 << 24
    req_np = rng.integers(0, p, r).astype(np.int32)
    req_np[5] = req_np[6] = req_np[7]              # duplicate requests
    req_np[::9] = -1
    words = torch.from_numpy(words_np).to(dev)

    def case(req, bits=True):
        b = [rng.integers(0, 2**30, r).astype(np.int32) if bits
             else np.zeros(r, np.int32) for _ in range(2)]
        return [words] + [torch.from_numpy(a).to(dev) for a in (req, *b)]

    dense = case(req_np)
    serve_np = np.full(r, -1, np.int32)
    serve_np[rng.integers(0, r)] = rng.integers(0, p)
    serve = case(serve_np, bits=False)
    perm = rng.permutation(p).astype(np.int32)
    rotating = []
    for k in range(20):
        rot_np = perm[k * r:(k + 1) * r].copy()
        rot_np[::9] = -1
        rotating.append(case(rot_np))
    return pages, dense, serve, rotating


def check_fetch(dev, K):
    """K2 on :func:`fetch_cases`, exact against its plain version in all
    three cases; timed dense (``ms``, ``ms_graph20``), at the serve's mix
    (``*_serve``) and with rotating rows in one 20-call graph, so that no
    call finds its rows where the call before it left them in L2
    (``*_rotating``).  ``index_select`` over the same rows is the
    library yardstick on both timers."""
    from repro_torch.kernels.gcl_fetch import gcl_fetch_plain
    pages, dense, serve, rotating = fetch_cases(dev)
    (p, e), r = pages.shape, dense[1].shape[0]
    err = 0
    for args in [dense, serve] + rotating:
        got = K.fetch(pages, *args)
        want = gcl_fetch_plain(pages, *args)
        torch.cuda.synchronize()
        err = max([err] + [int((a.long() - b.long()).abs().max())
                           for a, b in zip(got, want)])
    assert err == 0, f"gcl_fetch disagrees with its plain version ({err})"

    def bound(args):
        n_valid = int((args[1] >= 0).sum())
        return bound_ms(n_valid * e * 4 + r * e * 4 + 2 * p * 8 + 6 * r * 4)

    def gather(args):
        idx = args[1].long().clamp(min=0)
        return lambda: torch.index_select(pages, 0, idx)

    def cycle(calls):
        """One of ``calls`` per invocation, in turn."""
        it = itertools.cycle(calls)
        return lambda: next(it)()

    bms, by = bound(dense)
    bms_serve, _ = bound(serve)
    row = {"name": "gcl_fetch", "max_abs_err": float(err),
           "ms": graph_ms(lambda: K.fetch(pages, *dense)),
           "ms_graph20": graph20_ms(lambda: K.fetch(pages, *dense)),
           "plain_ms": eager_ms(lambda: gcl_fetch_plain(pages, *dense)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": graph_ms(gather(dense)),
           "library_ms_graph20": graph20_ms(gather(dense)),
           "ms_serve": graph_ms(lambda: K.fetch(pages, *serve)),
           "ms_graph20_serve": graph20_ms(lambda: K.fetch(pages, *serve)),
           "bound_ms_serve": bms_serve,
           "library_ms_graph20_serve": graph20_ms(gather(serve)),
           "ms_graph20_rotating": graph20_ms(cycle(
               [lambda a=a: K.fetch(pages, *a) for a in rotating])),
           "library_ms_graph20_rotating": graph20_ms(cycle(
               [gather(a) for a in rotating]))}
    log(f"rate gcl_fetch on ms_graph20: dense "
        f"{100 * bms / row['ms_graph20']:.2f} % of its bound, "
        f"{row['ms_graph20'] / row['library_ms_graph20']:.3f}x "
        f"index_select's time; serve mix "
        f"{100 * bms_serve / row['ms_graph20_serve']:.2f} % of its bound; "
        f"rotating rows {100 * bms / row['ms_graph20_rotating']:.2f} % of "
        f"the dense bound")
    return row


def latch_app_inputs(n, r, pattern, seed=SEED + 7):
    """K1's inputs at an application's shape, as numpy arrays ``(words
    [n, 2], req)``.  ``descent`` (the B-tree's round): R reader FAAs
    (each slot's node bit), the root requested by all four nodes and
    every other slot by one request a line.  ``finalize`` (the txn
    FINALIZE spin, B x G = R slots, slot i of node (i // 4) % 4): about
    half the slots empty; the rest write CASes of the node's writer
    field (an upgrade compares against the node's own reader bit and
    hits, a fresh write against a free word, or a word another node
    holds), one in eight a reader FAA; the lines distinct but for 8 hot
    ones, each named by all four nodes in four request tiles of 1024
    (``csrc/latch_ops.cu``'s RT), so a word carries from tile to tile."""
    from repro_torch.core import coherence as co
    rng = np.random.default_rng(seed)
    if pattern == "descent":
        words = rng.integers(0, 2**24, (n, 2)).astype(np.int32)
        line = (1 + rng.choice(n - 1, r, replace=False)).astype(np.int32)
        line[:4] = 0                               # the root, four nodes
        zeros = np.zeros(r, np.int32)
        return words, {"line": line, "op": np.ones(r, np.int32),
                       "arg_hi": zeros,
                       "arg_lo": (1 << (np.arange(r) % 4)).astype(np.int32),
                       "cmp_hi": zeros, "cmp_lo": zeros}
    assert pattern == "finalize" and r >= 4096 and r % 4 == 0, pattern
    node = torch.arange(r) // 4 % 4
    bit_hi, bit_lo = (t.numpy() for t in co.bit_lanes(node))
    wf = co.writer_field_hi(node).numpy()
    other = co.writer_field_hi((node + 1) % 4).numpy()
    words = np.zeros((n, 2), np.int32)
    words[:, 1] = rng.integers(0, 16, n)           # reader bits of 4 nodes
    drawn = rng.choice(n, r + 8, replace=False).astype(np.int32)
    line, hot = drawn[:r].copy(), drawn[r:]
    line[rng.random(r) < 0.5] = -1
    cas = rng.random(r) >= 0.125
    upgrade = cas & (rng.random(r) < 0.5)
    held = cas & ~upgrade & (rng.random(r) < 0.25)
    tile = r // 4
    for h, hl in enumerate(hot):                   # node k in tile k
        at = np.arange(4) * tile + 4 * np.arange(4) + 16 * h
        line[at] = hl
        cas[at] = [True, True, False, True]
        upgrade[at] = held[at] = False
    valid = line >= 0
    words[line[valid & upgrade]] = np.stack(
        [bit_hi, bit_lo], 1)[valid & upgrade]
    fresh = valid & cas & ~upgrade
    words[line[fresh]] = 0
    words[line[valid & held], 0] = other[valid & held]
    cmp_hi = np.where(upgrade, bit_hi, 0).astype(np.int32)
    cmp_lo = np.where(upgrade, bit_lo, 0).astype(np.int32)
    return words, {"line": line, "op": (~cas).astype(np.int32),
                   "arg_hi": np.where(cas, wf, bit_hi).astype(np.int32),
                   "arg_lo": np.where(cas, 0, bit_lo).astype(np.int32),
                   "cmp_hi": cmp_hi, "cmp_lo": cmp_lo}


def latch_app_case(dev, K, n=1 << 21, r=1024, tag="btree",
                   pattern="descent"):
    """K1 on :func:`latch_app_inputs` (``n`` words, ``r`` requests,
    ``pattern``); exact against the plain version, timed on both timers.
    The bound reads and writes the whole words table once;
    ``words_share`` is its part of the bound's bytes.  Keys carry the
    suffix ``_<tag>``."""
    from repro_torch.kernels.latch_ops import latch_apply_plain, REQ_KEYS
    words, req_np = latch_app_inputs(n, r, pattern)
    w = torch.from_numpy(words).to(dev)
    req = {k: torch.from_numpy(v).to(dev) for k, v in req_np.items()}
    got = K.apply_batch(w, req)
    want = latch_apply_plain(w, *[req[k] for k in REQ_KEYS])
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    assert err == 0, f"latch_ops disagrees at N={n}, R={r} ({err})"
    words_bytes = 2 * n * 8
    n_bytes = words_bytes + 6 * r * 4 + 3 * r * 4
    return {f"max_abs_err_{tag}": float(err),
            f"ms_{tag}": graph_ms(lambda: K.apply_batch(w, req)),
            f"ms_graph20_{tag}": graph20_ms(lambda: K.apply_batch(w, req)),
            f"bound_ms_{tag}": bound_ms(n_bytes)[0],
            f"words_share_{tag}": words_bytes / n_bytes}


def fetch_app_case(dev, K, p, e, r, empty, tag):
    """K2 on ``r`` requests over ``p`` pages of ``e`` int32 lanes, a
    fraction ``empty`` of the slots empty and the first four naming one
    page, with random reader bits (so the merge has work); exact against
    the plain version and timed on both timers beside ``index_select``
    over the same rows.  The bound reads the rows and the whole words
    table once and writes both; ``words_share`` is the words table's
    part of the bound's bytes.  Keys carry the suffix ``_<tag>``."""
    from repro_torch.kernels.gcl_fetch import gcl_fetch_plain
    rng = np.random.default_rng(SEED + 8)
    pages = torch.from_numpy(rng.integers(-2**31, 2**31, (p, e))
                             .astype(np.int32)).to(dev)
    words_np = rng.integers(0, 2**20, (p, 2)).astype(np.int32)
    req_np = rng.choice(p, r, replace=False).astype(np.int32)
    req_np[:4] = req_np[0]
    req_np[rng.random(r) < empty] = -1
    args = [torch.from_numpy(a).to(dev) for a in (
        words_np, req_np, rng.integers(0, 2**30, r).astype(np.int32),
        rng.integers(0, 2**30, r).astype(np.int32))]
    got = K.fetch(pages, *args)
    want = gcl_fetch_plain(pages, *args)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    assert err == 0, f"gcl_fetch disagrees at P={p}, E={e}, R={r} ({err})"
    n_valid = int((req_np >= 0).sum())
    words_bytes = 2 * p * 8
    n_bytes = n_valid * e * 4 + r * e * 4 + words_bytes + 6 * r * 4
    idx = args[1].long().clamp(min=0)
    return {f"max_abs_err_{tag}": float(err), f"valid_rows_{tag}": n_valid,
            f"ms_{tag}": graph_ms(lambda: K.fetch(pages, *args)),
            f"ms_graph20_{tag}": graph20_ms(lambda: K.fetch(pages, *args)),
            f"bound_ms_{tag}": bound_ms(n_bytes)[0],
            f"words_share_{tag}": words_bytes / n_bytes,
            f"library_ms_{tag}": graph_ms(
                lambda: torch.index_select(pages, 0, idx)),
            f"library_ms_graph20_{tag}": graph20_ms(
                lambda: torch.index_select(pages, 0, idx))}


def fetch_app_cases(dev, K):
    """K2 at the two applications' shapes (:func:`fetch_app_case`): the
    B-tree's round (P = 2^21 pages of 40 int32 lanes, 160-byte rows,
    R = 1024, every slot granted) and the txn FINALIZE spin's (P = 2^20
    pages of 18 lanes, 72-byte rows that take the byte path, R = 4096,
    half the slots empty)."""
    return {**fetch_app_case(dev, K, 1 << 21, 40, 1024, 0.0, "btree"),
            **fetch_app_case(dev, K, 1 << 20, 18, 4096, 0.5, "txn")}


def attention_inputs(dev, mp=16):
    """K3's inputs at the serving tick's shape: B = 16 slots, Hq = 16,
    Hkv = 8, hd = 128, page = 16, ``mp`` pages a window (16 at the
    serve), fp32 q, bf16 k/v read as views of a 1024-page int32 payload
    image (as ``pool.attend`` passes them), lens drawn in 1..window with
    one empty and one full row."""
    from repro_torch.dsm.kvpool import KVPoolConfig, decode_kv
    cfg = KVPoolConfig()
    rng = np.random.default_rng(SEED + 2)
    b, hq, hkv, hd, page = 16, 16, 8, 128, 16
    kv = torch.from_numpy(rng.normal(size=(cfg.n_pages, 2, page, hkv, hd))
                          .astype(np.float32)).to(dev, torch.bfloat16)
    image = kv.reshape(cfg.n_pages, -1).view(torch.int32)   # [P, W]
    k_pages, v_pages = decode_kv(image, cfg)                # strided views
    q = torch.from_numpy(rng.normal(size=(b, hq, hd)).astype(np.float32)) \
        .to(dev)
    lens_np = rng.integers(1, mp * page + 1, b).astype(np.int32)
    lens_np[0], lens_np[1] = 0, mp * page
    tbl_np = np.full((b, mp), -1, np.int32)
    perm = rng.permutation(cfg.n_pages)
    for i, n in enumerate(lens_np):
        used = -(-int(n) // page)
        tbl_np[i, :used] = perm[(i * mp + np.arange(used)) % cfg.n_pages]
    return (q, k_pages, v_pages, torch.from_numpy(tbl_np).to(dev),
            torch.from_numpy(lens_np).to(dev))


def paged_sdpa(q, k_pages, v_pages, tbl, lens):
    """K3's yardstick: a closure calling SDPA (bf16, GQA, length mask)
    over the pages gathered beforehand into [B, Hkv, window, hd]."""
    import torch.nn.functional as F
    b, mp = tbl.shape
    _, page, hkv, hd = k_pages.shape
    k_seq, v_seq = [x[tbl.long().clamp(min=0)].reshape(b, mp * page, hkv, hd)
                    .transpose(1, 2).contiguous() for x in (k_pages, v_pages)]
    qb = q.to(torch.bfloat16).unsqueeze(2)                  # [B, Hq, 1, hd]
    mask = (torch.arange(mp * page, device=q.device)[None, :]
            < lens[:, None]).view(b, 1, 1, mp * page)
    return lambda: F.scaled_dot_product_attention(
        qb, k_seq, v_seq, attn_mask=mask, enable_gqa=True)


def check_attention(dev, K, mp=16):
    """K3 on :func:`attention_inputs`.  Tolerance 1e-4: fp32
    accumulation in another order than the plain version's."""
    from repro_torch.kernels.paged_attention import paged_attention_plain
    q, k_pages, v_pages, tbl, lens = attention_inputs(dev, mp)
    b, hq, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    got = K.decode_paged(q, k_pages, v_pages, tbl, lens)
    want = paged_attention_plain(q, k_pages, v_pages, tbl, lens)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err < 1e-4, f"paged_attention off by {err} (tolerance 1e-4)"
    lens_np = lens.cpu().numpy()
    toks = int(lens_np.sum())
    n_bytes = (2 * toks * hkv * hd * 2 + 2 * b * hq * hd * 4
               + int(sum(-(-int(n) // page) for n in lens_np)) * 4 + b * 4)
    bms, by = bound_ms(n_bytes, 4.0 * hq * hd * toks)
    lib = paged_sdpa(q, k_pages, v_pages, tbl, lens)
    lib_ms = graph_ms(lib)
    row = {"name": "paged_attention", "max_abs_err": err,
           "ms": graph_ms(lambda: K.decode_paged(q, k_pages, v_pages, tbl,
                                                 lens)),
           "ms_graph20": graph20_ms(lambda: K.decode_paged(
               q, k_pages, v_pages, tbl, lens)),
           "plain_ms": eager_ms(lambda: paged_attention_plain(
               q, k_pages, v_pages, tbl, lens)),
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "library_ms_graph20": graph20_ms(lib)}
    log(f"rate paged_attention (window {mp * page}): "
        f"{n_bytes / row['ms'] / 1e6:.3f} GB/s, "
        f"{100 * bms / row['ms']:.2f} % of its bound, "
        f"{row['ms'] / lib_ms:.3f}x SDPA's time")
    return row


def check_flash(dev, K):
    """K4 at the Qwen3-1.7B prefill shape: B 4, S 512, Hq 16, Hkv 8,
    hd 128, bf16, causal, read through the model's [B, S, H, hd] layout;
    then a ragged S = 500 (correctness only).  Tolerance 2e-2 of
    max(1, |want|) elementwise: ``tests/test_kernels.py``'s bf16
    tolerance, scaled above 1 with the bf16 output's rounding step."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(SEED + 4)
    b, hq, hkv, hd = 4, 16, 8, 128

    def inputs(s):
        return [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                                 .astype(np.float32)).to(dev, torch.bfloat16)
                .transpose(1, 2) for h in (hq, hkv, hkv)]

    err = worst = 0.0
    for s in (500, 512):
        q, k, v = inputs(s)
        got = K.flash_attention(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        rel = float((diff / want.abs().clamp(min=1.0)).max())
        assert rel < 2e-2, f"flash_attention off by {rel} of max(1, " \
            f"|want|) at S={s} (tol 2e-2)"
        err, worst = max(err, float(diff.max())), max(worst, rel)
    s = 512
    n_bytes = b * s * (2 * hq + 2 * hkv) * hd * 2
    n_flops = 4.0 * b * hq * hd * s * (s + 1) / 2     # causal half
    bms, by = bound_ms(n_bytes, n_flops, BF16_FLOPS)
    row = {"name": "flash_attention", "max_abs_err": err,
           "ms": graph_ms(lambda: K.flash_attention(q, k, v, causal=True)),
           "ms_graph20": graph20_ms(lambda: K.flash_attention(
               q, k, v, causal=True)),
           "plain_ms": eager_ms(lambda: flash_attention_plain(
               q, k, v, causal=True)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)),
           "library_ms_graph20": graph20_ms(
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True))}
    q32, k32, v32 = [t.float() for t in (q, k, v)]     # fp32 FMA kernel
    f32_ms = graph_ms(lambda: K.flash_attention(q32, k32, v32, causal=True))
    log(f"rate flash_attention: {n_flops / row['ms'] / 1e9:.3f} TFLOP/s "
        f"(causal half), {100 * bms / row['ms']:.2f} % of its bound, "
        f"{row['ms'] / row['library_ms']:.3f}x SDPA's time; error "
        f"{worst} of max(1, |want|) (tolerance 2e-2); fp32 inputs "
        f"(FMA kernel) {f32_ms} ms at the same shape")
    return row


def window_pairs(s: int, window: int) -> int:
    """Visible (query, key) pairs of causal attention over the last
    ``window`` positions: row i sees min(i + 1, window) keys."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_window_cases(dev, K):
    """K4 at recurrentgemma-2b's shapes (``src/repro/configs/
    recurrentgemma_2b.py``: 10 q heads over one kv head, hd 256, local
    window 2048), bf16, read through the model's [B, S, H, hd] layout:
    its prefill, B 4, S 512, window 2048 (tag ``rg512``: the window
    covers the prompt), and B 4, S 4096, window 2048 (tag ``w4096``:
    each q tile walks at most 33 key tiles of 64).  Held against the
    plain version (2e-2 of max(1, |want|), as :func:`check_flash`; and
    each output row within 1e-2 of its want's L2 norm: at S 4096 a row
    averages up to 2048 values and |want| is near 0.03, where the
    elementwise bound alone would pass a key too many or too few at the
    window's edge, which moves a row by about 1 % of its norm and by
    tens of % where that key's score is high), timed beside its bound
    (operations over the pairs the window leaves) and SDPA's time
    (``is_causal`` for the first, a boolean [S, S] mask for the
    second).  Returns the K4 row's keys for both tags."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(SEED + 8)
    b, hq, hkv, hd, window = 4, 10, 1, 256, 2048
    out = {}
    for tag, s in (("rg512", 512), ("w4096", 4096)):
        q, k, v = [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                                    .astype(np.float32))
                   .to(dev, torch.bfloat16).transpose(1, 2)
                   for h in (hq, hkv, hkv)]

        def run(q=q, k=k, v=v):
            return K.flash_attention(q, k, v, causal=True, window=window)
        got = run()
        want = flash_attention_plain(q, k, v, causal=True,
                                     window=window).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        rel = float((diff / want.abs().clamp(min=1.0)).max())
        assert rel < 2e-2, f"windowed flash_attention off by {rel} of " \
            f"max(1, |want|) at S={s} (tol 2e-2)"
        row_rel = float((torch.linalg.vector_norm(diff, dim=-1)
                         / torch.linalg.vector_norm(want, dim=-1)
                         .clamp(min=1e-6)).max())
        assert row_rel < 1e-2, f"windowed flash_attention: a row off by " \
            f"{row_rel} of its L2 norm at S={s} (tol 1e-2)"
        del want
        if s > window:
            pos = torch.arange(s, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)

            def lib(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            def lib(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
        n_bytes = b * s * (2 * hq + 2 * hkv) * hd * 2
        n_flops = 4.0 * b * hq * hd * window_pairs(s, window)
        bms, by = bound_ms(n_bytes, n_flops, BF16_FLOPS)
        row = {"max_abs_err": float(diff.max()), "ms": graph_ms(run),
               "ms_graph20": graph20_ms(run),
               "plain_ms": eager_ms(lambda q=q, k=k, v=v:
                                    flash_attention_plain(
                                        q, k, v, causal=True,
                                        window=window), iters=5),
               "bound_ms": bms, "bound_by": by, "library_ms": graph_ms(lib),
               "library_ms_graph20": graph20_ms(lib)}
        log(f"rate flash_attention {tag} (B {b}, S {s}, Hq {hq}, Hkv "
            f"{hkv}, hd {hd}, window {window}): "
            f"{n_flops / row['ms'] / 1e9:.3f} TFLOP/s, "
            f"{100 * bms / row['ms']:.2f} % of its bound, "
            f"{row['ms'] / row['library_ms']:.3f}x SDPA's time; error "
            f"{rel} of max(1, |want|) (tolerance 2e-2), {row_rel} of a "
            f"row's L2 norm (tolerance 1e-2)")
        out.update({f"{key}_{tag}": val for key, val in row.items()})
    return out


# K4 at the vlm and encdec families' shapes: tag -> (B, Sq, Sk, Hq, Hkv,
# hd, causal, q_offset)
FLASH_CROSS_CASES = {
    # llava-next-mistral-7b's prefill: 1152 patches + 512 tokens
    "llava": (4, 1664, 1664, 32, 8, 128, True, 0),
    # seamless-m4t-medium's cross-attention: 512 decoder rows over the
    # encoder's 128 frames, and the same at a decode step
    "xattn": (4, 512, 128, 16, 16, 64, False, 0),
    "xdec": (4, 1, 128, 16, 16, 64, False, 0),
    # the prompt's 512 rows after llava's 1152 patches (the offset route:
    # a prefill of the prompt over a cache that already holds the image)
    "offset": (4, 512, 1664, 32, 8, 128, True, 1152),
}


def flash_cross_cases(dev, K):
    """K4 at :data:`FLASH_CROSS_CASES`, bf16, read through the model's
    [B, S, H, hd] layout: held against the plain version (2e-2 of
    max(1, |want|) elementwise and each row within 1e-2 of its want's
    L2 norm, as :func:`flash_window_cases`), timed beside its bound (the
    pairs ``kernels.flash_attention.visible_pairs`` counts) and SDPA's
    time for the same call (``is_causal`` where the queries and keys line
    up, no mask for the cross-attention, a boolean [Sq, Sk] mask for the
    offset).  Returns the K4 row's keys for each tag."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import visible_pairs
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(SEED + 10)
    out = {}
    for tag, (b, sq, sk, hq, hkv, hd, causal, off) in \
            FLASH_CROSS_CASES.items():
        q, k, v = [torch.from_numpy(rng.normal(size=(b, n, h, hd))
                                    .astype(np.float32))
                   .to(dev, torch.bfloat16).transpose(1, 2)
                   for n, h in ((sq, hq), (sk, hkv), (sk, hkv))]

        def run(q=q, k=k, v=v, causal=causal, off=off):
            return K.flash_attention(q, k, v, causal=causal, q_offset=off)
        got = run()
        want = flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=off).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        rel = float((diff / want.abs().clamp(min=1.0)).max())
        assert rel < 2e-2, f"flash_attention {tag} off by {rel} of " \
            f"max(1, |want|) (tol 2e-2)"
        row_rel = float((torch.linalg.vector_norm(diff, dim=-1)
                         / torch.linalg.vector_norm(want, dim=-1)
                         .clamp(min=1e-6)).max())
        assert row_rel < 1e-2, f"flash_attention {tag}: a row off by " \
            f"{row_rel} of its L2 norm (tol 1e-2)"
        del want
        if off:
            pos = torch.arange(sk, device=dev)
            mask = pos[None, :] <= off + torch.arange(sq, device=dev)[:, None]

            def lib(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            def lib(q=q, k=k, v=v, causal=causal):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        n_bytes = 2 * b * hd * (2 * sq * hq + 2 * sk * hkv)
        n_flops = 4.0 * b * hq * hd * visible_pairs(sq, sk, causal, off)
        bms, by = bound_ms(n_bytes, n_flops, BF16_FLOPS)
        row = {"max_abs_err": float(diff.max()), "ms": graph_ms(run),
               "ms_graph20": graph20_ms(run),
               "plain_ms": eager_ms(lambda q=q, k=k, v=v, causal=causal,
                                    off=off: flash_attention_plain(
                                        q, k, v, causal=causal,
                                        q_offset=off), iters=5),
               "bound_ms": bms, "bound_by": by, "library_ms": graph_ms(lib),
               "library_ms_graph20": graph20_ms(lib)}
        log(f"rate flash_attention {tag} (B {b}, Sq {sq}, Sk {sk}, Hq {hq}, "
            f"Hkv {hkv}, hd {hd}, causal {causal}, q_offset {off}): "
            f"{n_flops / row['ms'] / 1e9:.3f} TFLOP/s, "
            f"{n_bytes / row['ms'] / 1e6:.3f} GB/s, "
            f"{100 * bms / row['ms']:.2f} % of its bound ({by}), "
            f"{row['ms'] / row['library_ms']:.3f}x SDPA's time; error "
            f"{rel} of max(1, |want|) (tolerance 2e-2), {row_rel} of a "
            f"row's L2 norm (tolerance 1e-2)")
        out.update({f"{key}_{tag}": val for key, val in row.items()})
    return out


def check_ssd(dev, K):
    """K5 at the Mamba2-2.7B prefill shape: B*nc 8 (batch 4, two chunks),
    Q 256, H 80, P 64, fp32, with a cumsum steep enough that exp
    overflows above the diagonal.  Tolerance 2e-4 of the output's scale
    (fp32 sums of up to 256 terms in another order).  No single PyTorch
    call computes this function: library_ms is null."""
    from repro_torch.kernels.ssd_intra import ssd_intra_plain
    rng = np.random.default_rng(SEED + 5)
    bc, q, h, p = 8, 256, 80, 64
    cb = torch.from_numpy(rng.normal(size=(bc, q, q)).astype(np.float32))
    cs = torch.from_numpy((-np.abs(rng.normal(size=(bc, q, h)))
                           .cumsum(axis=1)).astype(np.float32))
    win = torch.from_numpy(rng.normal(size=(bc, q, h, p)).astype(np.float32))
    cb, cs, win = cb.to(dev), cs.to(dev), win.to(dev)
    got = K.ssd_intra(cb, cs, win)
    want = ssd_intra_plain(cb, cs, win)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()), "ssd_intra gave non-finite"
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    assert err < 2e-4 * scale, f"ssd_intra off by {err} (tol 2e-4 x {scale})"
    n_bytes = 4 * (bc * q * q + bc * q * h + 2 * bc * q * h * p)
    n_flops = bc * h * q * (q + 1) / 2 * (2.0 * p + 3)  # causal pairs
    bms, by = bound_ms(n_bytes, n_flops, TF32_FLOPS)
    row = {"name": "ssd_intra", "max_abs_err": err,
           "ms": graph_ms(lambda: K.ssd_intra(cb, cs, win)),
           "ms_graph20": graph20_ms(lambda: K.ssd_intra(cb, cs, win)),
           "plain_ms": eager_ms(lambda: ssd_intra_plain(cb, cs, win)),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    log(f"rate ssd_intra: {n_bytes / row['ms'] / 1e6:.3f} GB/s, "
        f"{3 * n_flops / row['ms'] / 1e9:.3f} TFLOP/s of TF32 products "
        f"(3xTF32), {100 * bms / row['ms']:.2f} % of its bound; error "
        f"{err / scale} of the scale (tolerance 2e-4); the fp32 FMA bound "
        f"of the first port: {bound_ms(n_bytes, n_flops, FP32_FLOPS)[0]} ms")
    return row


# K4's backward at the training path's shapes: tag -> (B, Sq, Sk, Hq, Hkv,
# hd, causal, q_offset, window)
FLASH_BWD_CASES = {
    # Qwen3-1.7B training: batch 4, seq 512 (the row's unsuffixed keys)
    "": (4, 512, 512, 16, 8, 128, True, 0, None),
    # seamless-m4t-medium's cross-attention: 512 rows over 128 frames
    "xattn": (4, 512, 128, 16, 16, 64, False, 0, None),
    # a window that bites at hd 128 (Qwen3's heads, S 1024, window 256)
    "window": (4, 1024, 1024, 16, 8, 128, True, 0, 256),
    # llava's prompt after its 1152 patches (the offset route)
    "offset": (4, 512, 1664, 32, 8, 128, True, 1152, None),
    # recurrentgemma-2b's local attention (hd 256, 10 q heads over one kv
    # head, window 2048): phase 7's training shape, where the window does
    # not bite, and S 4096, where it does
    "rg512": (4, 512, 512, 10, 1, 256, True, 0, 2048),
    "rgw4096": (4, 4096, 4096, 10, 1, 256, True, 0, 2048),
}
BWD_TOL = 3e-2     # K4 backward, bf16: x max(1, max |want|) per gradient
BWD_ROW_TOL = 1e-2  # K4 backward, bf16: x each gradient row's L2 norm
ROW_FLOOR = 0.1     # ... floored at this share of the tensor's RMS row norm


def _grad_rel(got, want) -> float:
    """Largest error of the gradient tensors, each over max(1, its max
    |want|)."""
    return max(float((g.float() - w.float()).abs().max()
                     / max(1.0, float(w.float().abs().max())))
               for g, w in zip(got, want))


def grad_row_rel(got, want) -> float:
    """Largest error of any gradient row (one (b, h, s) of a [B, H, S,
    hd] gradient) over that row's L2 norm, the norm floored at
    :data:`ROW_FLOOR` of the tensor's RMS row norm.  The bound over the
    tensor's max alone is as large as a typical entry where a few early
    rows hold the largest values, and would pass a tile or head walked
    wrong.  The floor is for rows whose exact gradient cancels: a causal
    query row that sees one key has P = 1 and dS = dP - D = 0, so its dq
    is zero and both versions give rounding noise there."""
    out = 0.0
    for g, w in zip(got, want):
        norm = torch.linalg.vector_norm(w.float(), dim=-1)
        floor = ROW_FLOOR * float(norm.square().mean().sqrt())
        err = torch.linalg.vector_norm(g.float() - w.float(), dim=-1)
        out = max(out, float((err / norm.clamp(min=max(floor, 1e-30)))
                             .max()))
    return out


def check_flash_bwd(dev, K, cases=None):
    """K4's backward at :data:`FLASH_BWD_CASES` (or at its tags
    ``cases``), bf16, through the model's [B, S, H, hd] layout, from the
    forward's own output and log-sum-exp (``flash_attention_lse_launch``;
    the log-sum-exp held against the plain one within 1e-3): (dq, dk, dv)
    held against ``flash_attention_bwd_plain`` (:data:`BWD_TOL`: P and dS
    are rounded to bf16 before their products; and each gradient row
    within :data:`BWD_ROW_TOL` of its L2 norm, :func:`grad_row_rel`), the
    same bits from a second call (``digest``: the first 16 hex digits of
    the SHA-256 of dq, dk and dv's bytes, to compare builds), timed beside
    its bound (5 products
    of 2 pairs hd operations over the bf16 peak, or its bytes: q, k, v,
    out, dout and lse read, dq, dk, dv written) and the library's time:
    autograd of ``F.scaled_dot_product_attention`` (forward and backward
    in one graph, less its forward alone).  At the Qwen3 shape also
    K4's forward with and without the log-sum-exp output (the serve
    passes none)."""
    from repro_torch.kernels.flash_attention import visible_pairs
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _launch_fwd, _visible, flash_attention_bwd_plain,
        flash_attention_plain)
    rng = np.random.default_rng(SEED + 11)
    row = {"name": "flash_attention_bwd"}
    for tag in FLASH_BWD_CASES if cases is None else cases:
        b, sq, sk, hq, hkv, hd, causal, off, window = FLASH_BWD_CASES[tag]
        q, k, v, do = [torch.from_numpy(rng.normal(size=(b, n, h, hd))
                                        .astype(np.float32))
                       .to(dev, torch.bfloat16).transpose(1, 2)
                       for n, h in ((sq, hq), (sk, hkv), (sk, hkv),
                                    (sq, hq))]
        kw = dict(causal=causal, window=window, q_offset=off)
        out, lse = _launch_fwd(q, k, v, causal, window, off, True)
        _, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
        lse_err = float((lse - want_lse).abs().max())
        assert lse_err < 1e-3, f"K4 log-sum-exp {tag} off by {lse_err}"

        def run(q=q, k=k, v=v, out=out, lse=lse, do=do, kw=kw):
            return K.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        got = run()
        again = run()
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(g).all()) for g in got)
        assert all(torch.equal(g, a) for g, a in zip(got, again)), \
            f"flash_attention_bwd {tag}: two calls gave other bits"
        digest = hashlib.sha256(b"".join(
            g.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for g in got)).hexdigest()[:16]
        del again
        rel = _grad_rel(got, want)
        assert rel < BWD_TOL, f"flash_attention_bwd {tag} off by {rel} " \
            f"of max(1, |want|) (tol {BWD_TOL})"
        row_rel = grad_row_rel(got, want)
        assert row_rel < BWD_ROW_TOL, f"flash_attention_bwd {tag}: a " \
            f"gradient row off by {row_rel} of its L2 norm (tol {BWD_ROW_TOL})"
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        del want
        pairs = visible_pairs(sq, sk, causal, off, window)
        n_bytes = 2 * b * hd * (4 * sq * hq + 4 * sk * hkv) + 4 * b * hq * sq
        n_flops = 5 * 2.0 * b * hq * hd * pairs
        bms, by = bound_ms(n_bytes, n_flops, BF16_FLOPS)
        # SDPA's is_causal aligns the diagonal at the top left: a window or
        # an offset goes in as a boolean mask
        mask = _visible(sq, sk, causal, window, off, dev) \
            if (window or off) else None
        qg, kg, vg = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def lib_fwd(mask=mask, causal=causal, qg=qg, kg=kg, vg=vg):
            return F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        def lib_fwd_bwd(lib_fwd=lib_fwd, qg=qg, kg=kg, vg=vg, do=do):
            return torch.autograd.grad(lib_fwd(), (qg, kg, vg), do)
        lib_fb = graph_ms(lib_fwd_bwd, iters=50)
        lib_f = graph_ms(lib_fwd, iters=50)
        sfx = f"_{tag}" if tag else ""
        case = {"max_abs_err": err, "row_err": row_rel, "digest": digest,
                "ms": graph_ms(run, iters=50),
                "ms_graph20": graph_ms(run, iters=10, calls=20),
                "plain_ms": eager_ms(lambda q=q, k=k, v=v, out=out, lse=lse,
                                     do=do, kw=kw: flash_attention_bwd_plain(
                                         q, k, v, out, lse, do, **kw),
                                     iters=3),
                "bound_ms": bms, "bound_by": by,
                "library_ms": lib_fb - lib_f, "library_fwd_bwd_ms": lib_fb}
        row.update({f"{key}{sfx}": val for key, val in case.items()})
        log(f"rate flash_attention_bwd {tag or 'qwen3'} (B {b}, Sq {sq}, "
            f"Sk {sk}, Hq {hq}, Hkv {hkv}, hd {hd}, causal {causal}, "
            f"q_offset {off}, window {window}): "
            f"{n_flops / case['ms'] / 1e9:.3f} TFLOP/s, "
            f"{100 * bms / case['ms']:.2f} % of its bound ({by}), "
            f"{case['ms'] / case['library_ms']:.3f}x SDPA's backward; error "
            f"{rel} of max(1, |want|) (tolerance {BWD_TOL}), {row_rel} of a "
            f"row's L2 norm (tolerance {BWD_ROW_TOL}); log-sum-exp error "
            f"{lse_err}")
        if not tag:
            row["fwd_ms_graph20"] = graph20_ms(
                lambda: _launch_fwd(q, k, v, True, None, 0, False))
            row["fwd_lse_ms_graph20"] = graph20_ms(
                lambda: _launch_fwd(q, k, v, True, None, 0, True))
            log(f"K4 forward at the Qwen3 shape: ms_graph20 "
                f"{row['fwd_ms_graph20']} without the log-sum-exp, "
                f"{row['fwd_lse_ms_graph20']} with it")
        del q, k, v, do, out, lse, qg, kg, vg, got
    return row


def check_ssd_bwd(dev, K):
    """K5's backward at the Mamba2-2.7B training shape (batch 4, seq 512:
    8 chunks of Q 256, H 80, P 64, fp32), from the forward kernel's own
    output, with a cumsum steep enough that exp overflows above the
    diagonal: (dcb, dcs, dwin) held against ``ssd_intra_bwd_plain``
    within 1e-4 of max(1, each gradient's max |want|) (fp32 sums of up to
    256 terms in another order; dcs a difference of two such sums), timed
    beside its bound (the function's bytes: cb, cs, win and dy read, dcb,
    dcs and dwin written; or its operations, 2 products of 2 P per (q, k,
    h) pair of the triangle, over the TF32 tensor-core peak, as
    :func:`check_ssd` bounds the forward; the kernel also reads the
    forward's output, which the bound does not count).  No single
    PyTorch call computes it: library_ms is null."""
    from repro_torch.kernels.ssd_intra import ssd_intra_bwd_plain
    rng = np.random.default_rng(SEED + 12)
    bc, q, h, p = 8, 256, 80, 64
    cb, cs, win, dy = [torch.from_numpy(a.astype(np.float32)).to(dev)
                       for a in (rng.normal(size=(bc, q, q)),
                                 -np.abs(rng.normal(size=(bc, q, h)))
                                 .cumsum(axis=1),
                                 rng.normal(size=(bc, q, h, p)),
                                 rng.normal(size=(bc, q, h, p)))]
    y = K.ssd_intra(cb, cs, win)

    def run():
        return K.ssd_intra_bwd(cb, cs, win, dy, y)
    got = run()
    want = ssd_intra_bwd_plain(cb, cs, win, dy)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got), \
        "ssd_intra_bwd gave non-finite"
    rel = _grad_rel(got, want)
    assert rel < 1e-4, f"ssd_intra_bwd off by {rel} (tol 1e-4)"
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del want
    n_bytes = 4 * (2 * bc * q * q + 2 * bc * q * h + 3 * bc * q * h * p)
    n_flops = bc * h * q * (q + 1) / 2 * (4.0 * p + 6)
    bms, by = bound_ms(n_bytes, n_flops, TF32_FLOPS)
    row = {"name": "ssd_intra_bwd", "max_abs_err": err,
           "ms": graph_ms(run, iters=50),
           "ms_graph20": graph_ms(run, iters=10, calls=20),
           "plain_ms": eager_ms(lambda: ssd_intra_bwd_plain(cb, cs, win, dy),
                                iters=3),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    log(f"rate ssd_intra_bwd: {n_flops / row['ms'] / 1e9:.3f} TFLOP/s "
        f"(3xTF32 tensor cores, each product counted once), "
        f"{n_bytes / row['ms'] / 1e6:.3f} GB/s, "
        f"{100 * bms / row['ms']:.2f} % of its bound ({by}); error {rel} of "
        f"max(1, |want|) (tolerance 1e-4); the TF32 tensor-core bound of "
        f"its three TF32 products: "
        f"{bound_ms(0, 3 * n_flops, TF32_FLOPS)[0]} ms")
    return row


# --------------------------------------------------------- phase 3: serve

def serve(dev, cfg=None, n_q_heads=16, recorder=None, mesh=None,
          requests=48):
    """The main path: ``cfg`` defaults to ``KVPoolConfig()`` (1024 x 16
    tokens, 8 kv heads x 128, 4 replicas, bf16) and ``n_q_heads`` to
    Qwen3-1.7B's 16.  ``recorder`` goes to the ``ServeLoop``; ``mesh``
    (a ``Mesh`` on ``dev``) makes the pool mesh-backed; ``requests``
    takes the first of the trace's 48 requests (CPU rehearsals).  The
    result's ``dispatches`` counts the loop's plane verbs on its own
    (wrappers around the plane's ``ops`` and ``rmw``), which also hash
    every dispatch's versions (``versions_sha256``) and sum its
    telemetry; ``state_sha256`` hashes the final unsharded rounds
    state."""
    from repro_torch.core.rounds import check_invariants
    from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.serve import RequestState, ServeLoop, ToyLM, write_pages

    cfg = KVPoolConfig() if cfg is None else cfg
    pool = SELCCKVPool(cfg, mesh, device=dev)
    pool.open_rounds_plane()
    model = ToyLM(cfg, n_q_heads=n_q_heads)
    ps = cfg.page_size

    prefix_tokens = list(range(11, 11 + 2 * ps))       # 32-token prefix
    prefix = pool.allocate(len(prefix_tokens) // ps)
    shape = (len(prefix), ps, cfg.n_kv_heads, cfg.head_dim)
    pk, pv = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for i, t in enumerate(prefix_tokens):
        pk[i // ps, i % ps], pv[i // ps, i % ps] = model.kv(t, i)
    write_pages(pool, prefix, pk, pv)

    checked = {"readback": 0, "attend": 0}

    def on_complete(req, slot):
        kp, vp, wr = model.expected_pages(req)
        k, v, _ = pool.read(slot.replica, np.asarray(slot.pages, np.int32))
        assert np.array_equal(k.float().numpy()[wr], kp[wr]) and \
            np.array_equal(v.float().numpy()[wr], vp[wr]), \
            f"request {req.rid}: KV readback differs from the oracle"
        checked["readback"] += 1
        if req.rid % 4 == 0:                   # attend sample, plain K3
            fk = np.concatenate([pk, kp]) if req.shared_pages else kp
            fv = np.concatenate([pv, vp]) if req.shared_pages else vp
            last = (req.generated[-2] if len(req.generated) > 1
                    else req.prompt[-1])
            q = torch.from_numpy(model.query(last, req.kv_len - 1)[None])
            want = paged_attention_plain(
                q, torch.from_numpy(fk), torch.from_numpy(fv),
                torch.arange(len(fk), dtype=torch.int32)[None],
                torch.tensor([req.kv_len], dtype=torch.int32))[0].numpy()
            err = float(np.abs(slot.last_attn - want).max())
            assert err < 1e-4, f"request {req.rid}: attend off by {err}"
            checked["attend"] += 1

    dispatches = collections.Counter()
    versions = hashlib.sha256()
    tele = []
    plane = pool.rounds_plane
    for verb in ("ops", "rmw"):
        def counting(*a, _real=getattr(plane, verb), _verb=verb, **kw):
            dispatches[_verb] += 1
            res = _real(*a, **kw)
            versions.update(np.ascontiguousarray(res.version).tobytes())
            tele.append(res.telemetry)
            return res
        setattr(plane, verb, counting)
    loop = ServeLoop(pool, model, n_slots=16, max_pages=16,
                     prefill_chunk=16, queue_capacity=64,
                     on_complete=on_complete, recorder=recorder)
    rng = np.random.default_rng(SEED + 3)
    reqs = []
    for i in range(requests):
        prompt = [int(x) for x in rng.integers(0, model.vocab,
                                               int(rng.integers(8, 129)))]
        max_new = int(rng.integers(8, 97))
        if i % 3 == 0:
            reqs.append(loop.submit(prompt, max_new, shared_pages=prefix,
                                    shared_len=len(prefix_tokens)))
        else:
            reqs.append(loop.submit(prompt, max_new))
    t0 = time.perf_counter()
    ticks = 0
    while loop.has_work():
        loop.tick()
        ticks += 1
        assert ticks < 5000, "serve loop did not drain"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = loop.stats()
    assert all(r.state is RequestState.DONE for r in reqs)
    assert all(len(r.generated) == r.max_new for r in reqs)
    assert checked["readback"] == len(reqs) and checked["attend"] > 0
    flat = plane.flat_state()
    check_invariants(flat)
    assert pool.pages_in_use == len(prefix), "pages leaked"
    t = sum(tele[1:], tele[0])
    return {"requests": len(reqs), "ticks": ticks,
            "shards": plane.n_shards,
            "versions_sha256": versions.hexdigest(),
            "state_sha256": state_sha256(flat),
            "occupancy": t.occupancy.tolist(),
            "served_per_home": t.served_per_home.tolist(),
            "deferred": t.deferred_total,
            "tokens_generated": sum(len(r.generated) for r in reqs),
            "kv_rows_appended": st.appended_tokens,
            "coherence_rounds": st.rounds_total,
            "attend_calls": st.attend_calls, "wall_s": wall,
            "readbacks_checked": checked["readback"],
            "attends_checked": checked["attend"],
            "dispatches": dict(dispatches)}


def state_sha256(state) -> str:
    """The hash of a round state's leaves, in key order."""
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(state[k].cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def fetch_histogram():
    """Counts the round engine's K2 calls by (R, valid rows) into the
    dictionary it yields under ``"calls"``, and its valid rows by when
    their page was last named: by the call before (``"named_before"``),
    by an earlier one (``"named_earlier"``) or never (``"first"``);
    filled when the block ends: each call's request tensor is kept
    meanwhile (no copy, no sync)."""
    from repro_torch.core.rounds import engine
    reqs, real = [], engine.gcl_fetch_op
    hist = {"calls": {}, "named_before": 0, "named_earlier": 0, "first": 0}

    def recording(pages, words, req_page, bit_hi, bit_lo):
        reqs.append(req_page)
        return real(pages, words, req_page, bit_hi, bit_lo)

    engine.gcl_fetch_op = recording
    try:
        yield hist
    finally:
        engine.gcl_fetch_op = real
    host = [[p for p in t.tolist() if p >= 0] for t in reqs]
    hist["calls"].update(sorted(collections.Counter(
        (t.shape[0], len(v)) for t, v in zip(reqs, host)).items()))
    last = {}                                # page -> call that last named it
    for i, pages in enumerate(host):
        for p in pages:
            key = ("first" if p not in last else "named_before"
                   if last[p] == i - 1 else "named_earlier")
            hist[key] += 1
        last.update((p, i) for p in pages)


# ----------------------------------------- phase 3b: the legacy page pool

LEGACY_SEQS = 32                   # 32 sequences x 32 pages fill the pool
LEGACY_PREFILL = 480               # tokens a sequence, one append a replica
LEGACY_STEPS = 32                  # decode steps after it


def serve_with_recorder(dev, runs=2):
    """Phase 3's serve again, with a ``FlightRecorder(4096)`` on its loop
    and without, alternated ``runs`` times each: the spans by verb must
    equal the dispatches the serve counts itself, every ``compiled`` 0,
    and the Chrome trace must load back as JSON.  Returns the walls, the
    spans by verb and the recorder's ``snapshot()``."""
    import tempfile
    from repro_torch.obs import FlightRecorder
    walls = {"recorder": [], "none": []}
    snap = None
    for _ in range(runs):
        for mode in ("none", "recorder"):
            rec = FlightRecorder(4096) if mode == "recorder" else None
            res = serve(dev, recorder=rec)
            walls[mode].append(res["wall_s"])
            if rec is None:
                continue
            spans = collections.Counter(s.verb for s in rec.spans())
            assert rec.dropped == 0, "the ring dropped spans"
            assert dict(spans) == res["dispatches"], \
                f"spans {dict(spans)} != dispatches {res['dispatches']}"
            assert all(s.compiled == 0 for s in rec.spans())
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                rec.export_chrome_trace(path)
                with open(path) as f:
                    doc = json.load(f)
            assert len(doc["traceEvents"]) == rec.total
            snap = rec.snapshot()
    return {"wall_s": walls, "spans": dict(spans), "snapshot": snap}


class LegacyOracle:
    """numpy model of the legacy pool: page images (bf16 bits as int16),
    versions, fills, the directory words (Python ints), the readers that
    appends evict, and each replica's direct-mapped cache tags."""

    def __init__(self, cfg):
        shape = (cfg.n_pages, cfg.page_size, cfg.n_kv_heads, cfg.head_dim)
        self.cfg = cfg
        self.k = np.zeros(shape, np.int16)
        self.v = np.zeros(shape, np.int16)
        self.version = np.zeros(cfg.n_pages, np.int64)
        self.fill = np.zeros(cfg.n_pages, np.int64)
        self.words = [0] * cfg.n_pages
        self.evictions = 0
        self.tag_page = np.full((cfg.n_replicas, cfg.cache_slots), -1)
        self.tag_version = np.zeros((cfg.n_replicas, cfg.cache_slots),
                                    np.int64)

    def append(self, rep, pages, offs, kbits, vbits):
        """Every row's upgrade CAS in order: the first row of a page
        finding the word other than the appender's sole bit fails, and
        so does every later row of the page, each counting the word's
        other readers; then the writes, and the downgraded word."""
        bit = 1 << rep
        for p, n in collections.Counter(pages.tolist()).items():
            w = self.words[p]
            if w != bit:
                self.evictions += n * bin(w & ~bit).count("1")
            self.words[p] = bit
        self.k[pages, offs] = kbits
        self.v[pages, offs] = vbits
        np.add.at(self.version, pages, 1)
        np.maximum.at(self.fill, pages, offs + 1)

    def read(self, rep, pages):
        """The hit mask; misses register the reader's bit, and of the
        rows sharing a slot the last one installs its page if it
        missed."""
        slots = pages % self.cfg.cache_slots
        hit = (self.tag_page[rep, slots] == pages) & \
            (self.tag_version[rep, slots] == self.version[pages])
        for p in pages[~hit].tolist():
            self.words[p] |= 1 << rep
        last = {}
        for i, sl in enumerate(slots.tolist()):
            last[sl] = i
        for sl, i in last.items():
            if not hit[i]:
                self.tag_page[rep, sl] = pages[i]
                self.tag_version[rep, sl] = self.version[pages[i]]
        return hit


def legacy_inputs(cfg, n_seqs=LEGACY_SEQS, prefill=LEGACY_PREFILL,
                  steps=LEGACY_STEPS, n_q_heads=16, seed=SEED + 11):
    """Seeded K/V of every token, [n_seqs, prefill + steps, Hkv, hd] in
    the pool dtype, and each step's queries [steps, n_seqs, Hq, hd]
    fp32, on the host."""
    from repro_torch.dsm.kvpool import pool_dtype
    g = torch.Generator().manual_seed(seed)
    shape = (n_seqs, prefill + steps, cfg.n_kv_heads, cfg.head_dim)
    dt = pool_dtype(cfg)
    return {"k": torch.randn(shape, generator=g).to(dt),
            "v": torch.randn(shape, generator=g).to(dt),
            "q": torch.randn((steps, n_seqs, n_q_heads, cfg.head_dim),
                             generator=g)}


def legacy_shared(seq_pages):
    """The pages of sequence 0 that every replica reads besides its own:
    the first two, and the two its decode appends into (so replicas 1-3
    hold reader bits that replica 0's appends evict)."""
    return np.concatenate([seq_pages[0][:2], seq_pages[0][-2:]])


def legacy_run(pool, inp, prefill=LEGACY_PREFILL, oracle=None,
               on_attend=None):
    """Drive the legacy pool: ``n_seqs`` sequences of ``n_pages /
    n_seqs`` pages, sequence ``s`` owned by replica ``s % n_replicas``;
    a prefill of ``prefill`` tokens a sequence as one append a replica;
    then ``steps`` decode steps of one append a replica (a token a
    sequence), a read by every replica of its own sequences' pages and
    :func:`legacy_shared`, and one attend over every sequence's page
    table.  With ``oracle`` every hit mask is checked against it.
    Returns the hit masks, the call counts and the seconds spent in
    appends and reads (each call synchronized)."""
    cfg, dev = pool.cfg, pool.device
    n_rep, ps = cfg.n_replicas, cfg.page_size
    k_all, v_all = inp["k"].to(dev), inp["v"].to(dev)
    n_seqs, steps = k_all.shape[0], inp["q"].shape[0]
    per_seq = cfg.n_pages // n_seqs
    seq_pages = [pool.allocate(per_seq) for _ in range(n_seqs)]
    tbl = np.stack(seq_pages).astype(np.int32)
    shared = legacy_shared(seq_pages)
    own = [[s for s in range(n_seqs) if s % n_rep == r]
           for r in range(n_rep)]
    out = {"hits": [], "appends": 0, "rows": 0, "reads": 0,
           "pages_read": 0, "attends": 0, "append_s": 0.0, "read_s": 0.0,
           "attend_s": 0.0}

    def append(r, seqs, toks):
        pages = np.concatenate([tbl[s, toks // ps] for s in seqs])
        offs = np.tile(toks % ps, len(seqs)).astype(np.int32)
        tok_idx = torch.as_tensor(toks, device=dev)
        k = k_all[seqs][:, tok_idx].reshape(-1, cfg.n_kv_heads,
                                           cfg.head_dim)
        v = v_all[seqs][:, tok_idx].reshape(-1, cfg.n_kv_heads,
                                           cfg.head_dim)
        sync(dev)
        t0 = time.perf_counter()
        pool.append(pages, offs, k, v, replica=r)
        sync(dev)
        out["append_s"] += time.perf_counter() - t0
        out["appends"] += 1
        out["rows"] += pages.shape[0]
        if oracle is not None:
            oracle.append(r, pages, offs,
                          k.cpu().view(torch.int16).numpy(),
                          v.cpu().view(torch.int16).numpy())

    for r in range(n_rep):
        append(r, own[r], np.arange(prefill))
    for step in range(steps):
        t = prefill + step
        for r in range(n_rep):
            append(r, own[r], np.array([t]))
        for r in range(n_rep):
            pages = np.concatenate([tbl[own[r]].reshape(-1), shared])
            t0 = time.perf_counter()
            _, _, hit = pool.read(r, pages)
            sync(dev)
            out["read_s"] += time.perf_counter() - t0
            out["reads"] += 1
            out["pages_read"] += pages.shape[0]
            out["hits"].append(hit)
            if oracle is not None:
                want = oracle.read(r, pages)
                assert np.array_equal(hit, want), \
                    f"step {step}, replica {r}: hit mask differs"
        lens = np.full(n_seqs, t + 1, np.int32)
        q = inp["q"][step].to(dev)
        t0 = time.perf_counter()
        got = pool.attend(q, tbl, lens)
        sync(dev)
        out["attend_s"] += time.perf_counter() - t0
        out["attends"] += 1
        if on_attend is not None:
            on_attend(step, q, tbl, lens, got)
    return out


def words_as_ints(words) -> list:
    """[P, 2] int32 lanes -> each page's 64-bit word as a Python int."""
    w = words.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    return [int(h) << 32 | int(lo) for h, lo in w]


@contextlib.contextmanager
def legacy_calls():
    """Keeps references to the legacy pool's kernel calls (no copy, no
    sync): the largest K1 call, the K2 calls since the last ``step()``,
    and the last K3 call.  The pool updates ``k_pages`` in place and
    replaces its ``words``, so the recorded inputs stay as they were as
    long as no append follows them."""
    from repro_torch.dsm import kvpool
    real = {n: getattr(kvpool, n) for n in ("apply_batch", "gcl_fetch_op",
                                            "decode_paged")}
    rec = {"k1": None, "k2": [], "k3": None}

    def k1(words, req):
        if rec["k1"] is None or req["line"].shape[0] >= \
                rec["k1"][1]["line"].shape[0]:
            rec["k1"] = (words, req)
        return real["apply_batch"](words, req)

    def k2(*args):
        rec["k2"].append(args)
        return real["gcl_fetch_op"](*args)

    def k3(*args):
        rec["k3"] = args
        return real["decode_paged"](*args)

    kvpool.apply_batch, kvpool.gcl_fetch_op, kvpool.decode_paged = k1, k2, k3
    try:
        yield rec
    finally:
        for n, f in real.items():
            setattr(kvpool, n, f)


def _bits16(t: torch.Tensor) -> np.ndarray:
    """Host bits of a tensor: 16-bit floats as int16, the rest as is."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    return t.numpy()


def legacy_phase(dev, K, cfg=None, n_q_heads=16, n_seqs=LEGACY_SEQS,
                 prefill=LEGACY_PREFILL, steps=LEGACY_STEPS, twin=True):
    """Phase 3b: the legacy page-copy pool at ``cfg`` (``KVPoolConfig()``
    by default) through :func:`legacy_run`, against :class:`LegacyOracle`
    (pages bit for bit, versions, fills, evictions, every word, every hit
    mask) and, each attend, against ``paged_attention_plain`` over the
    oracle's pages on the same device (1e-4, phase 3's tolerance); then,
    with ``twin``, the same trace on a CPU pool (the plain versions):
    every pool and cache leaf and every hit mask bit-equal.  Returns the
    numbers to log (``launches``: the kernels of the run) and the
    recorded kernel calls (:func:`legacy_calls`; ``k2_last``: the last
    step's)."""
    from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool
    from repro_torch.kernels.paged_attention import paged_attention_plain
    cfg = KVPoolConfig() if cfg is None else cfg
    inp = legacy_inputs(cfg, n_seqs, prefill, steps, n_q_heads)
    oracle = LegacyOracle(cfg)
    dt = inp["k"].dtype
    orc, errs = {}, []

    def check_attend(step, q, tbl, lens, got):
        if not orc:                      # the first step: every page
            orc["k"] = torch.from_numpy(oracle.k).view(dt).to(dev)
            orc["v"] = torch.from_numpy(oracle.v).view(dt).to(dev)
        else:                            # the pages this step appended to
            idx = np.unique(tbl[:, (int(lens[0]) - 1) // cfg.page_size])
            i = torch.as_tensor(idx, device=dev)
            orc["k"][i] = torch.from_numpy(oracle.k[idx]).view(dt).to(dev)
            orc["v"][i] = torch.from_numpy(oracle.v[idx]).view(dt).to(dev)
        want = paged_attention_plain(q, orc["k"], orc["v"],
                                     torch.as_tensor(tbl, device=dev),
                                     torch.as_tensor(lens, device=dev))
        errs.append(float((got.float() - want.float()).abs().max()))
        assert errs[-1] < 1e-4, f"step {step}: attend off by {errs[-1]}"

    pool = SELCCKVPool(cfg, device=dev)
    sync(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with legacy_calls() as calls:
        def on_step(*a):
            check_attend(*a)
            calls["k2_last"], calls["k2"] = calls["k2"], []
        run = legacy_run(pool, inp, prefill, oracle, on_step)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    lp = pool.pool
    assert np.array_equal(_bits16(lp["k_pages"]), oracle.k) and \
        np.array_equal(_bits16(lp["v_pages"]), oracle.v), \
        "pages differ from the oracle"
    assert np.array_equal(lp["page_version"].cpu().numpy(),
                          oracle.version), "page versions differ"
    assert np.array_equal(lp["page_fill"].cpu().numpy(), oracle.fill), \
        "page fills differ"
    assert int(lp["append_evictions"]) == oracle.evictions > 0, \
        (int(lp["append_evictions"]), oracle.evictions)
    assert words_as_ints(lp["words"]) == oracle.words, \
        "the directory differs from the oracle's"
    if dev.type == "cuda":
        assert launches["latch_ops"] == run["appends"], launches
        assert launches["gcl_fetch"] == 2 * run["reads"], \
            f"K2 launched {launches['gcl_fetch']} times for " \
            f"{run['reads']} reads"
        assert launches["paged_attention"] == run["attends"], launches
    else:                                  # the plain versions
        assert set(launches.values()) == {0}, launches
    out = {"wall_s": wall, "appends": run["appends"],
           "rows_appended": run["rows"],
           "appends_per_s": run["appends"] / run["append_s"],
           "rows_appended_per_s": run["rows"] / run["append_s"],
           "reads": run["reads"], "pages_read": run["pages_read"],
           "reads_per_s": run["reads"] / run["read_s"],
           "pages_read_per_s": run["pages_read"] / run["read_s"],
           "hits": int(sum(h.sum() for h in run["hits"])),
           "append_evictions": oracle.evictions,
           "attends": run["attends"],
           "attend_ms": 1e3 * run["attend_s"] / run["attends"],
           "attend_max_err": max(errs),
           "launches": {k: launches[k] for k in
                        ("latch_ops", "gcl_fetch", "paged_attention")}}
    out["hit_rate"] = out["hits"] / run["pages_read"]
    if twin:
        cpu = SELCCKVPool(cfg, device="cpu")
        t0 = time.perf_counter()
        twin_run = legacy_run(cpu, inp, prefill)
        out["twin_wall_s"] = time.perf_counter() - t0
        assert all(np.array_equal(a, b) for a, b in
                   zip(run["hits"], twin_run["hits"])), \
            "a hit mask differs from the CPU twin's"
        for side in ("pool", "cache"):
            card, host = getattr(pool, side), getattr(cpu, side)
            for k in card:
                assert np.array_equal(_bits16(card[k]), _bits16(host[k])), \
                    f"{side}[{k!r}] differs from the CPU twin's"
    return out, calls


def legacy_kernel_cases(dev, K, calls):
    """K1, K2 and K3 at the legacy path's own shapes, from the calls
    :func:`legacy_phase` recorded: K1 the largest append (a prefill, R =
    every row of a replica's sequences), K2 replica 0's k fetch of the
    last step (its own pages and sequence 0's shared ones: duplicate
    requests, its reader bit), K3 the last attend.  Each exact (K3
    within 1e-4) against its plain version on the card and timed on both
    timers beside its bound and the library call (``index_select`` for
    K2, SDPA over gathered pages for K3).  Keys carry ``_legacy``."""
    from repro_torch.kernels.gcl_fetch import gcl_fetch_plain
    from repro_torch.kernels.latch_ops import latch_apply_plain, REQ_KEYS
    from repro_torch.kernels.paged_attention import paged_attention_plain
    words, req = calls["k1"]
    n, r = words.shape[0], req["line"].shape[0]
    got = K.apply_batch(words, req)
    want = latch_apply_plain(words, *[req[k] for k in REQ_KEYS])
    sync(dev)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    assert err == 0, f"latch_ops disagrees at the legacy shape ({err})"
    k1 = {"max_abs_err_legacy": float(err), "rows_legacy": r,
          "ms_legacy": graph_ms(lambda: K.apply_batch(words, req)),
          "ms_graph20_legacy": graph20_ms(lambda: K.apply_batch(words,
                                                                req)),
          "plain_ms_legacy": eager_ms(lambda: latch_apply_plain(
              words, *[req[k] for k in REQ_KEYS]), iters=3),
          "bound_ms_legacy": bound_ms(2 * n * 8 + 9 * r * 4)[0]}

    pages, words, req_page, bit_hi, bit_lo = calls["k2_last"][0]
    args = (words, req_page, bit_hi, bit_lo)
    got = K.fetch(pages, *args)
    want = gcl_fetch_plain(pages, *args)
    sync(dev)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    assert err == 0.0, f"gcl_fetch disagrees at the legacy shape ({err})"
    req_np = req_page.cpu().numpy()
    valid = req_np[req_np >= 0]
    (p, e), r = pages.shape, req_np.shape[0]
    row = e * pages.element_size()
    n_bytes = valid.size * row + r * row + 2 * p * 8 + 6 * r * 4
    idx = req_page.long().clamp(min=0)
    k2 = {"max_abs_err_legacy": err, "rows_legacy": r,
          "valid_rows_legacy": int(valid.size),
          "duplicate_rows_legacy": int(valid.size - np.unique(valid).size),
          "row_bytes_legacy": row,
          "bits_legacy": [int(bit_hi.max()), int(bit_lo.max())],
          "ms_legacy": graph_ms(lambda: K.fetch(pages, *args)),
          "ms_graph20_legacy": graph20_ms(lambda: K.fetch(pages, *args)),
          "plain_ms_legacy": eager_ms(lambda: gcl_fetch_plain(pages,
                                                              *args)),
          "bound_ms_legacy": bound_ms(n_bytes)[0],
          "library_ms_legacy": graph_ms(
              lambda: torch.index_select(pages, 0, idx)),
          "library_ms_graph20_legacy": graph20_ms(
              lambda: torch.index_select(pages, 0, idx))}
    assert k2["duplicate_rows_legacy"] > 0 and k2["bits_legacy"][1] > 0

    q, k_pages, v_pages, tbl, lens = calls["k3"]
    got = K.decode_paged(q, k_pages, v_pages, tbl, lens)
    want = paged_attention_plain(q, k_pages, v_pages, tbl, lens)
    sync(dev)
    err = float((got - want).abs().max())
    assert err < 1e-4, f"paged_attention off by {err} at the legacy shape"
    b, hq, hd = q.shape
    _, page, hkv, _ = k_pages.shape
    lens_np = lens.cpu().numpy()
    toks = int(lens_np.sum())
    n_bytes = (2 * toks * hkv * hd * k_pages.element_size()
               + 2 * b * hq * hd * q.element_size()
               + int(sum(-(-int(x) // page) for x in lens_np)) * 4 + b * 4)
    bms, by = bound_ms(n_bytes, 4.0 * hq * hd * toks)
    lib = paged_sdpa(q, k_pages, v_pages, tbl, lens)
    k3 = {"max_abs_err_legacy": err,
          "ms_legacy": graph_ms(lambda: K.decode_paged(q, k_pages, v_pages,
                                                       tbl, lens)),
          "ms_graph20_legacy": graph20_ms(lambda: K.decode_paged(
              q, k_pages, v_pages, tbl, lens)),
          "plain_ms_legacy": eager_ms(lambda: paged_attention_plain(
              q, k_pages, v_pages, tbl, lens)),
          "bound_ms_legacy": bms, "bound_by_legacy": by,
          "library_ms_legacy": graph_ms(lib),
          "library_ms_graph20_legacy": graph20_ms(lib)}
    return k1, k2, k3


# ------------------------------------- placement on the serve pool's geometry

PLACE_LINES = 1024                 # the serve pool's pages ...
PLACE_WIDTH = 16384                # ... and its page_lanes (bf16 k + v)
PLACE_NODES = 4


def placement_phase(dev, n_lines=PLACE_LINES, width=PLACE_WIDTH,
                    n_nodes=PLACE_NODES, batches=16, batch=256,
                    theta=0.99, read_frac=0.95):
    """A flat plane with a home directory and a replica plane at the
    serve pool's geometry, a ``FlightRecorder`` attached: ``batches``
    seeded batches of ``batch`` ops (zipf ``theta`` over the lines, hot
    ranks scattered, ``read_frac`` reads, random payloads), then
    ``replicate(plan_replication(...))`` over the batches' summed
    telemetry, the flat ``rehome`` refusing the 4-shard plan that
    ``plan_rehome(rec.line_heat, home, 4)`` makes and returning 0 for
    the 1-shard one, and ``batches`` more.  A twin plane without
    recorder, replicas marked or rehome serves the same trace: versions
    and payloads equal batch by batch; both keep the invariants, and
    every valid replica image equals memory."""
    from repro_torch.apps.workloads import Zipf
    from repro_torch.core.rounds import (DevicePlane, check_invariants,
                                         make_state, plan_rehome,
                                         plan_replication)
    from repro_torch.obs import FlightRecorder
    rng = np.random.default_rng(SEED + 12)
    zipf = Zipf(n_lines, theta)
    perm = rng.permutation(n_lines)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    geom = dict(payload_width=width, home_directory=True, replicas=True,
                device=dev)
    rec = FlightRecorder(4096)
    plane = DevicePlane.open(make_state(n_nodes, n_lines, **geom),
                             n_nodes=n_nodes, recorder=rec)
    twin = DevicePlane.open(make_state(n_nodes, n_lines, **geom),
                            n_nodes=n_nodes)
    hits = np.zeros(n_lines, np.int64)
    whits = np.zeros(n_lines, np.int64)
    out = {"plane_s": 0.0, "twin_s": 0.0}
    for b in range(2 * batches):
        if b == batches:
            picks = plan_replication(hits, whits, top_k=64,
                                     max_write_frac=0.1)
            assert picks.size > 0
            plane.replicate(picks)
            moves = plan_rehome(rec.line_heat, plane.state["home"], 4)
            assert moves[0].size > 0, "no move planned for 4 shards"
            # the one shard is 0: a plan naming another is refused,
            # as the reference's flat plane refuses it
            refused = None
            try:
                assert plane.rehome(*moves) == 0
            except ValueError as exc:
                refused = str(exc)
            assert (refused is not None) == bool(moves[1].max() > 0), \
                (refused, moves)
            assert plane.rehome(*plan_rehome(
                rec.line_heat, plane.state["home"], 1)) == 0
            out.update(replicated=int(picks.size),
                       rehome_moves_4_shards=int(moves[0].size),
                       rehome_lines=moves[0].tolist(),
                       rehome_to=moves[1].tolist(), rehome_refused=refused,
                       replica_ok_after_replicate=int(
                           plane.state["replica_ok"].sum()))
        node = rng.integers(0, n_nodes, batch).astype(np.int32)
        line = perm[zipf.sample_batch(rng, batch)].astype(np.int32)
        isw = (rng.random(batch) >= read_frac).astype(np.int32)
        wd = torch.empty((batch, width), dtype=torch.int32,
                         device=dev).random_(generator=g)
        t0 = time.perf_counter()
        a = plane.ops(node, line, isw, wd)
        t1 = time.perf_counter()
        z = twin.ops(node, line, isw, wd)
        out["twin_s"] += time.perf_counter() - t1
        out["plane_s"] += t1 - t0
        assert np.array_equal(a.version, z.version) and \
            np.array_equal(a.data, z.data), f"batch {b}: twin differs"
        hits += a.telemetry.line_hits
        whits += a.telemetry.line_whits
    for p in (plane, twin):
        check_invariants(p.state)
    st = plane.state
    rok = st["replica_ok"]
    assert rok.any() and torch.equal(st["replica_data"][rok],
                                     st["mem_data"][rok])
    assert rec.total == 2 * batches and all(s.compiled == 0
                                            for s in rec.spans())
    out.update(ops=2 * batches * batch, replica_ok=int(rok.sum()),
               spans=rec.total, snapshot=rec.snapshot())
    return out


# ------------------------------------------------------ the DES bridge

def example(name):
    """The port's example ``examples/torch_<name>.py`` as a module."""
    import importlib
    path = os.path.join(ROOT, "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(f"torch_{name}")


def bridge_phase(dev, width=PLACE_WIDTH, kv_cfg=None):
    """The port's ``SELCCLayer`` over the cluster of
    ``examples/quickstart.py`` (2 compute nodes, 2 memory nodes, 4
    threads, 256 cache entries), through ``examples/torch_quickstart.py``
    on ``dev``: a coherent write and read through scope guards, a
    cache-hit re-read that spends no RDMA, a B-link tree of 200 keys
    (lookups and a scan checked) with a clean teardown, and the same
    cluster's device plane serving the written line at its version; then
    ``as_plane(payload_width=width)`` on ``dev`` drives a seeded op batch
    over the layer's lines against a CPU twin (equal versions and
    payloads, invariants), and ``make_kv_pool(kv_cfg)`` opens a legacy
    pool on ``dev`` (``KVPoolConfig()`` by default) whose reads return
    what was appended."""
    from repro_torch.dsm.kvpool import KVPoolConfig
    lines = []
    seen = example("quickstart").run(dev, say=lines.append)
    layer = seen["layer"]
    log("bridge quickstart: " + json.dumps(lines))
    assert seen["read"] == seen["stored"] and seen["rdma"] == 0
    assert seen["lookup"] == 137 * 137 and seen["rpc_lookup"] == -42
    assert seen["scan"] == [(k, k * k) for k in range(50, 55)]
    assert seen["plane"].device.type == dev.type
    assert seen["plane_versions"] == (1, 1), seen["plane_versions"]
    plane = layer.as_plane(payload_width=width, device=dev)
    twin = layer.as_plane(payload_width=width, device="cpu")
    assert plane.device.type == dev.type
    rng = np.random.default_rng(SEED + 14)
    r, n = 64, layer.cfg.n_compute
    for _ in range(2):
        node = rng.integers(0, n, r).astype(np.int32)
        line = rng.integers(0, plane.n_lines, r).astype(np.int32)
        isw = (rng.random(r) < 0.3).astype(np.int32)
        wd = rng.integers(-2**31, 2**31, (r, width)).astype(np.int32)
        a, z = plane.ops(node, line, isw, wd), twin.ops(node, line, isw, wd)
        assert np.array_equal(a.version, z.version) and \
            np.array_equal(a.data, z.data)
    plane.check()
    pool = layer.make_kv_pool(kv_cfg, device=dev)
    cfg = pool.cfg
    assert pool.device.type == dev.type and pool.rounds_plane is None
    assert cfg == (KVPoolConfig() if kv_cfg is None else kv_cfg)
    page = pool.allocate(1)
    g = torch.Generator().manual_seed(SEED + 15)
    shape = (cfg.page_size, cfg.n_kv_heads, cfg.head_dim)
    k = torch.randn(shape, generator=g).to(pool.pool["k_pages"].dtype)
    v = torch.randn(shape, generator=g).to(k.dtype)
    pool.append(np.repeat(page, cfg.page_size),
                np.arange(cfg.page_size), k, v, replica=1)
    kk, vv, hit = pool.read(2, page)
    assert not hit[0] and torch.equal(kk[0].cpu().view(torch.int16),
                                      k.view(torch.int16)) \
        and torch.equal(vv[0].cpu().view(torch.int16), v.view(torch.int16))
    assert pool.read(2, page)[2][0]
    return {"des_now_s": layer.env.now,
            "rdma": layer.fabric.stats.total_rdma(),
            "cache": layer.cache_stats(), "plane_lines": plane.n_lines,
            "plane": repr(plane), "des_workers": bridge_des_workers(dev)}


def bridge_des_workers(dev, micro_width=16, plane_slots=1024):
    """The DES workers of ``apps/workloads.py`` over the port's
    ``SELCCLayer``: ``micro_worker`` (``MicroConfig`` at sharing 1.0,
    read 0.95, 200 ops a thread; 4 nodes of 4 threads), ``ycsb_worker``
    over a ``BLinkTree`` a node (zipf 0.99 over 200 000 keys, half
    inserts), ``tpcc_worker`` over a 2PL ``TxnEngine`` a node (every
    query, 4 warehouses), each with a clean teardown, and
    ``parity_worker`` over every backend of ``available_protocols()``,
    whose final images must be equal.  Then ``as_plane`` of the micro
    run's layer on ``dev`` (``micro_width`` lanes) serves two seeded
    batches of ``plane_slots`` ops against a CPU twin."""
    from repro_torch.apps import (BLinkTree, MicroConfig, TPCCConfig,
                                  TPCCTables, TxnConfig, TxnEngine,
                                  YCSBConfig, micro_worker, parity_worker,
                                  tpcc_worker, ycsb_worker)
    from repro_torch.core import (ClusterConfig, SELCCConfig, SELCCLayer,
                                  available_protocols)

    def cluster(n_compute, threads, protocol="selcc", cache=1024):
        return SELCCLayer(ClusterConfig(
            n_compute=n_compute, n_memory=2, threads_per_node=threads,
            protocol=protocol, selcc=SELCCConfig(cache_capacity=cache)))

    def run(layer, gens):
        t0 = time.perf_counter()
        layer.env.run_until_complete([layer.env.process(g) for g in gens],
                                     hard_limit=1e6)
        layer.assert_released()
        return {"des_time": layer.env.now,
                "wall_s": time.perf_counter() - t0}

    out = {}
    micro = cluster(4, 4)
    mcfg = MicroConfig(sharing_ratio=1.0, read_ratio=0.95, ops_per_thread=200)
    gcls = micro.allocate_many(mcfg.n_gcls)
    out["micro"] = run(micro, [micro_worker(nd, gcls, mcfg, nd.node_id, 4,
                                            t, SEED)
                               for nd in micro.nodes for t in range(4)])
    assert micro.total_ops() == 4 * 4 * mcfg.ops_per_thread
    out["micro"].update(ops=micro.total_ops(), cache=micro.cache_stats(),
                        inv_ratio=micro.inv_ratio())

    layer = cluster(2, 2)
    trees = [BLinkTree(layer, nd, fanout=16) for nd in layer.nodes]
    ycfg = YCSBConfig(read_ratio=0.5)
    out["ycsb"] = run(layer, [ycsb_worker(tr, ycfg, i, t, SEED)
                              for i, tr in enumerate(trees)
                              for t in range(2)])
    seen = {}

    def scan():
        seen["pairs"] = yield from trees[0].range_scan(0, ycfg.n_keys)
    run(layer, [scan()])
    keys = [k for k, _ in seen["pairs"]]
    assert keys and keys == sorted(set(keys)), "YCSB tree keys"
    assert all(v in {(i, t) for i in range(2) for t in range(2)}
               for _, v in seen["pairs"]), "YCSB tree values"
    out["ycsb"].update(keys=len(keys),
                       splits=sum(tr.stats["splits"] for tr in trees))

    layer = cluster(2, 4, cache=4096)
    tcfg = TPCCConfig(warehouses=4, txns_per_thread=20)
    tables = TPCCTables(tcfg)
    engines = [TxnEngine(layer, nd, TxnConfig(algo="2pl"), tables.n_tuples)
               for nd in layer.nodes]
    out["tpcc"] = run(layer, [tpcc_worker(e, tables, tcfg, 0, i, 2, t, SEED)
                              for i, e in enumerate(engines)
                              for t in range(4)])
    commits = sum(e.stats.commits for e in engines)
    aborts = sum(e.stats.aborts for e in engines)
    assert commits + aborts == 2 * 4 * tcfg.txns_per_thread and commits
    out["tpcc"].update(commits=commits, aborts=aborts)

    images = {}
    for protocol in available_protocols():
        layer = cluster(2, 2, protocol, cache=64)
        lines = layer.allocate_many(8)
        for g in lines:
            layer.seed_object(g, 0)
        run(layer, [parity_worker(nd, lines, rounds=2, stride=3)
                    for nd in layer.nodes])
        images[protocol] = [layer.heap.load(g) for g in lines]
    assert all(v == images["selcc"] for v in images.values()), images
    out["parity"] = images["selcc"]

    plane = micro.as_plane(payload_width=micro_width, device=dev)
    twin = micro.as_plane(payload_width=micro_width, device="cpu")
    rng = np.random.default_rng(SEED + 18)
    for _ in range(2):
        node = rng.integers(0, 4, plane_slots).astype(np.int32)
        line = rng.integers(0, plane.n_lines, plane_slots).astype(np.int32)
        isw = (rng.random(plane_slots) < 0.3).astype(np.int32)
        wd = rng.integers(-2**31, 2**31, (plane_slots, micro_width)) \
            .astype(np.int32)
        a, z = plane.ops(node, line, isw, wd), twin.ops(node, line, isw, wd)
        assert np.array_equal(a.version, z.version) and \
            np.array_equal(a.data, z.data), "micro plane differs from twin"
    plane.check()
    out["micro_plane_lines"] = plane.n_lines
    return out


# ------------------------------------------------------ phase 4: LM serve

EXAMPLE_STEPS = 20                 # torch_train_micro --tiny on the card


def examples_phase(dev, K, steps=EXAMPLE_STEPS):
    """The port's device examples on ``dev``, each to its end at its
    smoke size (the head dim the card's kernels take,
    ``configs.on_device``), each with the launch counts set to 0 just
    before it: ``torch_serve_paged`` (its engine's tokens equal its
    hand-rolled loop's, and the coherence reads the reference's),
    ``torch_train_micro --tiny`` for ``steps`` steps with its checkpoint
    in a temporary directory, and ``torch_elastic_restart`` (train,
    checkpoint, plan, restore, continue).  Finite losses; K4 and its
    backward once a layer a micro-batch (no remat at smoke size), K1
    and K2 in the pool, on the card (none on the CPU, where the phase
    is rehearsed).  Returns the record and the launches by example."""
    import contextlib
    import io

    from repro_torch.configs import get_smoke_config, on_device
    out, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="examples_")
    n_layers = on_device(get_smoke_config("qwen3-1.7b"), dev).n_layers
    runs = (
        ("serve_paged", lambda say: example("serve_paged").run(dev, say)),
        ("train_micro", lambda say: example("train_micro").main([
            "--tiny", "--steps", str(steps), "--device", dev.type,
            "--ckpt", os.path.join(tmp, "train_micro")])),
        ("elastic_restart", lambda say: example("elastic_restart").main([
            "--device", dev.type, "--ckpt", os.path.join(tmp, "elastic")])))
    try:
        for name, fn in runs:
            lines, text = [], io.StringIO()
            K.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                res = fn(lines.append)
            sync(dev)
            wall = time.perf_counter() - t0
            got = collections.Counter(K.launch_counts())
            if name == "train_micro":      # the driver counts a step at a time
                got = sum((collections.Counter(c) for c in res["launches"]),
                          collections.Counter())
            launches[name] = {k: n for k, n in got.items() if n}
            lines += text.getvalue().splitlines()
            log(f"example {name}: " + json.dumps(lines))
            card = dev.type == "cuda"
            if name == "serve_paged":
                assert res["engine_tokens"] == res["ref_tokens"]
                # the reference example's two [coherence] lines
                assert res["reads"] == [True, False, True, True, False], \
                    res["reads"]
                rec = {"reads": res["reads"],
                       "ticks": res["stats"].tick,
                       "coherence_rounds": res["stats"].rounds_total}
                for k in ("latch_ops", "gcl_fetch", "flash_attention"):
                    assert launches[name].get(k, 0) > 0 or not card, (name, k)
            else:
                if name == "train_micro":
                    losses, micro = res["losses"], [1] * len(res["losses"])
                else:
                    losses = res["healthy"] + res["continued"]
                    micro = ([res["n_micro"][0]] * len(res["healthy"])
                             + [res["n_micro"][1]] * len(res["continued"]))
                assert np.isfinite(losses).all(), (name, losses)
                per = sum(micro) * n_layers if card else 0
                want = {k: per for k in ("flash_attention",
                                         "flash_attention_bwd") if per}
                assert launches[name] == want, (name, launches[name], want)
                rec = {"losses": losses, "micro_batches": micro}
            out[name] = dict(rec, wall_s=wall, launches=launches[name])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches


def lm_serve(K, arch, requests, kernel, per_prefill, per_step=0, batch=4,
             prompt=512, gen=32, flags=()):
    """The port's ``launch.serve.main`` at the full config of ``arch``
    (with the driver's ``flags``); returns its counts, its mesh and EP
    degree and the kernels it launched.  ``kernel`` must have launched
    ``per_prefill`` times a prefill and ``per_step`` times a decode
    step, exactly."""
    from repro_torch.launch.serve import main as serve_main
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_main(["--arch", arch, "--requests", str(requests),
                      "--batch", str(batch), "--prompt-len", str(prompt),
                      "--gen", str(gen), *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    prefills = -(-requests // batch)
    assert res["finite"], f"{arch}: non-finite logits"
    assert res["tokens"] == requests * gen and \
        res["generated"].shape == (requests, gen), f"{arch}: tokens missing"
    want = (per_prefill + per_step * gen) * prefills
    assert counts[kernel] == want, \
        f"{arch}: {kernel} launched {counts[kernel]} times, expected " \
        f"({per_prefill} + {per_step} x {gen}) x {prefills} = {want}"
    return {"arch": arch, "requests": res["requests"],
            "tokens": res["tokens"], "serve_s": res["seconds"],
            "tok_per_s": res["tokens"] / res["seconds"],
            "wall_s_with_init": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "mesh": res["mesh"], "ep": res["ep"], "launches": counts}


@contextlib.contextmanager
def dispatch_calls():
    """Collects (router logits, route) of every ``moe._dispatch`` call
    into the list it yields (the tensors themselves: no copy, no
    sync)."""
    from repro_torch.models import moe
    got, real = [], moe._dispatch

    def recording(x, logits, *a):
        res = real(x, logits, *a)
        got.append((logits, res[1]))
        return res
    moe._dispatch = recording
    try:
        yield got
    finally:
        moe._dispatch = real


def _replay(dev, cfg, s, ring):
    """One prefill of ``s`` random tokens against its token-by-token
    decode replay (decode cache in the model's dtype), then ``ring``
    decode steps on the prefill's cache, each against a prefill of the
    tokens so far."""
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    params = lm.init_params(cfg, gen, dev)
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    toks = torch.randint(0, cfg.vocab, (1, s + ring), generator=gen,
                         device=dev)
    ctx = lm.NO_PARALLEL
    logits_pf, cache_pf = lm.prefill(params, {"tokens": toks[:, :s]}, cfg,
                                     ctx)
    cache = lm.init_decode_cache(cfg, 1, s, dtype=dt, device=dev)
    t0 = time.perf_counter()
    for i in range(s):
        logits_dec, cache = lm.decode_step(params, cache, toks[:, i:i + 1],
                                           cfg, ctx)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / s * 1e3
    del cache
    err = float((logits_pf - logits_dec).abs().max())
    scale = float(logits_dec.abs().max())
    out = {"dtype": cfg.dtype, "max_abs_err": err, "max_abs_logit": scale,
           "rel_err": err / scale,
           f"decode_step_ms_{cfg.n_layers}_layers": step_ms}
    ring_err = 0.0
    for i in range(ring):
        logits_dec, cache_pf = lm.decode_step(
            params, cache_pf, toks[:, s + i:s + i + 1], cfg, ctx)
        want, _ = lm.prefill(params, {"tokens": toks[:, :s + i + 1]}, cfg,
                             ctx)
        ring_err = max(ring_err, float((logits_dec - want).abs().max())
                       / float(want.abs().max()))
    if ring:
        out.update({"ring_steps": ring, "window": cfg.local_window,
                    "ring_rel_err": ring_err})
    x = torch.randn((4, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    if cfg.dtype == "bfloat16":
        out.update({"head_fp32_ms": graph_ms(
            lambda: lm._logits(params, x, cfg), iters=20),
            "head_bf16_ms": graph_ms(lambda: x @ lm._head(params, cfg),
                                     iters=20)})
    del params, cache_pf
    torch.cuda.empty_cache()
    return out


def replay_check(dev, arch, n_layers=4, s=512, ring=0):
    """Full width, ``n_layers`` layers: the last logits of a prefill (K4
    or K5) against a token-by-token replay through ``decode_step`` (plain
    decode path), compared as ``tests/test_archs_smoke.py`` does, with
    the error stated relative to max |logit|; plus the time of the fp32
    head product one decode step pays (batch 4).  With ``ring`` > 0 (the
    hybrid family), the prefill's cache then takes ``ring`` decode
    steps, each held against a prefill of the tokens so far: with S
    above the window and not a multiple of it, position p must sit at
    ring slot p % window.

    A moe config runs at the capacity factor n_experts / top_k, where
    the capacity exceeds the token count and nothing drops: at the
    published 1.25 a 512-token prefill drops assignments (deepseek-moe-
    16b: capacity 64 an expert at 512 tokens) that a one-token decode
    step (capacity 4) never drops, so the two would differ by design.
    It runs in fp32 (weights and decode cache): in bf16 the prefill's
    and the replay's router inputs differ by the rounding of two
    attention orders, every top-k choice closer than that flips, and a
    flipped token's new hidden state moves the router inputs of the
    layers above it (PERF.md, Findings)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(n_layers=n_layers)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k,
                          dtype="float32")
    res = _replay(dev, cfg, s, ring)
    out = {"arch": arch, "layers": n_layers, "prompt": s,
           "capacity_factor": cfg.capacity_factor, **res,
           "tolerance_rel": REPLAY_TOL}
    log(f"replay {arch}: " + json.dumps(out))
    err, scale = res["max_abs_err"], res["max_abs_logit"]
    assert np.isfinite(err) and err <= REPLAY_TOL * scale, \
        f"{arch}: prefill vs decode replay off by {err} (max |logit| " \
        f"{scale}, tolerance {REPLAY_TOL} x max |logit|)"
    assert res.get("ring_rel_err", 0.0) <= REPLAY_TOL, \
        f"{arch}: prefill of {s} + {ring} ring decode steps off the " \
        f"longer prefill by {res['ring_rel_err']} x max |logit| " \
        f"(tol {REPLAY_TOL})"
    return out


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


def vlm_continuation(dev, n_layers=4, s=512, steps=8):
    """llava-next-mistral-7b at full width and ``n_layers`` layers, bf16:
    a prefill of its 1152 seeded random patch embeddings (drawn at the
    token embeddings' scale, std 0.02) and ``s`` random tokens, the cache
    grown by ``launch.serve.grow_cache`` to the patches + ``s`` +
    ``steps`` slots, then ``steps`` decode steps, each held against a
    prefill of the same patches and the tokens so far (within
    ``REPLAY_TOL`` of max |logit|).  No token-by-token replay can feed
    the patches through ``decode_step``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import grow_cache, prefix_len
    from repro_torch.models import lm
    cfg = get_config("llava-next-mistral-7b").replace(n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    params = lm.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (1, s + steps), generator=gen,
                         device=dev)
    patches = (0.02 * torch.randn((1, cfg.n_patches, cfg.d_model),
                                  generator=gen, device=dev)).bfloat16()
    ctx = lm.NO_PARALLEL

    def prefill(n):
        return lm.prefill(params, {"tokens": toks[:, :n],
                                   "patch_embeds": patches}, cfg, ctx)
    _, cache = prefill(s)
    assert cache["pos"].tolist() == [cfg.n_patches + s]
    cache = grow_cache(cfg, cache, prefix_len(cfg) + s + steps)
    worst = 0.0
    for i in range(steps):
        logits, cache = lm.decode_step(params, cache,
                                       toks[:, s + i:s + i + 1], cfg, ctx)
        worst = max(worst, _rel_err(logits, prefill(s + i + 1)[0]))
    out = {"arch": cfg.name, "layers": n_layers, "patches": cfg.n_patches,
           "prompt": s, "steps": steps, "rel_err": worst,
           "tolerance_rel": REPLAY_TOL}
    log("continuation llava-next-mistral-7b: " + json.dumps(out))
    assert np.isfinite(worst) and worst <= REPLAY_TOL, \
        f"llava: decode after patches + {s} tokens off the longer " \
        f"prefills by {worst} x max |logit| (tol {REPLAY_TOL})"
    del params, cache
    torch.cuda.empty_cache()
    return out


def encdec_replay(dev, s=512, frames=128, steps=8):
    """seamless-m4t-medium at full width and depth, bf16, over
    ``frames`` seeded random frame embeddings: the last logits of a
    prefill of ``s`` random tokens against a token-by-token
    ``decode_step`` replay from a cache whose ``cross_k`` and ``cross_v``
    are the prefill's (the decoder's self-attention cache in bf16); then
    the prefill's cache grown by ``launch.serve.grow_cache`` (cross
    leaves kept) takes ``steps`` decode steps, each held against a
    prefill of the tokens so far over the same frames.  Both within
    ``REPLAY_TOL`` of max |logit|."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import lm
    cfg = get_config("seamless-m4t-medium")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    params = lm.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (1, s + steps), generator=gen,
                         device=dev)
    enc = torch.randn((1, frames, cfg.d_model), generator=gen,
                      device=dev).bfloat16()
    ctx = lm.NO_PARALLEL

    def prefill(n):
        return lm.prefill(params, {"tokens": toks[:, :n],
                                   "enc_embeds": enc}, cfg, ctx)
    logits_pf, cache_pf = prefill(s)
    cache = lm.init_decode_cache(cfg, 1, s, device=dev)
    cache["cross_k"], cache["cross_v"] = cache_pf["cross_k"], \
        cache_pf["cross_v"]
    t0 = time.perf_counter()
    for i in range(s):
        logits, cache = lm.decode_step(params, cache, toks[:, i:i + 1], cfg,
                                       ctx)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / s * 1e3
    replay_err = _rel_err(logits, logits_pf)
    del cache
    cache = grow_cache(cfg, cache_pf, s + steps)
    assert cache["cross_k"].shape[2] == frames
    worst = 0.0
    for i in range(steps):
        logits, cache = lm.decode_step(params, cache,
                                       toks[:, s + i:s + i + 1], cfg, ctx)
        worst = max(worst, _rel_err(logits, prefill(s + i + 1)[0]))
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "enc_layers": cfg.n_enc_layers, "frames": frames, "prompt": s,
           "replay_rel_err": replay_err, "steps": steps,
           "continuation_rel_err": worst, "decode_step_ms": step_ms,
           "tolerance_rel": REPLAY_TOL}
    log("replay seamless-m4t-medium: " + json.dumps(out))
    assert np.isfinite(replay_err) and replay_err <= REPLAY_TOL, \
        f"seamless: prefill vs decode replay off by {replay_err} x max " \
        f"|logit| (tol {REPLAY_TOL})"
    assert np.isfinite(worst) and worst <= REPLAY_TOL, \
        f"seamless: decode on the grown cache off the longer prefills by " \
        f"{worst} x max |logit| (tol {REPLAY_TOL})"
    del params, cache, cache_pf
    torch.cuda.empty_cache()
    return out


def moe_card_check(dev, n_tokens=2048, mesh=None):
    """``moe_ffn`` of one deepseek-moe-16b layer at full width
    (``src/repro/configs/deepseek_moe_16b.py``: d 2048, 64 routed experts
    of 1408, top 6, 2 shared) on ``n_tokens`` bf16 tokens that share a
    common direction, so the router crowds some experts past the
    published capacity (1.25: 244 slots) and assignments drop; against
    an independent reference: a per-token loop that ranks the fp32
    gates (the same router product, stable order), takes each
    assignment's slot from a running count per expert and drops it past
    the capacity, then applies every kept assignment in fp32 (per
    expert, over its kept tokens) with the shared experts.  With a
    ``mesh`` (expert parallelism over its model axis), the tokens are
    one row, so each model shard holds ``n_tokens / ep`` consecutive
    tokens: the reference loop runs once per shard, on the shard's
    tokens, with the capacity of the shard's count (16 slots on the
    production mesh's 16 shards).  The drop sets must be equal, shard by
    shard; the output within 2e-2 of the reference's scale (bf16
    operands and a bf16 rounding of every product in the model's
    path).  Over ranks (a mesh with a process group) each rank draws
    the same layer and keeps its experts, checks its shards' drop sets,
    and adds its experts' share of the reference; an ``all_reduce`` sums
    the shares."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import make_ctx
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    ranked = mesh is not None and mesh.ranked
    lo, hi = 0, cfg.n_experts
    if ranked:
        per = cfg.n_experts // mesh.world
        lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    p = moe.init_moe(gen, cfg, torch.bfloat16,
                     experts=(lo, hi) if ranked else None)
    d, k, n_exp = cfg.d_model, cfg.top_k, cfg.n_experts
    x = (torch.randn((1, n_tokens, d), generator=gen, device=dev)
         + 1.5 * torch.randn((d,), generator=gen, device=dev)).bfloat16()
    ctx = None if mesh is None else make_ctx(mesh, cfg)
    shards = 1
    if ctx is not None:
        nb, shards, _ = moe.ep_layout(x.shape, ctx)
        assert nb == 1 and shards == ctx.ep, (nb, shards, ctx.ep)
    t_l = n_tokens // shards
    with dispatch_calls() as calls:
        t0 = time.perf_counter()
        y, _ = moe.moe_ffn(x, p, cfg, ctx)
        torch.cuda.synchronize()
        port_s = time.perf_counter() - t0
    keep = calls[0][1][4]
    cap = moe._capacity(t_l, k, n_exp, cfg.capacity_factor)
    xt = x.reshape(n_tokens, d)
    gates = torch.softmax(xt.float() @ p["router"].float(), -1).cpu().numpy()
    kept = {e: ([], []) for e in range(n_exp)}       # tokens, weights
    ref_keep = np.zeros((n_tokens, k), bool)
    over = 0
    for g in range(shards):
        count = np.zeros(n_exp, np.int64)
        for t in range(g * t_l, (g + 1) * t_l):
            order = np.argsort(-gates[t], kind="stable")[:k]
            w = gates[t][order] / max(float(gates[t][order].sum()), 1e-9)
            for j, e in enumerate(order):
                if count[e] < cap:
                    kept[int(e)][0].append(t)
                    kept[int(e)][1].append(float(w[j]))
                    ref_keep[t, j] = True
                count[e] += 1
        over += int((count > cap).sum())
    mine = range(shards)
    if ranked:                  # this rank's model shards' routes only
        n_l = shards // mesh.world
        mine = range(mesh.rank * n_l, (mesh.rank + 1) * n_l)
    port_keep = np.zeros((n_tokens, k), bool)
    port_keep[mine[0] * t_l:(mine[-1] + 1) * t_l] = \
        keep.cpu().numpy().reshape(-1, k)
    for g in mine:
        sl = slice(g * t_l, (g + 1) * t_l)
        assert np.array_equal(port_keep[sl], ref_keep[sl]), \
            f"shard {g}: moe_ffn drops {int((~port_keep[sl]).sum())} " \
            f"assignments, the reference {int((~ref_keep[sl]).sum())}; " \
            f"they differ at {int((port_keep[sl] != ref_keep[sl]).sum())}"
    xf = xt.float()
    want = torch.zeros((n_tokens, d), device=dev)
    for e, (tok, w) in kept.items():
        if not tok or not lo <= e < hi:
            continue
        idx = torch.tensor(tok, device=dev)
        xe = xf[idx]
        h = torch.nn.functional.silu(xe @ p["we_g"][e - lo].float()) \
            * (xe @ p["we_u"][e - lo].float())
        want.index_add_(0, idx, (h @ p["we_d"][e - lo].float())
                        * torch.tensor(w, device=dev)[:, None])
    if not ranked or mesh.rank == 0:
        sh = torch.nn.functional.silu(xf @ p["s_wg"].float()) \
            * (xf @ p["s_wu"].float())
        want += sh @ p["s_wd"].float()
    if ranked:
        mesh.all_reduce(want)
    err = float((y.reshape(n_tokens, d).float() - want).abs().max())
    scale = float(want.abs().max())
    out = {"tokens": n_tokens, "shards": shards, "capacity": cap,
           "flat_capacity": moe._capacity(n_tokens, k, n_exp,
                                          cfg.capacity_factor),
           "dropped": int((~ref_keep).sum()),
           "experts_over_capacity": over,
           "max_abs_err": err, "scale": scale, "rel_err": err / scale,
           "tolerance_rel": 2e-2, "port_s": port_s,
           "shards_checked_here": len(mine)}
    if ranked:
        out["rank"] = mesh.rank
    else:
        log(("moe_ffn EP card check: " if shards > 1 else
             "moe_ffn card check: ") + json.dumps(out))
    assert out["dropped"] > 0, "the check's tokens overflowed no expert"
    assert np.isfinite(err) and err <= 2e-2 * scale, \
        f"moe_ffn off the fp32 reference by {err} (scale {scale}, " \
        f"tolerance 2e-2 of it)"
    del p
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- phase 5: B-tree

BTREE_NODES = 4                    # benchmarks/fig10_btree_rounds.py:56-61
BTREE_FANOUT = 16                  # W = 40 lanes: 160-byte rows
BTREE_LINES = 1 << 21
BTREE_KEYS = 1 << 24
BTREE_FILL = 12                    # keys a leaf: 75 % of fanout 16
YCSB_THETA = 0.99                  # YCSB's default zipf constant


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def rounds_run() -> int:
    """Coherence rounds executed so far (the engine counts each round
    under its shape key)."""
    from repro_torch.core.rounds.engine import TRACE_COUNTS
    return sum(n for k, n in TRACE_COUNTS.items() if k[0] == "round")


def btree_image(n_keys, n_lines, fanout=BTREE_FANOUT, fill=BTREE_FILL):
    """The payload image ``[n_lines, W]`` of a B-link tree over keys
    ``0 .. n_keys-1`` with values ``key * 7 + 1``, in the port's
    ``NodeCodec`` layout, built bottom up in numpy: leaves of ``fill``
    keys (spread evenly, so none is short), internal nodes of ``fill +
    1`` children, each level chained by right links with high keys, and
    line 0 the tree's metadata.  Returns ``(image, root, height, top)``."""
    from repro_torch.index.codec import (HAS_HIGH, HIGH, KEYS_OFF, LEAF,
                                         NKEYS, RIGHT, NodeCodec)
    from repro_torch.index.tree import (M_FANOUT, M_HEIGHT, M_MAGIC,
                                        M_ROOT, M_TOP, META_MAGIC)
    codec = NodeCodec(fanout)
    img = np.zeros((n_lines, codec.width), np.int32)
    # entries of the level being built: (min key, value or child line)
    mins = np.arange(n_keys, dtype=np.int64)
    ents = mins * 7 + 1
    top, height, per, leaf = 1, 0, fill, True
    while True:
        m = -(-len(mins) // per)
        counts = len(mins) // m + (np.arange(m) < len(mins) % m)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lines = top + np.arange(m)
        assert lines[-1] < n_lines, "the tree does not fit the plane"
        rows = img[lines[0]:lines[-1] + 1]
        slot = np.arange(per)
        ok = slot[None, :] < counts[:, None]
        at = np.minimum(start[:, None] + slot[None, :], len(mins) - 1)
        rows[:, LEAF] = int(leaf)
        rows[:, RIGHT] = np.append(lines[1:], -1)
        rows[:-1, HAS_HIGH] = 1
        rows[:-1, HIGH] = mins[start[1:]]
        if leaf:
            rows[:, NKEYS] = counts
            rows[:, KEYS_OFF:KEYS_OFF + per] = np.where(ok, mins[at], 0)
            rows[:, codec.vals_off:codec.vals_off + per] = \
                np.where(ok, ents[at], 0)
        else:                          # keys: the mins of children 1..
            rows[:, NKEYS] = counts - 1
            kat = np.minimum(at + 1, len(mins) - 1)
            rows[:, KEYS_OFF:KEYS_OFF + per - 1] = np.where(
                ok[:, 1:], mins[kat[:, :-1]], 0)
            rows[:, codec.vals_off:codec.vals_off + per] = \
                np.where(ok, ents[at], 0)
        top += m
        height += 1
        if m == 1:
            break
        mins, ents = mins[start], lines.astype(np.int64)
        per, leaf = fill + 1, False
    root = int(lines[0])
    img[0, [M_MAGIC, M_ROOT, M_FANOUT, M_HEIGHT, M_TOP]] = \
        [META_MAGIC, root, fanout, height, top]
    return img, root, height, top


def load_btree(dev, n_keys=BTREE_KEYS, n_lines=BTREE_LINES, mesh=None):
    """:func:`btree_image` carried onto ``dev`` as round state (a
    ``make_state``-shaped dict of numpy leaves through
    ``convert.to_torch``; striped over ``mesh`` when one is given),
    adopted by ``DeviceBTree.open``.  Returns the tree and the oracle:
    ``value[key]`` for every key."""
    from repro_torch import convert
    from repro_torch.core.rounds import make_state
    from repro_torch.index import DeviceBTree
    img, root, height, top = btree_image(n_keys, n_lines)
    n, w = BTREE_NODES, img.shape[1]
    state = {"words": np.zeros((n_lines, 2), np.int32),
             "cache_state": np.zeros((n, n_lines), np.int8),
             "cache_version": np.zeros((n, n_lines), np.int32),
             "mem_version": np.zeros(n_lines, np.int32),
             "mem_data": img,
             "cache_data": np.zeros((n, n_lines, w), np.int32)}
    like = convert.to_numpy(make_state(n, 2, payload_width=w, device="cpu"))
    assert {k: (v.dtype, v.ndim) for k, v in like.items()} == \
        {k: (v.dtype, v.ndim) for k, v in state.items()}, \
        "the loaded state's leaves differ from make_state's"
    state = convert.to_torch(state, dev)
    if mesh is not None:
        from repro_torch.core.rounds import shard_state
        state = shard_state(state, mesh)
    tree = DeviceBTree.open(state, mesh=mesh, n_nodes=n)
    assert (tree.root, tree.height, tree.alloc.top) == (root, height, top)
    return tree, np.arange(n_keys, dtype=np.int64) * 7 + 1


def run_ycsb(tree, oracle, batches, n_nodes=BTREE_NODES):
    """One YCSB batch after another, the nodes taking turns: each
    batch's lookups (checked against ``oracle`` before the batch's
    writes), then its upserts (``oracle`` updated in slot order: the
    last write of a key wins, as the tree's per-leaf steps apply them).
    Returns walls, counts and rounds."""
    out = {"lookups": 0, "upserts": 0, "lookup_s": 0.0, "upsert_s": 0.0,
           "batch_s": [], "rounds": []}
    for i, (keys, is_read, vals) in enumerate(batches):
        node = i % n_nodes
        r0, t0 = rounds_run(), time.perf_counter()
        if is_read.any():
            got, found = tree.lookup_batch(keys[is_read], node=node)
            out["lookup_s"] += time.perf_counter() - t0
            want_found = keys[is_read] < len(oracle)
            assert np.array_equal(found, want_found), "lookup found flags"
            assert np.array_equal(
                got[found], oracle[keys[is_read][found]]), "lookup values"
            out["lookups"] += int(is_read.sum())
        t1 = time.perf_counter()
        if (~is_read).any():
            tree.insert_batch(keys[~is_read], vals[~is_read], node=node)
            out["upsert_s"] += time.perf_counter() - t1
            for k, v in zip(keys[~is_read], vals[~is_read]):
                oracle[k] = v
            out["upserts"] += int((~is_read).sum())
        out["batch_s"].append(time.perf_counter() - t0)
        out["rounds"].append(rounds_run() - r0)
    return out


def check_upserts(tree, oracle, batches, slots):
    """Reads back every key the YCSB A ``batches`` upserted, in lookups
    of at most ``slots`` keys with the nodes in turn, and holds each
    value to ``oracle``; returns the count of keys read back."""
    keys = np.unique(np.concatenate([k[~r] for k, r, _ in batches]))
    for i in range(0, len(keys), slots):
        part = keys[i:i + slots]
        got, found = tree.lookup_batch(part,
                                       node=i // slots % BTREE_NODES)
        assert found.all(), "an upserted key is missing"
        assert np.array_equal(got, oracle[part]), \
            "an upserted key reads back another value"
    return len(keys)


def btree_phase(dev, n_keys=BTREE_KEYS, n_lines=BTREE_LINES, slots=1024,
                c_batches=16, a_batches=4, scan_keys=64, scan_count=100,
                split_keys=4096, split_batch=64, split_lines=1 << 16):
    """Phase 5: the B-link tree at full scale.  Loads ``n_keys`` keys
    (:func:`load_btree`), runs YCSB C (lookups) and A (half upserts of
    existing keys) in batches of ``slots``, zipf 0.99, and one YCSB E
    ``scan_batch`` of ``scan_keys`` starts of up to ``scan_count`` pairs,
    each result checked against the oracle, every upserted key read back
    (:func:`check_upserts`) and the loaded plane's coherence invariants
    held (``rounds.check_invariants``); then a split-heavy pass:
    ``split_keys`` uniform keys in batches of ``split_batch`` into a
    fresh tree, ``items()`` and ``check_invariants()`` held against a
    dict."""
    from repro_torch.apps import BTreeBatchConfig, btree_kv_batches
    from repro_torch.core import rounds
    from repro_torch.index import DeviceBTree
    t0 = time.perf_counter()
    tree, oracle = load_btree(dev, n_keys, n_lines)
    sync(dev)
    res = {"keys": n_keys, "lines": n_lines, "lines_used": tree.alloc.top,
           "height": tree.height, "load_s": time.perf_counter() - t0}
    for name, ratio, iters, seed in (("c", 1.0, c_batches, SEED + 9),
                                     ("a", 0.5, a_batches, SEED + 10)):
        batches = btree_kv_batches(BTreeBatchConfig(
            n_keys=n_keys, r_slots=slots, read_ratio=ratio,
            zipf_theta=YCSB_THETA, iters=iters), seed=seed)
        out = run_ycsb(tree, oracle, batches)
        if name == "a":
            res["upserted_keys_checked"] = check_upserts(
                tree, oracle, batches, slots)
        res[f"ycsb_{name}"] = {
            "batches": iters, "batch_s": out["batch_s"],
            "rounds_per_batch": out["rounds"],
            "lookups_per_s": out["lookups"] / max(out["lookup_s"], 1e-9),
            "upserts_per_s": (out["upserts"] / out["upsert_s"]
                              if out["upserts"] else None),
            "lookups": out["lookups"], "upserts": out["upserts"]}
    starts = btree_kv_batches(BTreeBatchConfig(
        n_keys=n_keys, r_slots=scan_keys, read_ratio=1.0,
        zipf_theta=YCSB_THETA, iters=1), seed=SEED + 11)[0][0]
    r0, t1 = rounds_run(), time.perf_counter()
    scans = tree.scan_batch(starts, scan_count, node=1)
    res["ycsb_e"] = {"scans": scan_keys, "count": scan_count,
                     "wall_s": time.perf_counter() - t1,
                     "rounds": rounds_run() - r0,
                     "pairs": sum(len(x) for x in scans)}
    for k0, got in zip(starts, scans):
        ks = np.arange(k0, min(k0 + scan_count, n_keys))
        assert got == list(zip(ks.tolist(), oracle[ks].tolist())), \
            f"scan from {k0} differs from the oracle"
    t1 = time.perf_counter()
    rounds.check_invariants(tree.state)
    res["plane_check_s"] = time.perf_counter() - t1
    # the split-heavy pass: the bench's N_KEYS and R_SLOTS, fresh tree
    rng = np.random.default_rng(SEED + 12)
    keys = rng.permutation(split_keys).astype(np.int32)
    vals = rng.integers(1, 1 << 20, split_keys).astype(np.int32)
    small = DeviceBTree.create(BTREE_NODES, split_lines,
                               fanout=BTREE_FANOUT, device=dev)
    r0, t1 = rounds_run(), time.perf_counter()
    for i in range(0, split_keys, split_batch):
        small.insert_batch(keys[i:i + split_batch], vals[i:i + split_batch],
                           node=(i // split_batch) % BTREE_NODES)
    sync(dev)
    res["splits"] = {"keys": split_keys, "batch": split_batch,
                     "wall_s": time.perf_counter() - t1,
                     "rounds": rounds_run() - r0,
                     "splits": small.stats["splits"],
                     "height": small.height}
    assert small.items() == sorted(zip(keys.tolist(), vals.tolist())), \
        "split pass: items() differ from the dict"
    small.check_invariants()
    res["wall_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------- phase 6: transactions

TXN_GCLS = 1 << 20                 # fig11_tpcc_rounds.py:45-50, n_gcls up
TXN_TUPLES = 8                     # W = 18 lanes: 72-byte rows
TXN_LINES_MAX = 4
TXN_THETA = 0.6
TXN_NODES = 4


def replay_txn(image, sets, ts, algo, tuples):
    """One txn applied to ``image`` [GCLs, W] the way the host engine runs
    it, serially: 2PL commits and bumps each written GCL's counter; TO
    checks each tuple in ascending order (a write needs ts >= rts and
    ts >= wts and sets wts; a read needs ts >= wts and raises rts) and
    aborts at the first failure, keeping the updates made before it.
    ``sets`` is the txn's ``(reads, writes)`` as generated.  Returns the
    decision."""
    reads, writes = sets
    wset = set(writes)
    if algo == "2pl":
        for g in sorted({t // tuples for t in wset}):
            image[g, 1] += 1
        return True
    for t in sorted(set(reads) | wset):
        g, s = divmod(t, tuples)
        rts, wts = image[g, 2 + 2 * s], image[g, 3 + 2 * s]
        if t in wset:
            if ts < rts or ts < wts:
                return False
            image[g, 3 + 2 * s] = ts
        else:
            if ts < wts:
                return False
            image[g, 2 + 2 * s] = max(rts, ts)
    return True


def txn_phase(dev, n_gcls=TXN_GCLS, batch=1024, n_batches=8):
    """Phase 6: device transactions at full scale, 2PL no-wait and then
    TO, each on a fresh plane of ``n_gcls`` GCLs: ``n_batches`` batches
    of ``batch`` txns from ``device_txn_batches`` (zipf 0.6, at most 4
    lines a txn, 4 nodes).  Each batch's decisions are held against a
    serial numpy replay of the generated txns (which the engine must not
    trim) in the device's completion order (exec_step, slot), and the
    final tuple image against the replay's."""
    from repro_torch.apps import (DeviceTxnConfig, DeviceTxnEngine,
                                  TxnBatchConfig, device_txn_batches)
    from repro_torch.core.rounds import (DevicePlane, make_state,
                                         txn_payload_width)
    w = txn_payload_width(TXN_TUPLES)
    res = {"gcls": n_gcls, "tuples": n_gcls * TXN_TUPLES, "batch": batch}
    for algo, seed in (("2pl", SEED + 13), ("to", SEED + 14)):
        batches = device_txn_batches(TxnBatchConfig(
            n_gcls=n_gcls, tuples_per_gcl=TXN_TUPLES, batch=batch,
            iters=n_batches, max_group_lines=TXN_LINES_MAX,
            zipf_theta=TXN_THETA, n_nodes=TXN_NODES), seed=seed)
        eng = DeviceTxnEngine(
            DevicePlane.open(make_state(TXN_NODES, n_gcls, payload_width=w,
                                        device=dev)),
            DeviceTxnConfig(algo=algo, tuples_per_gcl=TXN_TUPLES,
                            max_group_lines=TXN_LINES_MAX))
        image = np.zeros((n_gcls, w), np.int32)
        out = {"batch_s": [], "iters": [], "rounds": [], "retries": 0}
        for txns, node, ts in batches:
            t0 = time.perf_counter()
            r, eff = eng.run_batch(node, txns, ts=ts)
            out["batch_s"].append(time.perf_counter() - t0)
            out["iters"].append(r.iters)
            out["rounds"].append(r.rounds)
            out["retries"] += int(r.retries.sum())
            order = sorted(range(len(txns)),
                           key=lambda i: (int(r.exec_step[i]), i))
            sets = [(sorted(set(rd)), sorted(set(wr))) for rd, wr in txns]
            assert list(eff) == sets, \
                f"{algo}: the engine's encoded sets differ from the txns"
            for i in order:
                want = replay_txn(image, sets[i], int(ts[i]), algo,
                                  TXN_TUPLES)
                assert bool(r.decision[i]) == want, \
                    f"{algo}: txn {i} decided {bool(r.decision[i])}"
        final = eng.plane.state["mem_data"].cpu().numpy()
        assert np.array_equal(final, image), \
            f"{algo}: the final tuple image differs from the replay"
        eng.plane.check()
        st = eng.stats
        out.update({"commits": st.commits,
                    "commits_per_s": st.commits / sum(out["batch_s"]),
                    "aborts_by_reason": dict(st.abort_reasons)})
        res[algo] = out
        del eng
    return res


# ------------------------------------- phase 6b: the DES as the oracle

def des_layer(algo, n_gcls, n_memory=1, threads=4):
    """A fresh DES cluster of :data:`TXN_NODES` compute nodes with one
    ``TxnEngine`` a node over ``n_gcls`` GCLs of :data:`TXN_TUPLES`
    tuples.  One memory node by default: the host engine latches GCLs in
    sorted ``(node_id, offset)`` order and the device in ascending line
    order, which coincide only then, and TO keeps the updates it made
    before it aborts, so the order decides which tuples they land in."""
    from repro_torch.apps import TxnConfig, TxnEngine
    from repro_torch.core import ClusterConfig, SELCCLayer
    layer = SELCCLayer(ClusterConfig(n_compute=TXN_NODES, n_memory=n_memory,
                                     threads_per_node=threads))
    return layer, [TxnEngine(layer, nd, TxnConfig(
        algo=algo, tuples_per_gcl=TXN_TUPLES), n_gcls * TXN_TUPLES)
        for nd in layer.nodes]


@contextlib.contextmanager
def collector_paused():
    """The cyclic garbage collector off inside the block, one collection
    after it.  A DES cluster at 2^20 GCLs holds a million ``GAddr``s and
    seed records; the collector, run over them again and again while
    they are made and while the DES runs, took 60 % of the set-up."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def des_run_one(layer, engine, sets, ts):
    """One txn through the DES engine, alone, with its client ts."""
    out = {}

    def one():
        out["ok"] = yield from engine.run(*sets, ts=ts)
    layer.env.run_until_complete([layer.env.process(one())])
    return out["ok"]


def des_txn_oracle(dev, n_gcls=TXN_GCLS, batch=1024, n_batches=2,
                   sharded_batches=1):
    """The reference's oracle of the device engine (``tests/
    test_txn_device.py``): a fresh ``DeviceTxnEngine`` at phase 6's
    geometry runs ``n_batches`` batches (``sharded_batches`` on a
    :data:`SHARDS`-shard plane) under 2PL and TO, from phase 6's seeds,
    so its batches are phase 6's first ones; each run is held by
    :func:`oracle_run`."""
    from repro_torch.core.rounds import (DevicePlane, Mesh,
                                         make_sharded_state, make_state,
                                         txn_payload_width)
    w = txn_payload_width(TXN_TUPLES)
    mesh = Mesh(SHARDS, device=dev)
    res = {"gcls": n_gcls, "batch": batch}
    t_all = time.perf_counter()
    for plane_name, iters in (("flat", n_batches),
                              ("sharded", sharded_batches)):
        res[plane_name] = {}
        for algo, seed in (("2pl", SEED + 13), ("to", SEED + 14)):
            if plane_name == "flat":
                plane = DevicePlane.open(make_state(
                    TXN_NODES, n_gcls, payload_width=w, device=dev))
            else:
                plane = DevicePlane.open(make_sharded_state(
                    TXN_NODES, n_gcls, mesh, payload_width=w), mesh)
            with collector_paused():
                res[plane_name][algo] = oracle_run(
                    plane, algo, seed, iters, n_gcls, batch,
                    f"{plane_name} {algo}")
            del plane
    res["wall_s"] = time.perf_counter() - t_all
    return res


def oracle_run(plane, algo, seed, iters, n_gcls, batch, label):
    """``iters`` batches of ``batch`` txns through a ``DeviceTxnEngine``
    on ``plane``, each replayed by the port's DES ``TxnEngine``
    (:func:`des_layer`) one txn at a time in the device's ``(exec_step,
    slot)`` order with the client ts injected, and by :func:`replay_txn`
    beside it: every decision equal.  Then the image: the GCLs the
    batches touched, read back through the plane (protocol-fresh), equal
    the DES records rendered by ``host_record_lanes`` and the numpy
    replay's rows; every other line equals its seed on the card (zeros),
    in the DES heap (``{"writes": 0}``) and in the numpy image."""
    from repro_torch.apps import (DeviceTxnConfig, DeviceTxnEngine,
                                  TxnBatchConfig, device_txn_batches,
                                  host_record_lanes)
    t0 = time.perf_counter()
    eng = DeviceTxnEngine(plane, DeviceTxnConfig(
        algo=algo, tuples_per_gcl=TXN_TUPLES, max_group_lines=TXN_LINES_MAX))
    layer, engines = des_layer(algo, n_gcls)
    image = np.zeros((n_gcls, plane.payload_width), np.int32)
    out = {"des_setup_s": time.perf_counter() - t0, "card_s": 0.0,
           "replay_s": 0.0, "txns": 0, "commits": 0, "aborts": 0,
           "retries": 0}
    touched = set()
    for txns, node, ts in device_txn_batches(TxnBatchConfig(
            n_gcls=n_gcls, tuples_per_gcl=TXN_TUPLES, batch=batch,
            iters=iters, max_group_lines=TXN_LINES_MAX,
            zipf_theta=TXN_THETA, n_nodes=TXN_NODES), seed=seed):
        t1 = time.perf_counter()
        r, eff = eng.run_batch(node, txns, ts=ts)
        t2 = time.perf_counter()
        out["card_s"] += t2 - t1
        assert len(eff) == len(r.decision) == len(txns)
        for i in sorted(range(len(txns)),
                        key=lambda i: (int(r.exec_step[i]), i)):
            got = bool(r.decision[i])
            des = des_run_one(layer, engines[int(node[i])], eff[i],
                              int(ts[i]))
            assert des == got, \
                f"{label}: txn {i} decided {got}, the DES {des}"
            assert replay_txn(image, eff[i], int(ts[i]), algo,
                              TXN_TUPLES) == got, \
                f"{label}: replay_txn differs at {i}"
            touched.update(t // TXN_TUPLES for t in eff[i][0] + eff[i][1])
        out["replay_s"] += time.perf_counter() - t2
        out["txns"] += len(txns)
        out["commits"] += int(r.decision.sum())
        out["aborts"] += int((~r.decision).sum())
        out["retries"] += int(r.retries.sum())
    layer.assert_released()
    t3 = time.perf_counter()
    lines = np.array(sorted(touched), np.int32)
    gcls, heap = engines[0].gcls, layer.heap
    des_img = np.stack([host_record_lanes(heap.load(gcls[g]), g, TXN_TUPLES)
                        for g in lines.tolist()])
    back = plane.ops(np.zeros_like(lines), lines, np.zeros_like(lines)).data
    assert np.array_equal(back, des_img), \
        f"{label}: the card's image differs from the DES"
    assert np.array_equal(image[lines], des_img), \
        f"{label}: replay_txn's image differs from the DES"
    rest = np.ones(n_gcls, bool)
    rest[lines] = False
    mem = plane.flat_state()["mem_data"]
    assert not mem[torch.from_numpy(rest).to(mem.device)].any(), \
        f"{label}: an untouched line left its seed"
    assert not image[rest].any()
    seed_rec = {"writes": 0}
    assert all(heap.load(gcls[g]) == seed_rec
               for g in np.flatnonzero(rest).tolist()), \
        f"{label}: the DES moved an untouched line"
    plane.check()
    out.update(lines_checked=len(lines), image_s=time.perf_counter() - t3,
               commits_per_s=out["commits"] / out["card_s"],
               des_now=layer.env.now,
               aborts_by_reason=dict(eng.stats.abort_reasons))
    return out


def des_fig11_cell(n_gcls=TXN_GCLS, batch=1024, n_batches=2):
    """``benchmarks/fig11_tpcc_rounds.py``'s host cell (``_des_cell``):
    the oracle's batches (2PL's seed for OCC, which only the DES runs)
    submitted all at once, a batch at a time, to a DES cluster of
    :data:`TXN_NODES` compute nodes, 2 memory nodes and 8 threads a
    node, each txn on its node's ``TxnEngine`` with its client ts.
    Every txn commits or aborts.  Returns commits, aborts by reason and
    the simulated time (DES units, not seconds) per algorithm."""
    from repro_torch.apps import TxnBatchConfig, device_txn_batches
    res = {"gcls": n_gcls, "batch": batch, "batches": n_batches}
    for algo, seed in (("2pl", SEED + 13), ("to", SEED + 14),
                       ("occ", SEED + 13)):
        with collector_paused():
            t0 = time.perf_counter()
            layer, engines = des_layer(algo, n_gcls, n_memory=2, threads=8)
            t1 = time.perf_counter()
            for txns, node, ts in device_txn_batches(TxnBatchConfig(
                    n_gcls=n_gcls, tuples_per_gcl=TXN_TUPLES, batch=batch,
                    iters=n_batches, max_group_lines=TXN_LINES_MAX,
                    zipf_theta=TXN_THETA, n_nodes=TXN_NODES), seed=seed):
                procs = [layer.env.process(engines[int(node[i])].run(
                    txns[i][0], txns[i][1], ts=int(ts[i])))
                    for i in range(len(txns))]
                layer.env.run_until_complete(procs, hard_limit=1e9)
            layer.assert_released()
            commits = sum(e.stats.commits for e in engines)
            aborts = sum(e.stats.aborts for e in engines)
            assert commits + aborts == n_batches * batch, \
                f"DES {algo}: {commits} + {aborts} != {n_batches * batch}"
            reasons = collections.Counter()
            for e in engines:
                reasons.update(e.stats.abort_reasons)
            res[algo] = {"commits": commits, "aborts": aborts,
                         "aborts_by_reason": dict(reasons),
                         "des_time": layer.env.now, "setup_s": t1 - t0,
                         "run_s": time.perf_counter() - t1}
            del layer, engines
    return res


# ------------------------------------ phase 6c: Fig. 7's rounds workload

FIG7_NODES = 8                     # benchmarks/fig7_rounds.py:36-44
FIG7_READ = 0.3
FIG7_THETA = 1.1
FIG7_MAX_ROUNDS = 128
FIG7_SEED = 7
# (lines, R, payload width, write-back): the bench's own 1024 lines and
# R 64, then 2^20 lines and R 1024, each write-through and write-back,
# and one payload-plane run
FIG7_RUNS = ((1024, 64, 0, False), (1024, 64, 0, True),
             (1 << 20, 1024, 0, False), (1 << 20, 1024, 0, True),
             (1 << 20, 1024, 16, True))


def _line_rows(state, lines):
    """Each leaf's rows at ``lines`` (a long tensor), along its line
    axis."""
    from repro_torch.core.rounds.state import LINE_AXIS
    return {k: v.index_select(LINE_AXIS[k], lines.to(v.device)).cpu()
            for k, v in state.items()}


def rounds_fig7_phase(dev, runs=FIG7_RUNS, iters=16):
    """Fig. 7's op stream (``device_rounds_batches`` with the bench's
    knobs: 8 nodes, read 0.3, zipf 1.1, seed 7), ``iters`` batches a
    run, driven through ``run_rounds`` on a flat state and through
    ``run_rounds_sharded`` on :data:`SHARDS` shards, both on ``dev``,
    and through ``run_rounds`` on a CPU twin over the lines the batches
    touch (renumbered 0..U-1: a round changes only the lines its slots
    name, so the twin is the flat state's touched rows).  Every batch
    served within ``FIG7_MAX_ROUNDS``; versions (and payloads) equal
    flat, sharded and twin, the rounds equal flat and twin; at the end
    every leaf of the flat state equals the twin's on the touched rows
    and a fresh state's elsewhere, the unsharded state equals the flat
    one, and the invariants hold."""
    from repro_torch.apps import DeviceRoundsConfig, device_rounds_batches
    from repro_torch.core.rounds import (Mesh, check_invariants,
                                         make_sharded_state, make_state,
                                         run_rounds, run_rounds_sharded,
                                         unshard_state)
    mesh = Mesh(SHARDS, device=dev)
    out = []
    t_all = time.perf_counter()
    for n_lines, r, width, wb in runs:
        batches = device_rounds_batches(DeviceRoundsConfig(
            n_nodes=FIG7_NODES, n_lines=n_lines, r_slots=r,
            read_ratio=FIG7_READ, zipf_theta=FIG7_THETA, iters=iters,
            payload_width=width), seed=FIG7_SEED)
        used = np.unique(np.concatenate([b[1] for b in batches]))
        remap = np.full(n_lines, -1, np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        geom = dict(write_back=wb, payload_width=width)
        flat = make_state(FIG7_NODES, n_lines, device=dev, **geom)
        shd = make_sharded_state(FIG7_NODES, n_lines, mesh, **geom)
        twin = make_state(FIG7_NODES, len(used), device="cpu", **geom)
        kw = dict(n_nodes=FIG7_NODES, max_rounds=FIG7_MAX_ROUNDS)
        rec = {"lines": n_lines, "r": r, "payload_width": width,
               "write_back": wb, "batches": iters,
               "lines_touched": int(len(used)), "rounds": [],
               "sharded_rounds": [], "flat_s": 0.0, "sharded_s": 0.0}
        for b in batches:
            node, line, isw = b[:3]
            wd = b[3] if width else None
            sync(dev)
            t0 = time.perf_counter()
            flat, fv, fd, fr, fok, _ = run_rounds(flat, node, line, isw, wd,
                                                  **kw)
            sync(dev)
            t1 = time.perf_counter()
            shd, sv, sd, sr, sok, _ = run_rounds_sharded(
                shd, node, line, isw, wd, mesh=mesh, **kw)
            sync(dev)
            t2 = time.perf_counter()
            twin, tv, td, tr, tok, _ = run_rounds(twin, node, remap[line],
                                                  isw, wd, **kw)
            rec["flat_s"] += t1 - t0
            rec["sharded_s"] += t2 - t1
            assert fok and sok and tok, "a batch was not served in bound"
            assert fr == tr, f"rounds {fr} on the card, {tr} on the twin"
            fv, fd = fv.cpu(), fd.cpu()
            assert torch.equal(fv, tv) and torch.equal(fd, td), \
                "the flat plane's versions differ from the CPU twin's"
            assert torch.equal(sv.cpu(), fv) and torch.equal(sd.cpu(), fd), \
                "the sharded plane's versions differ from the flat plane's"
            rec["rounds"].append(fr)
            rec["sharded_rounds"].append(sr)
        rows = torch.from_numpy(used).long()
        rest = torch.from_numpy(np.flatnonzero(remap < 0)).long()
        fresh = _line_rows(make_state(FIG7_NODES, len(rest), device="cpu",
                                      **geom),
                           torch.arange(len(rest)))
        got_used, got_rest = _line_rows(flat, rows), _line_rows(flat, rest)
        for k, v in twin.items():
            assert torch.equal(got_used[k], v), f"final {k} differs (twin)"
            assert torch.equal(got_rest[k], fresh[k]), \
                f"final {k}: an untouched line left its seed"
        for k, v in unshard_state(shd, mesh).items():
            assert torch.equal(v, flat[k]), f"final {k} differs (sharded)"
        check_invariants(flat)
        ops = iters * r
        rec.update(rounds_per_batch=sum(rec["rounds"]) / iters,
                   flat_ops_per_s=ops / rec["flat_s"],
                   sharded_ops_per_s=ops / rec["sharded_s"])
        out.append(rec)
        del flat, shd, twin
    return {"runs": out, "wall_s": time.perf_counter() - t_all}


# ------------------------------------------------ the sharded plane

SHARDS = 4


@contextlib.contextmanager
def tally(into):
    """Add the kernel launches made inside the block to ``into``."""
    from repro_torch import kernels as K
    before = K.launch_counts()
    yield
    for k, n in K.launch_counts().items():
        into[k] += n - before[k]


def sharded_placement(dev, mesh, launches, *, n_lines=PLACE_LINES,
                      width=PLACE_WIDTH, n_nodes=PLACE_NODES, batches=8,
                      batch=256, theta=0.99, read_frac=0.95, cap=None):
    """:func:`placement_phase`'s geometry and traffic on a sharded plane
    (home directory, replicas, ``bucket_cap=cap``) beside a flat twin:
    after ``batches`` batches, ``plan_rehome`` over the summed
    ``line_hits`` and a real ``rehome`` (at least one line moves), then
    ``replicate(plan_replication(...))``, then ``batches`` more in which
    the replicated lines are only read (a replica serves the image from
    before the round, so a same-round write would order differently
    from the flat plane's).  A line written in a batch has that one
    write slot and no other (the rest of its slots are emptied): bucket
    overflow splits a batch over rounds otherwise than the flat plane
    does, and only then is the history insensitive to the split, as in
    the reference's congestion trace.  Versions and payloads equal the
    twin's batch by batch; the final memory image too."""
    from repro_torch.apps.workloads import Zipf
    from repro_torch.core.rounds import (DevicePlane, check_invariants,
                                         make_sharded_state, make_state,
                                         plan_rehome, plan_replication)
    rng = np.random.default_rng(SEED + 16)
    zipf = Zipf(n_lines, theta)
    perm = rng.permutation(n_lines)
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    plane = DevicePlane.open(
        make_sharded_state(n_nodes, n_lines, mesh, payload_width=width,
                           home_directory=True, replicas=True), mesh,
        n_nodes=n_nodes, bucket_cap=cap)
    twin = DevicePlane.open(make_state(n_nodes, n_lines,
                                       payload_width=width, device=dev),
                            n_nodes=n_nodes)
    hits = np.zeros(n_lines, np.int64)
    whits = np.zeros(n_lines, np.int64)
    tele = None
    picks = np.zeros(0, np.int64)
    out = {"plane_s": 0.0, "twin_s": 0.0, "bucket_cap": cap}
    for b in range(2 * batches):
        if b == batches:
            moves = plan_rehome(hits, plane.state["home"], mesh.n_shards)
            with tally(launches):
                moved = plane.rehome(*moves)
            assert moved >= 1, f"no line moved ({moves})"
            picks = plan_replication(hits, whits, top_k=64,
                                     max_write_frac=0.1)
            assert picks.size > 0
            plane.replicate(picks)
            out.update(moved=moved, moved_lines=moves[0].tolist(),
                       moved_to=moves[1].tolist(),
                       replicated=int(picks.size))
        node = rng.integers(0, n_nodes, batch).astype(np.int32)
        line = perm[zipf.sample_batch(rng, batch)].astype(np.int32)
        isw = ((rng.random(batch) >= read_frac)
               & ~np.isin(line, picks)).astype(np.int32)
        written, first = set(line[isw == 1].tolist()), set()
        for i, ln in enumerate(line.tolist()):
            if ln in written:
                if isw[i] and ln not in first:
                    first.add(ln)
                else:
                    line[i] = -1
        wd = torch.empty((batch, width), dtype=torch.int32,
                         device=dev).random_(generator=g)
        t0 = time.perf_counter()
        with tally(launches):
            a = plane.ops(node, line, isw, wd)
        t1 = time.perf_counter()
        z = twin.ops(node, line, isw, wd)
        out["twin_s"] += time.perf_counter() - t1
        out["plane_s"] += t1 - t0
        assert np.array_equal(a.version, z.version) and \
            np.array_equal(a.data, z.data), f"batch {b}: twin differs"
        hits += a.telemetry.line_hits
        whits += a.telemetry.line_whits
        tele = a.telemetry if tele is None else tele + a.telemetry
    flat = plane.flat_state()
    for st in (flat, twin.state):
        check_invariants(st)
    for k in ("mem_version", "mem_data"):
        assert torch.equal(flat[k], twin.state[k]), f"final {k} differs"
    assert tele.replica_served.sum() > 0, "no read served by a replica"
    out.update(ops=2 * batches * batch, occupancy=tele.occupancy.tolist(),
               deferred=tele.deferred.tolist(),
               served_per_home=tele.served_per_home.tolist(),
               replica_served=tele.replica_served.tolist(),
               home_moved=int((plane.state["home"].cpu().numpy()
                               != np.arange(n_lines)).sum()))
    return out


def sharded_tree(dev, mesh, launches, *, n_keys=BTREE_KEYS,
                 n_lines=BTREE_LINES, slots=1024, c_batches=4,
                 a_batches=2):
    """Phase 5's tree (:func:`load_btree`, the same image) on the
    sharded plane: YCSB C answers against the oracle, YCSB A upserts
    read back, the plane's invariants and the unsharded final state's
    hash (``state_sha256``)."""
    from repro_torch.apps import BTreeBatchConfig, btree_kv_batches
    from repro_torch.core.rounds import check_invariants
    t0 = time.perf_counter()
    tree, oracle = load_btree(dev, n_keys, n_lines, mesh=mesh)
    sync(dev)
    res = {"keys": n_keys, "lines": n_lines, "height": tree.height,
           "load_s": time.perf_counter() - t0}
    with tally(launches):
        for name, ratio, iters, seed in (("c", 1.0, c_batches, SEED + 9),
                                         ("a", 0.5, a_batches, SEED + 10)):
            batches = btree_kv_batches(BTreeBatchConfig(
                n_keys=n_keys, r_slots=slots, read_ratio=ratio,
                zipf_theta=YCSB_THETA, iters=iters), seed=seed)
            out = run_ycsb(tree, oracle, batches)
            if name == "a":
                res["upserted_keys_checked"] = check_upserts(
                    tree, oracle, batches, slots)
            res[f"ycsb_{name}"] = {
                "batches": iters, "batch_s": out["batch_s"],
                "rounds_per_batch": out["rounds"],
                "lookups_per_s": out["lookups"] / max(out["lookup_s"],
                                                      1e-9),
                "upserts_per_s": (out["upserts"] / out["upsert_s"]
                                  if out["upserts"] else None),
                "deferred": tree.stats["descent_deferred"]}
    flat = tree.plane.flat_state()
    check_invariants(flat)
    res["state_sha256"] = state_sha256(flat)
    del flat
    res["wall_s"] = time.perf_counter() - t0
    return res


def sharded_txn(dev, mesh, launches, *, n_gcls=TXN_GCLS, batch=1024,
                n_batches=2):
    """Phase 6's transactions on the sharded plane beside a flat twin:
    decisions, completion steps, retries, iterations and the final
    image equal, under 2PL and TO."""
    from repro_torch.apps import (DeviceTxnConfig, DeviceTxnEngine,
                                  TxnBatchConfig, device_txn_batches)
    from repro_torch.core.rounds import (DevicePlane, make_sharded_state,
                                         make_state, txn_payload_width)
    w = txn_payload_width(TXN_TUPLES)
    res = {"gcls": n_gcls, "batch": batch}
    for algo, seed in (("2pl", SEED + 13), ("to", SEED + 14)):
        cfg = DeviceTxnConfig(algo=algo, tuples_per_gcl=TXN_TUPLES,
                              max_group_lines=TXN_LINES_MAX)
        eng = DeviceTxnEngine(DevicePlane.open(make_sharded_state(
            TXN_NODES, n_gcls, mesh, payload_width=w), mesh), cfg)
        twin = DeviceTxnEngine(DevicePlane.open(make_state(
            TXN_NODES, n_gcls, payload_width=w, device=dev)), cfg)
        out = {"batch_s": [], "twin_batch_s": [], "iters": [],
               "rounds": [], "retries": 0}
        for txns, node, ts in device_txn_batches(TxnBatchConfig(
                n_gcls=n_gcls, tuples_per_gcl=TXN_TUPLES, batch=batch,
                iters=n_batches, max_group_lines=TXN_LINES_MAX,
                zipf_theta=TXN_THETA, n_nodes=TXN_NODES), seed=seed):
            t0 = time.perf_counter()
            with tally(launches):
                r, _ = eng.run_batch(node, txns, ts=ts)
            t1 = time.perf_counter()
            z, _ = twin.run_batch(node, txns, ts=ts)
            out["twin_batch_s"].append(time.perf_counter() - t1)
            out["batch_s"].append(t1 - t0)
            for k in ("decision", "exec_step", "retries"):
                assert np.array_equal(getattr(r, k), getattr(z, k)), \
                    f"{algo}: {k} differs from the flat plane's"
            assert (r.iters, r.rounds) == (z.iters, z.rounds), algo
            out["iters"].append(r.iters)
            out["rounds"].append(r.rounds)
            out["retries"] += int(r.retries.sum())
        assert torch.equal(eng.plane.flat_state()["mem_data"],
                           twin.plane.state["mem_data"]), \
            f"{algo}: the final image differs from the flat plane's"
        eng.plane.check()
        out["commits"] = eng.stats.commits
        out["commits_per_s"] = eng.stats.commits / sum(out["batch_s"])
        out["twin_commits_per_s"] = (twin.stats.commits
                                     / sum(out["twin_batch_s"]))
        res[algo] = out
        del eng, twin
    return res


def sharded_latch_check(dev, n=BTREE_LINES, r=1024):
    """``distributed_latch_round`` at the tree's ``n`` words split
    :data:`SHARDS` ways, ``r`` requests a shard (the descent pattern of
    :func:`latch_app_inputs`), against K1's plain version on the flat
    words: new words, old words and verdicts equal."""
    from repro_torch.core.distributed_rounds import (
        distributed_latch_round, stripe, unstripe)
    from repro_torch.core.rounds import Mesh
    from repro_torch.kernels.latch_ops import REQ_KEYS, latch_apply_plain
    words, req_np = latch_app_inputs(n, SHARDS * r, "descent")
    w = torch.from_numpy(words).to(dev)
    req = {k: torch.from_numpy(v).to(dev) for k, v in req_np.items()}
    new, hi, lo, ok, dropped = distributed_latch_round(
        stripe(w, SHARDS), req, mesh=Mesh(SHARDS, device=dev))
    want = latch_apply_plain(w, *[req[k] for k in REQ_KEYS])
    assert int(dropped) == 0
    got = (unstripe(new, SHARDS), hi, lo, ok)
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    assert err == 0, f"distributed_latch_round disagrees ({err})"
    return {"words": n, "requests": SHARDS * r, "max_abs_err": err}


def sharded_phase(dev, flat_serve, *, kv_cfg=None, n_q_heads=16,
                  place=None, place_cap=16, tree=None, txn=None):
    """The sharded plane: :data:`SHARDS` home shards on the card
    (``Mesh(4)``), every check against a flat twin on the card.  The
    serve (:func:`serve` over a mesh-backed ``KVPoolConfig()`` pool, the
    48-request trace: readbacks against ``ToyLM.expected_pages``, every
    dispatch's versions and the final unsharded state hashed equal to
    ``flat_serve``'s), placement at the serve pool's geometry twice
    (:func:`sharded_placement`: a real ``rehome`` and replica serves;
    then ``bucket_cap=place_cap``, 16 under the 64 slots a shard, so
    requests defer), the tree at phase 5's geometry (:func:`sharded_tree`) and
    the transactions at phase 6's (:func:`sharded_txn`).  ``place`` /
    ``tree`` / ``txn`` override those runs' sizes (dicts of keyword
    arguments; CPU rehearsals).  Returns the results and ``launches``:
    the K1-K3 launches of the sharded calls alone (not the twins')."""
    from repro_torch.core.rounds import Mesh
    mesh = Mesh(SHARDS, device=dev)
    launches = collections.Counter()
    t0 = time.perf_counter()
    with tally(launches):
        res = {"serve": serve(dev, kv_cfg, n_q_heads, mesh=mesh)}
    for k in ("versions_sha256", "state_sha256", "ticks",
              "coherence_rounds", "tokens_generated"):
        assert res["serve"][k] == flat_serve[k], \
            f"sharded serve: {k} differs from the flat serve's"
    assert res["serve"]["shards"] == SHARDS
    res["serve_s"] = time.perf_counter() - t0
    place = dict(place or {})
    res["placement"] = sharded_placement(dev, mesh, launches, **place)
    res["placement_capped"] = sharded_placement(dev, mesh, launches,
                                                cap=place_cap, **place)
    assert sum(map(sum, res["placement_capped"]["deferred"])) > 0, \
        "bucket_cap below the slots a shard deferred nothing"
    res["tree"] = sharded_tree(dev, mesh, launches, **(tree or {}))
    res["txn"] = sharded_txn(dev, mesh, launches, **(txn or {}))
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = {k: launches[k] for k in ("latch_ops", "gcl_fetch",
                                                 "paged_attention")}
    return res


# ------------------------------------------------------ phase 7: training

TRAIN_TOL = 5e-2   # kernels vs plain step, bf16: x each leaf's max |want|
# phase 7's runs, in order: arch -> train_run's keywords.  The first four
# go through ``launch.train.main`` at the full config with fp32 AdamW
# states; llava-next-mistral-7b's fp32 m and v would need ~87 GB, so it
# takes the int8 tiers (both packages' ``AdamWConfig``), and its 1152
# patch embeddings before 512 tokens (1664 positions, K4's longest
# training shape); deepseek-moe-16b is cut to 4 layers at full width
# (16.88 G parameters at full depth, ~7 GB of state a layer): neither is
# a flag of the JAX driver, so both go through ``build_train_step``.
TRAIN_RUNS = {"qwen3-1.7b": {}, "mamba2-2.7b": {},
              "recurrentgemma-2b": {}, "seamless-m4t-medium": {},
              "llava-next-mistral-7b": {"seq": 1664, "int8_state": True},
              "deepseek-moe-16b": {"n_layers": 4}}
# train_plain_check's cuts: arch -> (n_layers, seq).  recurrentgemma-2b's
# 6 layers hold 2 attention layers, and its 2048 window bites at 2304
# positions (the serve replay's length); seamless-m4t-medium 4 encoder
# and 4 decoder layers.
TRAIN_PLAIN = {"qwen3-1.7b": (4, 512), "mamba2-2.7b": (4, 512),
               "recurrentgemma-2b": (6, 2304),
               "seamless-m4t-medium": (4, 512)}


def _train_cfg(steps, state="float32"):
    """``launch.train.main``'s TrainConfig for ``--steps steps --micro 1
    --lr 3e-4`` at a full config (remat on), with AdamW's m and v in
    ``state`` ("float32", the driver's, or "int8")."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    return TrainConfig(micro_batches=1, remat=True, opt=AdamWConfig(
        lr=3e-4, warmup_steps=max(5, steps // 20), total_steps=steps,
        m_dtype=state, v_mode=state))


def train_run(dev, K, arch, steps=8, batch=4, seq=512, n_layers=None,
              int8_state=False):
    """One training run at the full width of ``arch`` (random bf16
    weights, remat, ``--micro 1``, lr 3e-4): through ``launch.train.main``
    at the full config with fp32 AdamW states, or, for ``n_layers`` layers
    or the int8 m and v tiers, through ``build_train_step``,
    ``init_train_state`` (parameters seeded 0) and the driver's loop
    (``launch.train.run_steps``), ``seq`` positions a row, the vlm's
    patches first.  Asserts finite losses and grad norms, no parameter
    leaf without a gradient on the first step, and exactly
    ``lm.train_launches`` at every step and nothing else; then one more
    step under ``torch.profiler`` for the device's busy share.  Prints the
    median step over steps 1..steps-1, tokens (positions) a second, the
    peak memory beside the state's own bytes (parameters and optimizer
    state, summed over the leaves).  Returns the run's numbers and its
    launch counts."""
    from repro_torch import tree as pt
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import frontend_stand_ins
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import run_steps
    from repro_torch.models.lm import train_launches
    from repro_torch.train import build_train_step, init_train_state
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    tcfg = _train_cfg(steps, "int8" if int8_state else "float32")
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(train_launches(cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    extra = frontend_stand_ins(cfg, seq, batch, dev)
    toks = seq - (cfg.n_patches if "patch_embeds" in extra else 0)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=batch,
                                  seq_len=toks))
    if n_layers or int8_state:
        step_fn, _, _ = build_train_step(cfg, make_local_mesh(dev), tcfg,
                                         global_batch=batch)
        state = init_train_state(cfg, tcfg, torch.Generator(
            device=dev).manual_seed(0), dev)
        rec = run_steps(step_fn, state, data, extra, steps, dev)
        del step_fn, state
    else:
        rec = train_main(["--arch", arch, "--steps", str(steps), "--batch",
                          str(batch), "--seq", str(seq), "--micro", "1",
                          "--lr", "3e-4", "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    state = rec.pop("state")
    assert np.isfinite(rec["losses"]).all() and \
        np.isfinite(rec["grad_norms"]).all(), f"{arch}: non-finite training"
    assert rec["grads_missing"] == 0, \
        f"{arch}: {rec['grads_missing']} parameter leaves got no gradient"
    for i, got in enumerate(rec["launches"]):
        assert got == want, f"{arch} step {i}: launches {got}, want {want}"
    n_params = sum(t.numel() for t in pt.leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size() for t in pt.leaves(state))
    step_fn, _, _ = build_train_step(cfg, make_local_mesh(dev), tcfg,
                                     global_batch=batch)
    b = dict(data.batch_at(steps), **extra)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    events = prof.key_averages()
    busy = device_busy_us(events) / (prof_wall * 1e6)
    top = _top_device(events)
    kernel_ms = _kernel_device_ms(events)
    assert np.isfinite(float(metrics["loss"]))
    del state, extra, b, step_fn
    torch.cuda.empty_cache()
    ms = rec["step_ms"]
    steady = float(np.median(ms[1:]))
    out = {"arch": arch, "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "steps": steps, "optimizer_state": tcfg.opt.m_dtype,
           "losses": rec["losses"], "grad_norms": rec["grad_norms"],
           "step_ms": ms, "steady_step_ms": steady,
           "tokens_per_s": batch * seq / steady * 1e3,
           "peak_mem_gb": peak / 1e9, "params": n_params,
           "state_gb": state_bytes / 1e9,
           "device_busy_share": busy, "profiled_step_ms": prof_wall * 1e3,
           "top_device_ms": top, "kernel_device_ms": kernel_ms,
           "wall_s_with_init": wall, "launches_per_step": want}
    log(f"train {arch}: " + json.dumps(out))
    return out, {k: v * steps for k, v in want.items()}


def _top_device(events, n=10) -> dict:
    """The ``n`` device events with the most device time in a
    ``key_averages()`` (ms, over the profiled window), and the rest."""
    from torch.autograd import DeviceType
    dev = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation), key=lambda kv: -kv[1])
    out = {k[:80]: ms for k, ms in dev[:n]}
    out["rest"] = sum(ms for _, ms in dev[n:])
    return out


def _kernel_device_ms(events) -> dict:
    """Device time (ms) of the port's K4 and K5 kernels in a
    ``key_averages()``, forward and backward apart (a backward call
    launches two K4 kernels, a dQ and a dK/dV pass), with their
    launches."""
    from torch.autograd import DeviceType
    out = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        for tag, part in (("flash_attention_bwd", "flash_attention_bwd"),
                          ("ssd_intra_bwd", "ssd_intra_bwd"),
                          ("flash_attention", "flash_attention_"),
                          ("ssd_intra", "ssd_intra_kernel")):
            if part in e.key:
                ms, n = out.get(tag, (0.0, 0))
                out[tag] = (ms + e.self_device_time_total / 1e3,
                            n + e.count)
                break
    return {k: {"ms": ms, "kernel_launches": n}
            for k, (ms, n) in out.items()}


@contextlib.contextmanager
def plain_paths():
    """The model's two kernel call sites (``attention`` in
    ``models/lm.py``, ``ssd_intra`` in ``models/ssm.py``) routed to the
    plain PyTorch versions, on any device, for a comparison run."""
    from repro_torch.kernels.ssd_intra import ssd_intra_plain
    from repro_torch.models import lm, ssm
    from repro_torch.models.attention import dense_attention
    real = lm.attention, ssm.ssd_intra
    lm.attention = lambda q, k, v, causal=True, window=None, q_offset=0: \
        dense_attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    ssm.ssd_intra = ssd_intra_plain
    try:
        yield
    finally:
        lm.attention, ssm.ssd_intra = real


def train_plain_check(dev, K, arch, n_layers=4, batch=4, seq=512):
    """Full width, ``n_layers`` layers (the encdec family: as many in the
    encoder and in the decoder, over the driver's seeded frame
    stand-ins): one training step's loss and every gradient leaf through the
    kernels (forward, recompute and backward) against the same step with
    the plain versions forced on the card (:func:`plain_paths`), bf16:
    the loss within 1e-2 of itself and each leaf within :data:`TRAIN_TOL`
    of its max |want| (the kernels round P, and in the backward dS, to
    bf16 where the plain attention keeps fp32, and the difference passes
    through the layers); the cross-attention's key bias, whose exact
    gradient is 0, within TRAIN_TOL of its query bias's max |want|."""
    from repro_torch import tree as pt
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import frontend_stand_ins
    from repro_torch.models import lm
    from repro_torch.train.step import value_and_grad
    cfg = get_config(arch).replace(n_layers=n_layers)
    if cfg.family == "encdec":
        cfg = cfg.replace(n_enc_layers=n_layers)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 13), dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(DataConfig(
        vocab=cfg.vocab, batch=batch, seq_len=seq)).batch_at(0).items()}
    if cfg.family == "encdec":
        b.update(frontend_stand_ins(cfg, seq, batch, dev))

    def loss_fn(p, bt):
        return lm.train_loss(p, bt, cfg, lm.NO_PARALLEL, remat=True)
    K.reset_launch_counts()
    loss, grads, missing = value_and_grad(loss_fn, params, b)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert missing == 0
    want_counts = dict.fromkeys(K.WRAPPERS, 0)
    want_counts.update(lm.train_launches(cfg))
    assert counts == want_counts, (counts, want_counts)
    with plain_paths():
        want_loss, want, _ = value_and_grad(loss_fn, params, b)
    torch.cuda.synchronize()
    assert K.launch_counts() == counts, "the plain step launched a kernel"
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    worst = 0.0
    named = dict(pt.leaves_with_paths(want))
    for (path, g), (_, w) in zip(pt.leaves_with_paths(grads),
                                 named.items()):
        err = float((g.float() - w.float()).abs().max())
        # the cross-attention's key bias (no rope) has an exact gradient
        # of 0 (each row's dS sums to 0 over the keys: softmax ignores a
        # shift along them), so both versions give rounding noise there:
        # its scale is its query bias's
        if path.endswith("/x_bk"):
            w = named[path[:-2] + "bq"]
        scale = float(w.float().abs().max())
        assert np.isfinite(err) and err <= TRAIN_TOL * scale, \
            f"{arch}: gradient leaf {path} off by {err} (max |want| " \
            f"{scale}, tol {TRAIN_TOL})"
        worst = max(worst, err / max(scale, 1e-30))
    assert loss_rel < 1e-2, f"{arch}: loss {float(loss)} vs plain " \
        f"{float(want_loss)}"
    out = {"arch": arch, "layers": n_layers, "seq": seq,
           "loss": float(loss),
           "plain_loss": float(want_loss), "loss_rel_err": loss_rel,
           "worst_leaf_rel_err": worst, "leaves": len(pt.leaves(grads)),
           "tolerance": TRAIN_TOL}
    log(f"train kernels vs plain {arch}: " + json.dumps(out))
    del params, grads, want
    torch.cuda.empty_cache()
    return out


def train_resume_check(dev, arch="mamba2-2.7b", n_layers=1, steps=6,
                       batch=4, seq=512):
    """Checkpoints on the card, full width and ``n_layers`` layers: 6
    steps with an async save after step 3 (``CheckpointManager``, under
    the checkout's git-ignored ``build/``); a fresh state restored from
    it (``restore`` of step 3: its manifest's crc32s checked once) runs
    steps 4 and 5, whose losses must equal the uninterrupted run's within
    1e-3 (printed: whether bit for bit)."""
    from repro_torch.checkpoint import CheckpointManager, restore
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import build_train_step, init_train_state
    cfg = get_config(arch).replace(n_layers=n_layers)
    tcfg = _train_cfg(steps)
    step_fn, _, _ = build_train_step(cfg, make_local_mesh(dev), tcfg,
                                     global_batch=batch)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=batch,
                                  seq_len=seq))
    ckdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(ckdir)

    def fresh():
        return init_train_state(cfg, tcfg, torch.Generator(
            device=dev).manual_seed(SEED + 14), dev)
    state, losses = fresh(), []
    t0 = time.perf_counter()
    for step in range(steps):
        state, m = step_fn(state, data.batch_at(step))
        losses.append(float(m["loss"]))
        if step == 3:
            mgr.save(state, step)
    mgr.wait()
    save_s = time.perf_counter() - t0
    del state
    t0 = time.perf_counter()
    state, start = restore(fresh(), ckdir, step=3)
    restore_s = time.perf_counter() - t0
    resumed = []
    for step in range(start + 1, steps):
        state, m = step_fn(state, data.batch_at(step))
        resumed.append(float(m["loss"]))
    del state
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    assert start == 3 and np.allclose(resumed, losses[4:], rtol=1e-3), \
        (resumed, losses[4:])
    out = {"arch": arch, "layers": n_layers, "losses": losses,
           "resumed_losses": resumed,
           "bit_for_bit": resumed == losses[4:],
           "train_and_save_s": save_s, "restore_s": restore_s}
    log("train resume: " + json.dumps(out))
    return out


# ------------------------------------------ phase 7b: the sharded LM stack

SHARDED_ARCH = "deepseek-moe-16b"
SHARDED_TRAIN_LAYERS = 4           # as TRAIN_RUNS cuts it
PIPE_STAGES, PIPE_MICRO, PIPE_WIDTH, PIPE_LAYERS, PIPE_ROWS = 4, 8, 2048, 8, 64
PIPE_REPEATS = 20                  # warmed runs of each, in turns


def sharded_serve(dev, K, requests=8, batch=4, prompt=512, gen=32,
                  logits_out=None):
    """``launch.serve.main --production-mesh`` for deepseek-moe-16b at
    full width and depth: (data 16, model 16) on the card, EP 16 over
    the model axis.  A prefill's 4 x 512 tokens replicate over the data
    axis (16 does not divide the batch) and split over the model axis:
    16 shards of 128 tokens, each routed against its own capacity (16
    slots, against 244 for the 2048 tokens routed flat); a decode step's
    4 tokens replicate over both axes, so they are routed once.  K4 must
    run once per attention layer a prefill.  ``logits_out`` keeps the
    first batch's logits and decode inputs (``--logits-out``), phase
    7d's reference."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import make_ctx
    cfg = get_config(SHARDED_ARCH)
    ctx = make_ctx(make_production_mesh(device=dev), cfg)
    nb, ns, _ = moe.ep_layout((batch, prompt, cfg.d_model), ctx)
    local_cap = moe._capacity(batch * prompt // (nb * ns), cfg.top_k,
                              cfg.n_experts, cfg.capacity_factor)
    with dispatch_calls() as calls:
        res = lm_serve(K, SHARDED_ARCH, requests, "flash_attention",
                       cfg.n_layers, 0, batch, prompt, gen,
                       flags=("--production-mesh",)
                       + (("--logits-out", logits_out) if logits_out
                          else ()))
        shapes = collections.Counter(tuple(r[4].shape) for _, r in calls)
        del calls[:]
    prefills = -(-requests // batch)
    prefill_shape = (nb * ns, batch * prompt // (nb * ns) * cfg.top_k)
    assert res["mesh"] == {"data": 16, "model": 16} and res["ep"] == 16
    assert shapes[prefill_shape] == prefills * cfg.n_layers, shapes
    res.update(shards_routing_a_prefill=nb * ns, local_capacity=local_cap,
               flat_capacity=moe._capacity(batch * prompt, cfg.top_k,
                                           cfg.n_experts,
                                           cfg.capacity_factor),
               dispatch_shapes={str(k): v for k, v in shapes.items()})
    return res


def sharded_train(dev, K, steps=8, batch=4, seq=512):
    """``launch.train.main --production-mesh`` for deepseek-moe-16b at
    full width and :data:`SHARDED_TRAIN_LAYERS` layers (the driver's
    config lookup cut to that depth; the driver has no depth flag), with
    the driver's ``--micro 1``, remat and lr 3e-4: its state placed by
    ``state_specs`` on (data 16, model 16), EP 16 in every moe layer.
    Finite losses and grad norms, a gradient for every leaf, exactly
    ``lm.train_launches`` a step.  ``resolve_micro`` would also give 1
    micro-batch here (dp 16 does not divide the batch of 4)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.lm import train_launches
    from repro_torch.train import TrainConfig, resolve_micro
    real = train_mod.get_config
    cfg = real(SHARDED_ARCH).replace(n_layers=SHARDED_TRAIN_LAYERS)
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update(train_launches(cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_mod.get_config = lambda arch: real(arch).replace(
        n_layers=SHARDED_TRAIN_LAYERS)
    try:
        rec = train_mod.main(["--arch", SHARDED_ARCH, "--production-mesh",
                              "--steps", str(steps), "--batch", str(batch),
                              "--seq", str(seq), "--micro", "1", "--lr",
                              "3e-4", "--log-every", "1"])
    finally:
        train_mod.get_config = real
    peak = torch.cuda.max_memory_allocated()
    del rec["state"]
    torch.cuda.empty_cache()
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["ep"] == 16
    assert rec["n_micro"] == 1 and resolve_micro(
        TrainConfig(), make_production_mesh(device=dev), batch) == 1
    assert np.isfinite(rec["losses"]).all() and \
        np.isfinite(rec["grad_norms"]).all(), "non-finite EP training"
    assert rec["grads_missing"] == 0, \
        f"{rec['grads_missing']} parameter leaves got no gradient"
    for i, got in enumerate(rec["launches"]):
        assert got == want, f"EP train step {i}: launches {got}, want {want}"
    steady = float(np.median(rec["step_ms"][1:]))
    out = {"arch": SHARDED_ARCH, "layers": SHARDED_TRAIN_LAYERS,
           "mesh": rec["mesh"], "ep": rec["ep"], "n_micro": rec["n_micro"],
           "batch": batch, "seq": seq, "steps": steps,
           "losses": rec["losses"], "grad_norms": rec["grad_norms"],
           "step_ms": rec["step_ms"], "steady_step_ms": steady,
           "tokens_per_s": batch * seq / steady * 1e3,
           "peak_mem_gb": peak / 1e9, "grads_missing": rec["grads_missing"],
           "launches_per_step": want}
    return out, {k: v * steps for k, v in want.items()}


def pipeline_check(dev, stages=PIPE_STAGES, micro=PIPE_MICRO,
                   width=PIPE_WIDTH, n_layers=PIPE_LAYERS, rows=PIPE_ROWS,
                   mesh=None):
    """``parallel.pipeline_forward`` on a ``pipe`` mesh of ``stages`` on
    the card: ``micro`` micro-batches of ``rows`` x ``width`` fp32 through
    a ``tanh(h @ w)`` stack of ``n_layers`` (w ~ N(0, 1/width)), held
    within rtol 1e-5 (atol 1e-6) of the unpipelined layer loop; both
    timed over ``PIPE_REPEATS`` warmed runs each, in turns
    (CUDA-synchronised wall: median and range), beside the schedule's
    bubble fraction.  ``mesh`` (a ``pipe`` mesh over ranks, one stage a
    rank) replaces the one-process mesh."""
    from repro_torch.core.rounds import Mesh
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               pipeline_forward,
                                               split_stages)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    w = torch.randn((n_layers, width, width), generator=gen,
                    device=dev) * width ** -0.5
    x = torch.randn((micro, rows, width), generator=gen, device=dev)

    def stage(params, h):
        for wi in params["w"]:
            h = torch.tanh(h @ wi)
        return h

    def loop():
        return torch.stack([stage({"w": w}, xm) for xm in x])

    mesh = Mesh({"pipe": stages}, dev) if mesh is None else mesh
    staged = split_stages({"w": w}, stages)

    def pipe():
        return pipeline_forward(stage, staged, x, mesh=mesh)

    got, want = pipe(), loop()                          # warm-up
    ms = {"pipeline": [], "loop": []}
    for _ in range(PIPE_REPEATS):                       # in turns
        for name, fn in (("pipeline", pipe), ("loop", loop)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    diff = (got - want).abs()
    out = {"stages": stages, "micro_batches": micro, "width": width,
           "layers": n_layers, "rows": rows,
           "bubble_fraction": bubble_fraction(stages, micro),
           "max_abs_err": float(diff.max()),
           "max_rel_err": float((diff / want.abs().clamp_min(1e-30)).max()),
           "bit_equal": bool(torch.equal(got, want)), "repeats": PIPE_REPEATS}
    for name, t in ms.items():
        out[f"{name}_ms"] = statistics.median(t)
        out[f"{name}_ms_range"] = [min(t), max(t)]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    return out


def sharded_lm_phase(dev, K, logits_out=None):
    """Phase 7b: the sharded LM stack on one card: (a) the serve under
    the production mesh (:func:`sharded_serve`), (b) EP ``moe_ffn`` on
    it against the per-shard reference (:func:`moe_card_check` with the
    mesh), (c) the train driver under it (:func:`sharded_train`), (d)
    the GPipe schedule (:func:`pipeline_check`).  Returns the phase's
    record and the kernel launches of (a) and (c), counted from 0 just
    before each."""
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.perf_counter()
    serve_res = sharded_serve(dev, K, logits_out=logits_out)
    log("sharded_lm serve: " + json.dumps(serve_res))
    ep_check = moe_card_check(dev, mesh=make_production_mesh(device=dev))
    train_res, train_counts = sharded_train(dev, K)
    log("sharded_lm train: " + json.dumps(train_res))
    pipe = pipeline_check(dev)
    log("sharded_lm pipeline: " + json.dumps(pipe))
    launches = {"serve": serve_res["launches"], "train": train_counts}
    assert launches["serve"]["flash_attention"] > 0 and \
        launches["train"]["flash_attention"] > 0 and \
        launches["train"]["flash_attention_bwd"] > 0, launches
    out = {"serve_tok_per_s": serve_res["tok_per_s"],
           "local_capacity": serve_res["local_capacity"],
           "flat_capacity": serve_res["flat_capacity"],
           "serve_k4_launches": serve_res["launches"]["flash_attention"],
           "ep_check_rel_err": ep_check["rel_err"],
           "ep_check_dropped": ep_check["dropped"],
           "train_steady_step_ms": train_res["steady_step_ms"],
           "train_losses": train_res["losses"],
           "train_grad_norms": train_res["grad_norms"],
           "train_k4_launches": train_counts["flash_attention"],
           "train_k4_bwd_launches": train_counts["flash_attention_bwd"],
           "pipeline_max_rel_err": pipe["max_rel_err"],
           "seconds": time.perf_counter() - t0}
    log("sharded_lm: " + json.dumps(out))
    return out, launches


# ------------------------------------ phase 7d: the shard_map bodies over ranks

RANKS = 4                          # gloo ranks sharing the one card
RANK_JOIN_S = 400                  # the limit on the ranks' join
RANK_GEN = 8                       # teacher-forced decode steps of (c)


def _rank_path(K, name, fn, out):
    """Run one of a rank's paths with the launch and collective counts
    set to 0 just before it; record its wall, launches and the bytes
    each collective moved."""
    from repro_torch.core.rounds.mesh import (collective_counts,
                                              reset_collective_counts)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    reset_collective_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    out[name] = {"wall_s": time.perf_counter() - t0,
                 "launches": K.launch_counts(),
                 "collectives": collective_counts(), "result": res}
    return res


RANK_TRAIN_STEPS = 8                # as phase 7b's sharded_train
RANK_TRAIN_LOSS_TOL = 1e-3         # every step's loss, relative to 7b's
RANK_TRAIN_GNORM_TOL = 1e-4        # step 0's grad norm, relative to 7b's


def rank_train(dev, K, ref, small=None):
    """One rank of ``launch.train.main --production-mesh`` for
    deepseek-moe-16b at full width and :data:`SHARDED_TRAIN_LAYERS`
    layers, as phase 7b's :func:`sharded_train` runs it in one process
    (batch 4 x 512, ``--micro 1``, remat, lr 3e-4, the same seed): EP 16
    as the ranks x their model shards, each rank holding its experts and
    their AdamW state, the expert exchanges differentiated across the
    ranks, the clip's norm over every rank's gradient.  Held against
    7b's run (``ref``: its losses and grad norms): step 0's loss bit for
    bit, its grad norm within :data:`RANK_TRAIN_GNORM_TOL` relative,
    every loss within :data:`RANK_TRAIN_LOSS_TOL`; finite, no gradient
    missing, exactly ``lm.train_launches`` a step.  Returns the rank's
    record: losses, grad norms, step ms, peak memory, launches and
    collectives (calls and bytes) a step, and step 0's gradient digests.
    ``small`` rehearses it on the CPU (the smoke config with 16
    experts, ``small['train']``'s steps and sequence)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models.lm import train_launches
    steps, seq = ((small["train"]["steps"], small["train"]["seq"]) if small
                  else (RANK_TRAIN_STEPS, 512))
    argv = ["--arch", SHARDED_ARCH, "--production-mesh", "--steps",
            str(steps), "--batch", "4", "--seq", str(seq), "--micro", "1",
            "--lr", "3e-4", "--log-every", "1", "--grad-digest"]
    real = {"get_config": train_mod.get_config,
            "get_smoke_config": train_mod.get_smoke_config}
    if small:
        argv += ["--smoke", "--device", "cpu"]
        train_mod.get_smoke_config = lambda a: real["get_smoke_config"](
            a).replace(n_experts=16)
    else:
        train_mod.get_config = lambda a: real["get_config"](a).replace(
            n_layers=SHARDED_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        cfg = (train_mod.get_smoke_config if small
               else train_mod.get_config)(SHARDED_ARCH)
        rec = train_mod.main(argv)
    finally:
        for k, fn in real.items():
            setattr(train_mod, k, fn)
    peak = torch.cuda.max_memory_allocated()
    del rec["state"]
    gc.collect()
    torch.cuda.empty_cache()
    want = dict.fromkeys(K.WRAPPERS, 0)
    if not small:
        want.update(train_launches(cfg))
    rank = rec["rank"]
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["ep"] == 16
    assert rec["world"] == RANKS and rec["n_micro"] == 1
    assert np.isfinite(rec["losses"]).all() and \
        np.isfinite(rec["grad_norms"]).all(), \
        f"rank {rank}: non-finite training over ranks"
    assert rec["grads_missing"] == 0, \
        f"rank {rank}: {rec['grads_missing']} leaves got no gradient"
    for i, got in enumerate(rec["launches"]):
        assert got == want, f"rank {rank} step {i}: launches {got}, " \
            f"want {want}"
    losses, gnorms = rec["losses"], rec["grad_norms"]
    ref_l, ref_g = ref["losses"][:steps], ref["grad_norms"][:steps]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_l)]
    out = {"layers": cfg.n_layers, "steps": steps, "batch": 4, "seq": seq,
           "losses": losses, "grad_norms": gnorms,
           "ref_losses": ref_l, "ref_grad_norms": ref_g,
           "step0_loss_bit_equal": losses[0] == ref_l[0],
           "step0_grad_norm_rel": abs(gnorms[0] - ref_g[0]) / ref_g[0],
           "loss_rel_err_by_step": loss_rel,
           "step_ms": rec["step_ms"],
           "steady_step_ms": float(np.median(rec["step_ms"][1:])),
           "peak_mem_gb": peak / 1e9,
           "launches_per_step": {k: n for k, n in want.items() if n},
           # the driver resets the counts before each step
           "launches_total": {k: n * steps for k, n in want.items() if n},
           "collectives_per_step": rec["collectives"][-1],
           "collectives_steps_equal": all(
               c == rec["collectives"][-1] for c in rec["collectives"]),
           "grads_missing": rec["grads_missing"],
           "grad_digest_replicated": rec["grad_digest"]["replicated"],
           "grad_leaves_ranked": len(rec["grad_digest"]["ranked"])}
    assert out["step0_loss_bit_equal"], \
        f"rank {rank}: step 0's loss {losses[0]} is not 7b's {ref_l[0]}"
    assert out["step0_grad_norm_rel"] <= RANK_TRAIN_GNORM_TOL, out
    assert max(loss_rel) <= RANK_TRAIN_LOSS_TOL, out
    return out


def rank_main(rank, world, tmp):
    """One of phase 7d's ranks: joins the gloo group of the ranks that
    share the card (``parallel.dist.init``), loads the kernels the parent
    built, and runs (a) the 48-request serve over a mesh-backed
    ``KVPoolConfig()`` pool on ``Mesh(4)`` split one shard a rank, its
    hashes against ``flat_serve``'s; (b) phase 5's tree on the same
    mesh, its unsharded state's hash against the one-process 4-shard
    run's; (c) deepseek-moe-16b at full width and depth through
    ``launch.serve --production-mesh`` (EP 16 as 4 ranks x 4 model
    shards, 16 experts a rank), teacher-forced on phase 7b's first batch,
    its logits against 7b's, then ``moe_card_check`` on this rank's
    shards; (d) the pipeline, one stage a rank; (e) after the serve
    paths' memory is freed, deepseek-moe-16b's training through
    ``launch.train --production-mesh`` against phase 7b's one-process
    run (:func:`rank_train`).  Writes ``rank<r>.json``.  A ``small``
    entry in the spec rehearses the ranks on the CPU at its sizes (the
    smoke config with 16 experts for (c) and (e), no
    ``moe_card_check``)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    from repro_torch import kernels as K
    from repro_torch.core.rounds import Mesh
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import dist as pd
    tmp = os.fspath(tmp)
    spec = json.loads(open(os.path.join(tmp, "spec.json")).read())
    small = spec.get("small")
    if small:
        from repro_torch.dsm.kvpool import KVPoolConfig
        from repro_torch.launch import serve as serve_mod
        torch.cuda.synchronize = lambda *a, **k: None
        torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
        real = serve_mod.get_smoke_config
        serve_mod.get_smoke_config = lambda a: real(a).replace(
            n_experts=16)
        kv = (KVPoolConfig(**small["kv"]), small["n_q_heads"])
    t0 = time.perf_counter()
    group, dev = pd.init(init_method="file://" + os.path.join(
        tmp, "rendezvous"), device="cpu" if small else "cuda")
    backend = torch.distributed.get_backend(group)
    assert backend == "gloo" and dev == torch.device(
        "cpu" if small else "cuda", None if small else 0), (backend, dev)
    out = {"rank": rank, "world": world, "backend": backend,
           "device": str(dev), "join_s": time.perf_counter() - t0}
    loads0 = _build.LOADS
    mesh = Mesh(SHARDS, dev, group=group)
    res = _rank_path(K, "serve", lambda: serve(
        dev, *(kv if small else ()), mesh=mesh,
        **({"requests": small["requests"]} if small else {})), out)
    for k in ("versions_sha256", "state_sha256", "ticks",
              "coherence_rounds", "tokens_generated"):
        assert res[k] == spec["flat_serve"][k], \
            f"rank {rank}: the serve's {k} differs from the flat serve's"
    torch.cuda.empty_cache()
    res = _rank_path(K, "tree", lambda: sharded_tree(
        dev, mesh, collections.Counter(), **(small or {}).get("tree", {})),
        out)
    assert res["state_sha256"] == spec["tree_sha256"], \
        f"rank {rank}: the tree's state differs from the one-process run's"
    gc.collect()
    torch.cuda.empty_cache()
    logits = os.path.join(tmp, "deepseek_ranks.npz")
    res = _rank_path(K, "deepseek", lambda: lm_serve(
        K, SHARDED_ARCH, 4, "flash_attention", 0 if small else 28, 0, 4,
        small["prompt"] if small else 512, RANK_GEN,
        flags=("--production-mesh", "--teacher", spec["logits"],
               "--logits-out", logits)
        + (("--smoke", "--device", "cpu") if small else ())), out)
    assert res["mesh"] == {"data": 16, "model": 16} and res["ep"] == 16
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        got, want = np.load(logits), np.load(spec["logits"])
        ref = want["logits"][:RANK_GEN + 1]
        err = float(np.abs(got["logits"] - ref).max())
        scale = float(np.abs(ref).max())
        out["deepseek_logits"] = {
            "steps": int(ref.shape[0]), "max_abs_err": err, "scale": scale,
            "rel_err": err / scale, "tolerance_rel": REPLAY_TOL,
            "rel_err_by_step": [float(np.abs(a - b).max()) / scale
                                for a, b in zip(got["logits"], ref)],
            "argmax_agree": float((got["logits"].argmax(-1)
                                   == ref.argmax(-1)).mean())}
        assert np.array_equal(got["inputs"],
                              want["inputs"][:, :RANK_GEN]), "teacher"
        assert err <= REPLAY_TOL * scale, \
            f"deepseek over ranks off the one-process logits: " \
            f"{out['deepseek_logits']}"
    if not small:
        ep = _rank_path(K, "moe_check", lambda: moe_card_check(
            dev, mesh=make_production_mesh(device=dev, group=group)), out)
        assert ep["shards_checked_here"] == 16 // world
    _rank_path(K, "pipeline", lambda: pipeline_check(
        dev, mesh=Mesh({"pipe": PIPE_STAGES}, dev, group=group),
        **(small or {}).get("pipe", {})), out)
    gc.collect()
    torch.cuda.empty_cache()
    _rank_path(K, "train", lambda: rank_train(dev, K, spec["train"], small),
               out)
    out["kernel_loads"] = _build.LOADS - loads0
    out["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    pd.finish()


def nccl_world1(dev, tmp) -> dict:
    """A world-1 ``nccl`` group on the card: one ``all_to_all_single``
    and one ``all_reduce`` through a ranked mesh, against their
    inputs."""
    from repro_torch.core.rounds import Mesh
    from repro_torch.parallel import dist as pd
    group, d = pd.init(init_method="file://" + os.path.join(tmp, "nccl1"),
                       device=dev)
    try:
        backend = torch.distributed.get_backend(group)
        assert backend == "nccl", backend
        mesh = Mesh(SHARDS, d, group=group)
        x = torch.arange(4096, dtype=torch.int32, device=d)
        y = mesh.all_to_all(x)
        z = mesh.all_reduce(torch.ones(1024, device=d))
        torch.cuda.synchronize()
        assert torch.equal(y, x) and bool((z == 1).all())
    finally:
        pd.finish()
    return {"backend": backend, "all_to_all_single": "ok",
            "all_reduce": "ok"}


def ranks_phase(dev, flat_serve, tree_sha, logits_ref, train_ref):
    """Phase 7d: the ``shard_map`` bodies over :data:`RANKS` gloo ranks
    that share the card (:func:`rank_main`, spawned after the parent
    frees its cached memory, joined within :data:`RANK_JOIN_S`; a
    failing or late rank ends the run), then a world-1 nccl group
    (:func:`nccl_world1`).  ``train_ref`` is phase 7b's training run
    (its losses and grad norms).  Prints each rank's record; returns the
    ranks' launches by kernel, summed, on the serve paths and on the
    train path."""
    from repro_torch.parallel.dist import spawn
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump({"flat_serve": flat_serve, "tree_sha256": tree_sha,
                       "logits": logits_ref, "train": train_ref}, f)
        gc.collect()
        torch.cuda.empty_cache()
        parent_gb = torch.cuda.memory_allocated() / 1e9
        seconds = spawn(rank_main, RANKS, args=(tmp,), timeout=RANK_JOIN_S)
        recs = [json.loads(open(os.path.join(tmp, f"rank{r}.json")).read())
                for r in range(RANKS)]
        nccl = nccl_world1(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches, train_launches = collections.Counter(), collections.Counter()
    for rec in recs:
        paths = {p: rec[p] for p in ("serve", "tree", "deepseek",
                                     "moe_check", "pipeline", "train")}
        log(f"ranks rank {rec['rank']}: " + json.dumps({
            "backend": rec["backend"], "device": rec["device"],
            "join_s": rec["join_s"], "wall_s": rec["wall_s"],
            "kernel_loads": rec["kernel_loads"],
            **{p: {"wall_s": v["wall_s"],
                   "launches": {k: n for k, n in v["launches"].items()
                                if n},
                   "collectives": v["collectives"]}
               for p, v in paths.items()}}))
        for name, path in (("latch_ops", "serve"), ("gcl_fetch", "serve"),
                           ("paged_attention", "serve"),
                           ("latch_ops", "tree"), ("gcl_fetch", "tree"),
                           ("flash_attention", "deepseek")):
            assert rec[path]["launches"][name] > 0, \
                f"rank {rec['rank']}: {name} never launched on its {path}"
        for p in ("serve", "tree", "deepseek"):
            launches.update(rec[p]["launches"])
        tr = rec["train"]["result"]
        log(f"ranks train rank {rec['rank']}: " + json.dumps({
            k: tr[k] for k in ("steady_step_ms", "step_ms", "peak_mem_gb",
                               "collectives_per_step", "launches_per_step",
                               "losses", "step0_grad_norm_rel",
                               "loss_rel_err_by_step")}))
        for name in ("flash_attention", "flash_attention_bwd"):
            assert rec["train"]["launches"][name] > 0, \
                f"rank {rec['rank']}: {name} never launched on its train"
        train_launches.update(tr["launches_total"])
    digests = [r["train"]["result"]["grad_digest_replicated"] for r in recs]
    assert digests[0] and all(d == digests[0] for d in digests), \
        "the replicated gradients differ across the ranks at step 0"
    out = {"ranks": RANKS, "backend": recs[0]["backend"],
           "spawn_to_join_s": seconds, "parent_allocated_gb": parent_gb,
           "host_staging": "none: the ranks hand gloo their CUDA tensors "
                           "for all_to_all_single and all_reduce",
           "serve_wall_s": [r["serve"]["wall_s"] for r in recs],
           "serve_tokens": recs[0]["serve"]["result"]["tokens_generated"],
           "tree_wall_s": [r["tree"]["wall_s"] for r in recs],
           "tree_lookups_per_s": recs[0]["tree"]["result"]["ycsb_c"][
               "lookups_per_s"],
           "deepseek_wall_s": [r["deepseek"]["wall_s"] for r in recs],
           "deepseek_peak_gb_a_rank": [r["deepseek"]["result"]["peak_mem_gb"]
                                       for r in recs],
           "deepseek_logits": recs[0]["deepseek_logits"],
           "moe_check_rel_err": [r["moe_check"]["result"]["rel_err"]
                                 for r in recs],
           "pipeline_max_rel_err": recs[0]["pipeline"]["result"][
               "max_rel_err"],
           "pipeline_ms": recs[0]["pipeline"]["result"]["pipeline_ms"],
           "pipeline_loop_ms": recs[0]["pipeline"]["result"]["loop_ms"],
           "train_wall_s": [r["train"]["wall_s"] for r in recs],
           "train_steady_step_ms": [r["train"]["result"]["steady_step_ms"]
                                    for r in recs],
           "train_peak_gb_a_rank": [r["train"]["result"]["peak_mem_gb"]
                                    for r in recs],
           "train_collectives_per_step": recs[0]["train"]["result"][
               "collectives_per_step"],
           "train_step0_loss_bit_equal": all(
               r["train"]["result"]["step0_loss_bit_equal"] for r in recs),
           "train_step0_grad_norm_rel": recs[0]["train"]["result"][
               "step0_grad_norm_rel"],
           "train_loss_rel_err_max": max(max(
               r["train"]["result"]["loss_rel_err_by_step"]) for r in recs),
           "train_replicated_grad_leaves_equal": len(digests[0]),
           "nccl_world1": nccl}
    log("ranks: " + json.dumps(out))
    return dict(launches), dict(train_launches)


# ---------------------------------------------- phase 7c: the dry-run

# (a) production cells counted on fake tensors: (arch, shape, multi-pod)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", False),
                ("qwen3-1.7b", "prefill_32k", False),
                ("qwen3-1.7b", "decode_32k", False),
                ("deepseek-moe-16b", "train_4k", False),
                ("mamba2-2.7b", "long_500k", False),
                ("qwen3-1.7b", "decode_32k", True))
# (b) steps counted on fake tensors and run on the card, make_local_mesh:
# name -> (arch, layers (None: all), kind, seq, batch).  qwen3-1.7b's train
# step at one 4096-token sequence (a device's share of train_4k) and its
# decode step at batch 1 over a 32768-token cache, at full width and
# depth; mamba2-2.7b's train step at 8 of its 64 layers, so that K5 and
# its backward run on this path too
CARD_CELLS = {"qwen3_train": ("qwen3-1.7b", None, "train", 4096, 1),
              "qwen3_decode": ("qwen3-1.7b", None, "decode", 32768, 1),
              "mamba2_train": ("mamba2-2.7b", 8, "train", 4096, 1)}
CARD_STEPS = 5                      # timed steps, after 2 warm-up steps
# predicted peak vs torch.cuda.max_memory_allocated over a warmed step,
# relative.  The count sees every storage an op returns, not what the
# CUDA implementations allocate inside an op and free before returning,
# nor the allocator's rounding.  Readings: at most 1.9e-6 after the
# earlier phases; 0.29 % with this phase run alone and its first step
# measured, 67 MB above the count, which is what cuBLAS's and cuBLASLt's
# workspaces (32 MiB each) take on a stream's first products: the
# measured step now follows a warm-up step, with what stays resident
# after it taken off
DRYRUN_MEM_TOL = 0.01


def _card_cell(name):
    """(cfg, ShapeSpec) of a :data:`CARD_CELLS` entry."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeSpec
    arch, layers, kind, seq, batch = CARD_CELLS[name]
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    return cfg, ShapeSpec(f"card_{name}", seq, batch, kind)


def dryrun_cells(out_dir) -> None:
    """The phase's CPU half (no card): :data:`DRYRUN_CELLS` through
    ``dryrun.run_cell`` into ``out_dir``, and :data:`CARD_CELLS` through
    ``dryrun.measure`` on ``make_local_mesh()`` into
    ``out_dir/card_<name>.json``."""
    from pathlib import Path
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    out = Path(out_dir)
    for arch, shape, multi_pod in DRYRUN_CELLS:
        dryrun.run_cell(arch, shape, multi_pod, out, force=True)
    for name in CARD_CELLS:
        cfg, sh = _card_cell(name)
        got = dryrun.measure(cfg, sh, make_local_mesh("cpu"))
        (out / f"card_{name}.json").write_text(json.dumps(got))


def dryrun_start(out_dir) -> subprocess.Popen:
    """:func:`dryrun_cells` in a child process (fake tensors: the CPU
    only), so it runs beside the card phases; :func:`dryrun_phase` waits
    for it."""
    code = ("import sys, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "torch.set_num_threads(1); import chip_smoke; "
            "chip_smoke.dryrun_cells(sys.argv[3])")
    log_path = os.path.join(out_dir, "dryrun.log")
    with open(log_path, "w") as fh:
        return subprocess.Popen([sys.executable, "-c", code, ROOT,
                                 os.path.join(ROOT, "src"), out_dir],
                                stdout=fh, stderr=subprocess.STDOUT)


def _card_inputs(dev, cfg, sh, gen):
    """The card cell's arguments on the card: a seeded train state and
    token batch, or seeded parameters, a cache of sh.seq_len positions
    (filled to 16 short of its end) and a token."""
    from repro_torch.models import lm
    from repro_torch.train import TrainConfig, init_train_state
    toks = lambda shape: torch.randint(0, cfg.vocab, shape, generator=gen,
                                       device=dev, dtype=torch.int32)
    if sh.kind == "train":
        state = init_train_state(cfg, TrainConfig(), gen, dev)
        return state, {"tokens": toks((sh.global_batch, sh.seq_len)),
                       "labels": toks((sh.global_batch, sh.seq_len))}
    params = lm.init_params(cfg, gen, dev)
    cache = lm.init_decode_cache(cfg, sh.global_batch, sh.seq_len,
                                 device=dev)
    cache["pos"].fill_(sh.seq_len - 16)
    return (params, cache), toks((sh.global_batch, 1))


def card_step_check(dev, K, name, pred):
    """One :data:`CARD_CELLS` step on the card, after a warm-up step,
    beside its dry-run count ``pred``: ``FlopCounterMode`` over the step
    counts exactly the dry-run's products outside the kernels (K4's and
    K5's are ``ctypes`` launches it cannot see: the wrappers' ``flops``
    counters equal the dry-run's kernel terms exactly, printed beside
    its CPU-route attention and SSD terms); the median of
    :data:`CARD_STEPS` warmed steps at least the dry-run's roofline
    bound, which counts K4 and K5 as the kernels do (a share of at most
    1); the step's ``max_memory_allocated`` above what the warm-up left
    resident beside the arguments at least their predicted bytes and
    within :data:`DRYRUN_MEM_TOL` of the predicted peak."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import TrainConfig, build_serve_step, \
        build_train_step
    cfg, sh = _card_cell(name)
    mesh = make_local_mesh(dev)
    if sh.kind == "train":
        step, _, n_micro = build_train_step(cfg, mesh, TrainConfig(),
                                            global_batch=sh.global_batch)
        assert n_micro == pred["meta"]["n_micro"] == 1
    else:
        serve_step, _, _ = build_serve_step(cfg, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    args, batch = _card_inputs(dev, cfg, sh, gen)

    def run():
        nonlocal args
        if sh.kind == "train":
            args, _ = step(args, batch)
        else:
            with torch.no_grad():
                logits, cache = serve_step(args[0], args[1], batch)
            args = (args[0], cache)
    torch.cuda.synchronize()
    arg_bytes = torch.cuda.memory_allocated() - base
    run()
    torch.cuda.synchronize()
    # what the warm-up left resident beside the arguments (library
    # workspaces) is no part of the step
    resident = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with FlopCounterMode(display=False) as fc:
        run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    launches = K.launch_counts()
    kernel_flops = K.flop_counts()
    outside = fc.get_total_flops()
    times = []
    for _ in range(CARD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del args, batch
    gc.collect()
    torch.cuda.empty_cache()
    count, rl = pred["count"], pred["roofline"]
    mem = count["memory"]
    step_s = statistics.median(times)
    share = rl["bound_s"] / step_s
    mem_rel = abs(peak - mem["peak_bytes_one_device"]) \
        / mem["peak_bytes_one_device"]
    out = {"cell": name, "arch": cfg.name, "layers": cfg.n_layers,
           "kind": sh.kind, "seq": sh.seq_len, "batch": sh.global_batch,
           "outside_flops_card": outside,
           "outside_flops_dryrun": count["outside_flops"],
           "attention_flops_dryrun": count["attention_flops"],
           "ssd_flops_dryrun": count["ssd_flops"],
           "attention_kernel_flops_dryrun": count["attention_kernel_flops"],
           "ssd_kernel_flops_dryrun": count["ssd_kernel_flops"],
           "kernel_flops_card": {k: v for k, v in kernel_flops.items()
                                 if v},
           "launches": {k: v for k, v in launches.items() if v},
           "step_ms": [t * 1e3 for t in times], "median_step_ms":
           step_s * 1e3, "roofline_bound_ms": rl["bound_s"] * 1e3,
           "dominant": rl["dominant"], "share_of_bound": share,
           "t_compute_ms": rl["t_compute_s"] * 1e3,
           "t_memory_ms": rl["t_memory_s"] * 1e3,
           "model_flops": rl["model_flops"],
           "peak_bytes_card": peak,
           "peak_bytes_dryrun": mem["peak_bytes_one_device"],
           "arg_bytes_card": arg_bytes,
           "arg_bytes_dryrun": mem["argument_bytes"],
           "peak_rel_err": mem_rel, "peak_tolerance": DRYRUN_MEM_TOL}
    log(f"dryrun card {name}: " + json.dumps(out))
    assert outside == count["outside_flops"], \
        f"{name}: the card counts {outside} FLOPs outside the kernels, " \
        f"the dry-run {count['outside_flops']}"
    for term, wrappers in (("attention", ("flash_attention",
                                          "flash_attention_bwd")),
                           ("ssd", ("ssd_intra", "ssd_intra_bwd"))):
        card = sum(kernel_flops[w] for w in wrappers)
        assert card == count[f"{term}_kernel_flops"], \
            f"{name}: the card's {term} kernels did {card} operations, " \
            f"the dry-run counts {count[f'{term}_kernel_flops']}"
    assert share <= 1.0, f"{name}: the step ({step_s * 1e3} ms) beats " \
        f"its roofline bound ({rl['bound_s'] * 1e3} ms): share {share}"
    assert peak >= mem["argument_bytes"], \
        f"{name}: peak {peak} below the predicted arguments " \
        f"{mem['argument_bytes']}"
    assert mem_rel <= DRYRUN_MEM_TOL, \
        f"{name}: peak {peak} vs predicted {mem['peak_bytes_one_device']}" \
        f" ({mem_rel} > {DRYRUN_MEM_TOL})"
    return out, launches


def dryrun_phase(dev, K, proc, out_dir):
    """Phase 7c: (a) :data:`DRYRUN_CELLS` counted on fake tensors by the
    child :func:`dryrun_start` started (each ``status == "ok"``, one line
    a cell: roofline terms, dominant term, bytes a device, fits_80GB);
    (b) :data:`CARD_CELLS` on the card against their dry-run
    (:func:`card_step_check`).  Returns the phase's record and the K4 and
    K5 launches of (b)."""
    from pathlib import Path
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    out = Path(out_dir)
    assert rc == 0, "the dry-run child failed:\n" + \
        (out / "dryrun.log").read_text()[-3000:]
    cells = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        mesh = "pod2x16x16" if multi_pod else "pod16x16"
        rec = json.loads((out / f"{arch}__{shape}__{mesh}.json").read_text())
        assert rec["status"] == "ok", f"dry-run {arch} {shape} {mesh}: " \
            f"{rec.get('error')}\n{rec.get('traceback', '')}"
        rl, ma = rec["roofline"], rec["memory_analysis"]
        line = {"cell": f"{arch} {shape} {mesh}",
                **{k: rl[k] for k in ("t_compute_s", "t_memory_s",
                                      "t_collective_s", "dominant",
                                      "roofline_fraction")},
                "argument_gb": ma["argument_bytes"] / 1e9,
                "per_device_gb": ma["per_device_total"] / 1e9,
                "fits_80GB": ma["fits_80GB"], "wall_s": rec["wall_s"]}
        log("dryrun " + json.dumps(line))
        cells.append(line)
    checks, launches = {}, collections.Counter()
    for name in CARD_CELLS:
        pred = json.loads((out / f"card_{name}.json").read_text())
        checks[name], got = card_step_check(dev, K, name, pred)
        launches.update(got)
    for name in ("flash_attention", "flash_attention_bwd", "ssd_intra",
                 "ssd_intra_bwd"):
        assert launches[name] > 0, f"{name} never launched on the " \
            f"dry-run's card steps"
    res = {"cells": len(cells), "card": {
        k: {f: v[f] for f in ("median_step_ms", "roofline_bound_ms",
                              "share_of_bound", "peak_rel_err")}
        for k, v in checks.items()},
        "waited_for_child_s": waited, "seconds": time.perf_counter() - t0}
    log("dryrun: " + json.dumps(res))
    return res, dict(launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    out_dir = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s -> {out_dir}")
    dryrun_dir = tempfile.mkdtemp(prefix="dryrun_")
    dryrun_proc = dryrun_start(dryrun_dir)
    try:
        return _main(dev, K, _build, t_start, dryrun_proc, dryrun_dir)
    finally:
        if dryrun_proc.poll() is None:
            dryrun_proc.kill()
            dryrun_proc.wait()
        shutil.rmtree(dryrun_dir, ignore_errors=True)


def _main(dev, K, _build, t_start, dryrun_proc, dryrun_dir) -> int:
    """The phases after the build (see the module docstring)."""
    for name, text in sorted(_build.BUILD_LOG.items()):
        funcs = ptxas_functions(text)
        log(f"  ptxas {name}: {len(funcs)} kernels, at most "
            f"{max((r for _, r, _ in funcs), default=0)} registers, "
            f"{sum(sp for _, _, sp in funcs)} spill bytes")
        if name in ("flash_attention", "paged_attention", "ssd_intra",
                    "flash_attention_bwd", "ssd_intra_bwd"):
            for fn, r, sp in funcs:
                log(f"    {fn}: {r} registers, {sp} spill bytes")
    if "flash_attention" in _build.BUILD_LOG:
        tc128 = [sp for fn, _, sp in ptxas_functions(
            _build.BUILD_LOG["flash_attention"])
            if "flash_attention_bf16_kernel<128," in fn
            or "flash_attention_bf16_kernelILi128E" in fn]
        # with and without a window, with and without Sq != Sk or an
        # offset, each with and without the log-sum-exp output
        assert tc128 == [0] * 8, f"K4 bf16 at hd 128 spills: {tc128}"
    for name in ("flash_attention_bwd", "ssd_intra_bwd"):
        if name in _build.BUILD_LOG:
            spills = [sp for _, _, sp in ptxas_functions(
                _build.BUILD_LOG[name])]
            # K4's backward: the wgmma dQ and dK/dV passes and the fp32
            # kernel's two roles, at hd 64, 128 and 256; K5's (3xTF32): P
            # 16, 32, 64 and 128
            assert spills == [0] * (12 if name == "flash_attention_bwd"
                                    else 4), f"{name} spills: {spills}"
    if "ssd_intra" in _build.BUILD_LOG:
        f32p64 = [sp for fn, _, sp in ptxas_functions(
            _build.BUILD_LOG["ssd_intra"])
            if "ssd_intra_kernel<float, 8>" in fn
            or "ssd_intra_kernelIfLi8E" in fn]
        assert f32p64 == [0], f"K5 fp32 at P 64 spills: {f32p64}"

    meta = {
        "latch_ops": ("src/repro_torch/csrc/latch_ops.cu",
                      "src/repro/kernels/latch_ops/latch_ops.py:90"),
        "gcl_fetch": ("src/repro_torch/csrc/gcl_fetch.cu",
                      "src/repro/kernels/gcl_fetch/gcl_fetch.py:63"),
        "paged_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:108"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:90"),
        "ssd_intra": ("src/repro_torch/csrc/ssd_intra.cu",
                      "src/repro/kernels/ssd_intra/ssd_intra.py:52"),
        # the backward of the TPU kernel's function (forward-only there)
        "flash_attention_bwd": (
            "src/repro_torch/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:90"),
        "ssd_intra_bwd": ("src/repro_torch/csrc/ssd_intra_bwd.cu",
                          "src/repro/kernels/ssd_intra/ssd_intra.py:52"),
    }
    rows = [check_latch(dev, K), check_fetch(dev, K),
            check_attention(dev, K), check_flash(dev, K),
            check_ssd(dev, K), check_flash_bwd(dev, K),
            check_ssd_bwd(dev, K)]
    rows[3].update(flash_window_cases(dev, K))
    rows[3].update(flash_cross_cases(dev, K))
    rows[0].update(latch_app_case(dev, K))
    rows[0].update(latch_app_case(dev, K, 1 << 20, 4096, "txn", "finalize"))
    rows[1].update(fetch_app_cases(dev, K))
    # a home's round on the 4-shard tree: 2^19 words a slab, 4 buckets
    # of 256 slots
    rows[0].update(latch_app_case(dev, K, BTREE_LINES // SHARDS, 1024,
                                  "shard"))
    rows[1].update(fetch_app_case(dev, K, BTREE_LINES // SHARDS, 40, 1024,
                                  0.0, "shard"))
    for row in rows[:2]:
        log(f"{row['name']} at the applications' shapes: " + ", ".join(
            f"{tag}: ms_graph20 {row[f'ms_graph20_{tag}']}, bound "
            f"{row[f'bound_ms_{tag}']} ({100 * row[f'words_share_{tag}']:.2f}"
            f" % of its bytes the words table)"
            + (f", index_select ms_graph20 "
               f"{row[f'library_ms_graph20_{tag}']}"
               if f"library_ms_graph20_{tag}" in row else "")
            for tag in ("btree", "txn", "shard")
            if f"ms_graph20_{tag}" in row))
    floor = launch_floor()
    log(f"launch floor (x.add_(1) on 1 element): ms {floor['ms']} "
        f"ms_graph20 {floor['ms_graph20']}")
    for row in rows:
        log(f"kernel {row['name']}: " + " ".join(
            f"{k} {v}" for k, v in row.items() if k != "name"))

    K.reset_launch_counts()
    with fetch_histogram() as hist:
        res = serve(dev)
    counts = K.launch_counts()
    flat_serve = res
    log("serve: " + json.dumps(res))
    calls = hist["calls"]
    log(f"serve gcl_fetch: {sum(calls.values())} calls; by (R, valid "
        f"rows): " + ", ".join(f"({r}, {v}) {n}"
                              for (r, v), n in calls.items())
        + "; valid rows whose page the call before named "
        f"{hist['named_before']}, an earlier call {hist['named_earlier']}, "
        f"none {hist['first']}")
    for name in ("latch_ops", "gcl_fetch", "paged_attention"):
        assert counts[name] > 0, f"kernel {name} never launched in the serve"
    assert counts["gcl_fetch"] == sum(calls.values()), \
        "a K2 call of the serve did not launch its kernel exactly once"
    log("serve with a recorder: " + json.dumps(serve_with_recorder(dev)))

    legacy, legacy_calls_ = legacy_phase(dev, K)
    log("legacy: " + json.dumps(legacy))
    for name, n in legacy["launches"].items():
        assert n > 0, f"kernel {name} never launched on the legacy path"
    for row, extra in zip(rows[:3], legacy_kernel_cases(dev, K,
                                                        legacy_calls_)):
        row.update(extra)
        log(f"{row['name']} at the legacy path's shape: " + json.dumps(
            extra))
    del legacy_calls_
    side_paths = {}
    for path, phase in (("placement", placement_phase),
                        ("bridge", bridge_phase)):
        K.reset_launch_counts()
        res = phase(dev)
        got = K.launch_counts()
        side_paths[path] = {k: got[k] for k in ("latch_ops", "gcl_fetch")}
        log(f"{path}: " + json.dumps(res))
        log(f"{path} launches: " + json.dumps(side_paths[path]))
        for name, n in side_paths[path].items():
            assert n > 0, f"kernel {name} never launched on the {path} path"
    t_ex = time.perf_counter()
    examples, example_launches = examples_phase(dev, K)
    log("examples: " + json.dumps(examples))
    log(f"examples phase: {time.perf_counter() - t_ex:.3f} s")
    K.reset_launch_counts()
    sharded = sharded_phase(dev, flat_serve)
    window = K.launch_counts()
    log("sharded: " + json.dumps({k: v for k, v in sharded.items()
                                  if k != "launches"}))
    log("sharded launches (the sharded calls alone): "
        + json.dumps(sharded["launches"]) + "; the phase's window, twins "
        "included: " + json.dumps({k: window[k] for k in sharded["launches"]}))
    for name, n in sharded["launches"].items():
        assert 0 < n <= window[name], \
            f"kernel {name} never launched on the sharded path"
    side_paths["sharded"] = {k: sharded["launches"][k]
                             for k in ("latch_ops", "gcl_fetch")}
    log("distributed_latch_round: " + json.dumps(sharded_latch_check(dev)))
    torch.cuda.empty_cache()

    lm_paths = {}
    for arch, n_req, name, per, per_step in (
            ("qwen3-1.7b", 16, "flash_attention", 28, 0),
            ("mamba2-2.7b", 8, "ssd_intra", 64, 0),
            ("deepseek-moe-16b", 8, "flash_attention", 28, 0),
            ("starcoder2-7b", 8, "flash_attention", 32, 0),
            ("recurrentgemma-2b", 8, "flash_attention", 8, 0),
            ("llava-next-mistral-7b", 8, "flash_attention", 32, 0),
            # 12 encoder, 12 decoder self and 12 cross layers a prefill;
            # the 12 cross layers at every decode step
            ("seamless-m4t-medium", 8, "flash_attention", 36, 12)):
        res = lm_serve(K, arch, n_req, name, per, per_step)
        log(f"lm {arch}: " + json.dumps(res))
        lm_paths[arch] = res["launches"][name]
        counts[name] = counts.get(name, 0) + res["launches"][name]
    for arch, n_layers, s, ring in (
            ("qwen3-1.7b", 4, 512, 0), ("mamba2-2.7b", 4, 512, 0),
            ("deepseek-moe-16b", 4, 512, 0), ("starcoder2-7b", 4, 512, 0),
            ("dbrx-132b", 2, 128, 0), ("command-r-plus-104b", 2, 128, 0),
            ("llama3-405b", 2, 128, 0), ("recurrentgemma-2b", 3, 2304, 8)):
        replay_check(dev, arch, n_layers, s, ring)
    vlm_continuation(dev)
    encdec_replay(dev)
    moe_card_check(dev)

    by_path = {"serve": {k: counts[k] for k in ("latch_ops", "gcl_fetch")},
               "legacy": {k: legacy["launches"][k]
                          for k in ("latch_ops", "gcl_fetch")},
               **side_paths}
    for name in ("latch_ops", "gcl_fetch"):
        counts[name] += sum(c[name] for p, c in by_path.items()
                            if p != "serve")
    rows[2]["launches_by_path"] = {
        "serve": counts["paged_attention"],
        "legacy": legacy["launches"]["paged_attention"],
        "sharded": sharded["launches"]["paged_attention"]}
    counts["paged_attention"] += (legacy["launches"]["paged_attention"]
                                  + sharded["launches"]["paged_attention"])
    for path, phase in (("btree", btree_phase), ("txn", txn_phase)):
        K.reset_launch_counts()
        res = phase(dev)
        got = K.launch_counts()
        by_path[path] = {k: got[k] for k in ("latch_ops", "gcl_fetch")}
        log(f"{path}: " + json.dumps(res))
        log(f"{path} launches: " + json.dumps(by_path[path]))
        for name, n in by_path[path].items():
            assert n > 0, f"kernel {name} never launched on the {path} path"
            counts[name] += n
        if path == "btree":
            flat, shd = res, sharded["tree"]
            log("tree, flat vs 4 shards: lookups/s " + json.dumps([
                flat["ycsb_c"]["lookups_per_s"],
                shd["ycsb_c"]["lookups_per_s"]]) + ", upserts/s "
                + json.dumps([flat["ycsb_a"]["upserts_per_s"],
                              shd["ycsb_a"]["upserts_per_s"]]))
        else:
            log("txn, flat vs 4 shards: commits/s " + json.dumps({
                a: [res[a]["commits_per_s"],
                    sharded["txn"][a]["commits_per_s"]]
                for a in ("2pl", "to")}))
    t_new = time.perf_counter()
    oracle = None
    for path, phase in (("des_oracle", des_txn_oracle),
                        ("fig7_rounds", rounds_fig7_phase)):
        K.reset_launch_counts()
        res = phase(dev)
        got = K.launch_counts()
        by_path[path] = {k: got[k] for k in ("latch_ops", "gcl_fetch")}
        log(f"{path}: " + json.dumps(res))
        log(f"{path} launches: " + json.dumps(by_path[path]))
        for name, n in by_path[path].items():
            assert n > 0, f"kernel {name} never launched on the {path} path"
            counts[name] += n
        if path == "des_oracle":
            oracle = res
        else:
            log("fig7 rounds per batch: " + json.dumps({
                f"{r['lines']}x{r['r']} w{r['payload_width']} "
                f"{'wb' if r['write_back'] else 'wt'}":
                r["rounds_per_batch"] for r in res["runs"]}))
    fig11 = des_fig11_cell()
    log("fig11 host cell (DES time units, not seconds): "
        + json.dumps(fig11) + "; the card's commits/s on the same batches: "
        + json.dumps({a: oracle["flat"][a]["commits_per_s"]
                      for a in ("2pl", "to")}))
    log(f"DES oracle, Fig. 11 host cell and Fig. 7 rounds: "
        f"{time.perf_counter() - t_new:.3f} s")
    train = collections.defaultdict(dict)     # kernel -> arch -> launches
    for arch, kw in TRAIN_RUNS.items():
        _, got = train_run(dev, K, arch, **kw)
        for name, n in got.items():
            if n:
                train[name][arch] = n
                counts[name] = counts.get(name, 0) + n
    for arch, (n_layers, seq) in TRAIN_PLAIN.items():
        train_plain_check(dev, K, arch, n_layers, seq=seq)
    train_resume_check(dev)
    logits_dir = tempfile.mkdtemp(prefix="logits_")
    try:
        logits_ref = os.path.join(logits_dir, "deepseek_one_process.npz")
        sharded_out, sharded_lm = sharded_lm_phase(dev, K,
                                                   logits_out=logits_ref)
        for path in sharded_lm.values():
            for name, n in path.items():
                counts[name] = counts.get(name, 0) + n
        _, dryrun_launches = dryrun_phase(dev, K, dryrun_proc, dryrun_dir)
        for name, n in dryrun_launches.items():
            counts[name] = counts.get(name, 0) + n
        t_ranks = time.perf_counter()
        rank_launches, rank_train_launches = ranks_phase(
            dev, flat_serve, sharded["tree"]["state_sha256"], logits_ref,
            {"losses": sharded_out["train_losses"],
             "grad_norms": sharded_out["train_grad_norms"]})
        log(f"phase 7d: {time.perf_counter() - t_ranks:.3f} s")
    finally:
        shutil.rmtree(logits_dir, ignore_errors=True)
    for launches in (rank_launches, rank_train_launches,
                     *example_launches.values()):
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n
    for ex, c in example_launches.items():
        by_path[f"example_{ex}"] = {k: c.get(k, 0)
                                    for k in ("latch_ops", "gcl_fetch")}
    by_path["ranks"] = {k: rank_launches.get(k, 0)
                        for k in ("latch_ops", "gcl_fetch")}
    rows[2]["launches_by_path"]["ranks"] = rank_launches.get(
        "paged_attention", 0)
    for ex, c in example_launches.items():
        rows[2]["launches_by_path"][f"example_{ex}"] = c.get(
            "paged_attention", 0)

    for row in rows[:2]:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()}
    rows[3]["launches_by_path"] = {a: n for a, n in lm_paths.items()
                                   if a != "mamba2-2.7b"}
    rows[4]["launches_by_path"] = {"mamba2-2.7b": lm_paths["mamba2-2.7b"]}
    for row in rows[3:]:
        row["launches_by_path"] = dict(
            row.get("launches_by_path", {}),
            train=sum(train[row["name"]].values()),
            **{f"sharded_lm_{p}": c[row["name"]]
               for p, c in sharded_lm.items()},
            dryrun_card=dryrun_launches.get(row["name"], 0),
            ranks=rank_launches.get(row["name"], 0),
            ranks_train=rank_train_launches.get(row["name"], 0),
            **{f"example_{ex}": c.get(row["name"], 0)
               for ex, c in example_launches.items()})
        row["train_launches_by_arch"] = train[row["name"]]

    kernels = []
    for row in rows:
        src, replaces = meta[row["name"]]
        kernels.append({"name": row["name"], "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": counts[row["name"]],
                        **{k: v for k, v in row.items() if k != "name"}})
    log(f"chip_smoke: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
