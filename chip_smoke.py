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
   hd 128 and llava's offset, from the forward's own log-sum-exp, beside
   autograd of SDPA; K4's forward with and without that output) and
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
   each K2 call once; print K2's calls counted by (R, valid rows);
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
   launches.  Phase 2 also holds K1 and K2 at these two paths' shapes
   (K1 at the tree's descent round and the txn FINALIZE spin's 4096
   slots, K2 at both paths' rows);
7. train Qwen3-1.7B and Mamba2-2.7B at full published width and depth
   through the port's ``launch.train.main`` (batch 4, seq 512, 8 steps,
   ``--micro 1``, remat, fp32 AdamW states; :func:`train_run`): finite
   losses and grad norms, a gradient for every parameter leaf, exactly
   2 forward and 1 backward launches of K4 (Qwen3) or K5 (Mamba2) a
   layer a step and nothing else; print step times, tokens/s, peak
   memory beside 12 bytes a parameter, and the device's busy share over
   one more step under ``torch.profiler``, with K4's and K5's forward and
   backward device time in that step; at full width and 4 layers,
   one step through the kernels against the same step with the plain
   versions forced on the card (:func:`train_plain_check`); and a
   checkpoint saved and resumed on the card (:func:`train_resume_check`,
   Mamba2-2.7B at 1 layer);
8. print the ``kernels`` JSON line (``launches`` counts every path:
   the serve, the LM serves, the tree, the transactions and the
   training runs, split by path in ``launches_by_path``), then the
   result line.

Needs one CUDA device; exits 1 without one, before printing anything
on standard output.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import shutil
import subprocess
import sys
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


def visible_pairs(sq, sk, causal, q_offset=0, window=None) -> int:
    """(query, key) pairs K4 computes: query row i at position q_offset +
    i sees the keys j < sk with j <= q_offset + i when causal and j >
    q_offset + i - window when a window is given."""
    pos = q_offset + np.arange(sq)
    hi = np.minimum(sk, pos + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


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
    pairs :func:`visible_pairs` counts) and SDPA's time for the same call
    (``is_causal`` where the queries and keys line up, no mask for the
    cross-attention, a boolean [Sq, Sk] mask for the offset).  Returns
    the K4 row's keys for each tag."""
    import torch.nn.functional as F
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


def check_flash_bwd(dev, K):
    """K4's backward at :data:`FLASH_BWD_CASES`, bf16, through the
    model's [B, S, H, hd] layout, from the forward's own output and
    log-sum-exp (``flash_attention_lse_launch``; the log-sum-exp held
    against the plain one within 1e-3): (dq, dk, dv) held against
    ``flash_attention_bwd_plain`` (:data:`BWD_TOL`: P and dS are rounded
    to bf16 before their products; and each gradient row within
    :data:`BWD_ROW_TOL` of its L2 norm, :func:`grad_row_rel`), timed beside its bound (5 products
    of 2 pairs hd operations over the bf16 peak, or its bytes: q, k, v,
    out, dout and lse read, dq, dk, dv written) and the library's time:
    autograd of ``F.scaled_dot_product_attention`` (forward and backward
    in one graph, less its forward alone).  At the Qwen3 shape also
    K4's forward with and without the log-sum-exp output (the serve
    passes none)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _launch_fwd, _visible, flash_attention_bwd_plain,
        flash_attention_plain)
    rng = np.random.default_rng(SEED + 11)
    row = {"name": "flash_attention_bwd"}
    for tag, (b, sq, sk, hq, hkv, hd, causal, off, window) in \
            FLASH_BWD_CASES.items():
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
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(g).all()) for g in got)
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
        case = {"max_abs_err": err, "row_err": row_rel,
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

def serve(dev, cfg=None, n_q_heads=16):
    """The main path: ``cfg`` defaults to ``KVPoolConfig()`` (1024 x 16
    tokens, 8 kv heads x 128, 4 replicas, bf16) and ``n_q_heads`` to
    Qwen3-1.7B's 16."""
    from repro_torch.core.rounds import check_invariants
    from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.serve import RequestState, ServeLoop, ToyLM, write_pages

    cfg = KVPoolConfig() if cfg is None else cfg
    pool = SELCCKVPool(cfg, device=dev)
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

    loop = ServeLoop(pool, model, n_slots=16, max_pages=16,
                     prefill_chunk=16, queue_capacity=64,
                     on_complete=on_complete)
    rng = np.random.default_rng(SEED + 3)
    reqs = []
    for i in range(48):
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
    check_invariants(pool.rounds_state)
    assert pool.pages_in_use == len(prefix), "pages leaked"
    return {"requests": len(reqs), "ticks": ticks,
            "tokens_generated": sum(len(r.generated) for r in reqs),
            "kv_rows_appended": st.appended_tokens,
            "coherence_rounds": st.rounds_total,
            "attend_calls": st.attend_calls, "wall_s": wall,
            "readbacks_checked": checked["readback"],
            "attends_checked": checked["attend"]}


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


# ------------------------------------------------------ phase 4: LM serve

def lm_serve(K, arch, requests, kernel, per_prefill, per_step=0, batch=4,
             prompt=512, gen=32):
    """The port's ``launch.serve.main`` at the full config of ``arch``;
    returns its counts and the kernels it launched.  ``kernel`` must have
    launched ``per_prefill`` times a prefill and ``per_step`` times a
    decode step, exactly."""
    from repro_torch.launch.serve import main as serve_main
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_main(["--arch", arch, "--requests", str(requests),
                      "--batch", str(batch), "--prompt-len", str(prompt),
                      "--gen", str(gen)])
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
            "launches": counts}


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


def moe_card_check(dev, n_tokens=2048):
    """``moe_ffn`` of one deepseek-moe-16b layer at full width
    (``src/repro/configs/deepseek_moe_16b.py``: d 2048, 64 routed experts
    of 1408, top 6, 2 shared) on ``n_tokens`` bf16 tokens that share a
    common direction, so the router crowds some experts past the
    published capacity (1.25: 244 slots) and assignments drop; against
    an independent reference: a per-token loop that ranks the fp32
    gates (the same router product, stable order), takes each
    assignment's slot from a running count per expert and drops it past
    the capacity, then applies every kept assignment in fp32 (per
    expert, over its kept tokens) with the shared experts.  The drop
    sets must be equal; the output within 2e-2 of the reference's scale
    (bf16 operands and a bf16 rounding of every product in the model's
    path)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    p = moe.init_moe(gen, cfg, torch.bfloat16)
    d, k, n_exp = cfg.d_model, cfg.top_k, cfg.n_experts
    x = (torch.randn((1, n_tokens, d), generator=gen, device=dev)
         + 1.5 * torch.randn((d,), generator=gen, device=dev)).bfloat16()
    with dispatch_calls() as calls:
        t0 = time.perf_counter()
        y, _ = moe.moe_ffn(x, p, cfg)
        torch.cuda.synchronize()
        port_s = time.perf_counter() - t0
    keep = calls[0][1][4]
    cap = moe._capacity(n_tokens, k, n_exp, cfg.capacity_factor)
    xt = x.reshape(n_tokens, d)
    gates = torch.softmax(xt.float() @ p["router"].float(), -1).cpu().numpy()
    count = np.zeros(n_exp, np.int64)
    kept = {e: ([], []) for e in range(n_exp)}       # tokens, weights
    ref_keep = np.zeros((n_tokens, k), bool)
    for t in range(n_tokens):
        order = np.argsort(-gates[t], kind="stable")[:k]
        w = gates[t][order] / max(float(gates[t][order].sum()), 1e-9)
        for j, e in enumerate(order):
            if count[e] < cap:
                kept[int(e)][0].append(t)
                kept[int(e)][1].append(float(w[j]))
                ref_keep[t, j] = True
            count[e] += 1
    port_keep = keep.cpu().numpy().reshape(n_tokens, k)
    assert np.array_equal(port_keep, ref_keep), \
        f"moe_ffn drops {int((~port_keep).sum())} assignments, the " \
        f"reference {int((~ref_keep).sum())}; they differ at " \
        f"{int((port_keep != ref_keep).sum())}"
    xf = xt.float()
    want = torch.zeros((n_tokens, d), device=dev)
    for e, (tok, w) in kept.items():
        if not tok:
            continue
        idx = torch.tensor(tok, device=dev)
        xe = xf[idx]
        h = torch.nn.functional.silu(xe @ p["we_g"][e].float()) \
            * (xe @ p["we_u"][e].float())
        want.index_add_(0, idx, (h @ p["we_d"][e].float())
                        * torch.tensor(w, device=dev)[:, None])
    sh = torch.nn.functional.silu(xf @ p["s_wg"].float()) \
        * (xf @ p["s_wu"].float())
    want += sh @ p["s_wd"].float()
    err = float((y.reshape(n_tokens, d).float() - want).abs().max())
    scale = float(want.abs().max())
    out = {"tokens": n_tokens, "capacity": cap,
           "dropped": int((~ref_keep).sum()),
           "experts_over_capacity": int((count > cap).sum()),
           "max_abs_err": err, "scale": scale, "rel_err": err / scale,
           "tolerance_rel": 2e-2, "port_s": port_s}
    log("moe_ffn card check: " + json.dumps(out))
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


def load_btree(dev, n_keys=BTREE_KEYS, n_lines=BTREE_LINES):
    """:func:`btree_image` carried onto ``dev`` as round state (a
    ``make_state``-shaped dict of numpy leaves through
    ``convert.to_torch``), adopted by ``DeviceBTree.open``.  Returns the
    tree and the oracle: ``value[key]`` for every key."""
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
    tree = DeviceBTree.open(convert.to_torch(state, dev), n_nodes=n)
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


# ------------------------------------------------------ phase 7: training

# arch -> (forward kernel, its launches a layer a step: the forward and
# the remat recompute; the backward kernel launches once a layer)
TRAIN_ARCHS = {"qwen3-1.7b": ("flash_attention", 28),
               "mamba2-2.7b": ("ssd_intra", 64)}
TRAIN_TOL = 5e-2   # kernels vs plain step, bf16: x each leaf's max |want|


def _train_cfg(steps):
    """``launch.train.main``'s TrainConfig for ``--steps steps --micro 1
    --lr 3e-4`` at a full config (remat on, fp32 AdamW states)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    return TrainConfig(micro_batches=1, remat=True, opt=AdamWConfig(
        lr=3e-4, warmup_steps=max(5, steps // 20), total_steps=steps))


def train_run(dev, K, arch, steps=8, batch=4, seq=512):
    """The port's ``launch.train.main`` at the full config of ``arch``
    (random bf16 weights, fp32 AdamW m and v, remat, ``--micro 1``):
    finite losses and grad norms, no parameter leaf without a gradient on
    the first step, and exactly the kernel launches of the path at every
    step (the forward kernel twice a layer, its backward once, nothing
    else); then one more step under ``torch.profiler`` for the device's
    busy share.  Returns the run's numbers and its launch counts."""
    from repro_torch import tree as pt
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import main as train_main
    from repro_torch.train import build_train_step
    name, layers = TRAIN_ARCHS[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
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
    want = dict.fromkeys(K.WRAPPERS, 0)
    want.update({name: 2 * layers, f"{name}_bwd": layers})
    for i, got in enumerate(rec["launches"]):
        assert got == want, f"{arch} step {i}: launches {got}, want {want}"
    n_params = sum(t.numel() for t in pt.leaves(state["params"]))
    cfg = get_config(arch)
    step_fn, _, _ = build_train_step(cfg, _train_cfg(steps),
                                     global_batch=batch, device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=batch,
                                  seq_len=seq))
    b = data.batch_at(steps)
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
    del state
    torch.cuda.empty_cache()
    ms = rec["step_ms"]
    steady = float(np.median(ms[1:]))
    out = {"arch": arch, "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "steps": steps, "losses": rec["losses"],
           "grad_norms": rec["grad_norms"], "step_ms": ms,
           "steady_step_ms": steady,
           "tokens_per_s": rec["tokens_per_step"] / steady * 1e3,
           "peak_mem_gb": peak / 1e9, "params": n_params,
           "reckoned_state_gb": 12 * n_params / 1e9,
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
    """Full width, ``n_layers`` layers: one training step's loss and
    every gradient leaf through the kernels (forward, recompute and
    backward) against the same step with the plain versions forced on the
    card (:func:`plain_paths`), bf16: the loss within 1e-2 of itself and
    each leaf within :data:`TRAIN_TOL` of its max |want| (the kernels
    round P, and in the backward dS, to bf16 where the plain attention
    keeps fp32, and the difference passes through the layers)."""
    from repro_torch import tree as pt
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train.step import value_and_grad
    name, _ = TRAIN_ARCHS[arch]
    cfg = get_config(arch).replace(n_layers=n_layers)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 13), dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(DataConfig(
        vocab=cfg.vocab, batch=batch, seq_len=seq)).batch_at(0).items()}

    def loss_fn(p, bt):
        return lm.train_loss(p, bt, cfg, lm.NO_PARALLEL, remat=True)
    K.reset_launch_counts()
    loss, grads, missing = value_and_grad(loss_fn, params, b)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert missing == 0
    assert counts[name] == 2 * n_layers and \
        counts[f"{name}_bwd"] == n_layers, counts
    with plain_paths():
        want_loss, want, _ = value_and_grad(loss_fn, params, b)
    torch.cuda.synchronize()
    assert K.launch_counts() == counts, "the plain step launched a kernel"
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    worst = 0.0
    for i, (g, w) in enumerate(zip(pt.leaves(grads), pt.leaves(want))):
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        assert np.isfinite(err) and err <= TRAIN_TOL * scale, \
            f"{arch}: gradient leaf {i} off by {err} (max |want| {scale}, " \
            f"tol {TRAIN_TOL})"
        worst = max(worst, err / max(scale, 1e-30))
    assert loss_rel < 1e-2, f"{arch}: loss {float(loss)} vs plain " \
        f"{float(want_loss)}"
    out = {"arch": arch, "layers": n_layers, "loss": float(loss),
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
    from repro_torch.train import build_train_step, init_train_state
    cfg = get_config(arch).replace(n_layers=n_layers)
    tcfg = _train_cfg(steps)
    step_fn, _, _ = build_train_step(cfg, tcfg, global_batch=batch,
                                     device=dev)
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
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    out_dir = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s -> {out_dir}")
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
            # kernel's two roles, at hd 64 and 128; K5's (3xTF32): P 16,
            # 32, 64 and 128
            assert spills == [0] * (8 if name == "flash_attention_bwd"
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
    for row in rows[:2]:
        log(f"{row['name']} at the applications' shapes: " + ", ".join(
            f"{tag}: ms_graph20 {row[f'ms_graph20_{tag}']}, bound "
            f"{row[f'bound_ms_{tag}']} ({100 * row[f'words_share_{tag}']:.2f}"
            f" % of its bytes the words table)"
            + (f", index_select ms_graph20 "
               f"{row[f'library_ms_graph20_{tag}']}"
               if f"library_ms_graph20_{tag}" in row else "")
            for tag in ("btree", "txn") if f"ms_graph20_{tag}" in row))
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

    by_path = {"serve": {k: counts[k] for k in ("latch_ops", "gcl_fetch")}}
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
    train = {}
    for arch in TRAIN_ARCHS:
        _, got = train_run(dev, K, arch)
        for name, n in got.items():
            if n:
                train[name] = n
                counts[name] = counts.get(name, 0) + n
    for arch in TRAIN_ARCHS:
        train_plain_check(dev, K, arch)
    train_resume_check(dev)

    for row in rows[:2]:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()}
    rows[3]["launches_by_path"] = {a: n for a, n in lm_paths.items()
                                   if a != "mamba2-2.7b"}
    rows[4]["launches_by_path"] = {"mamba2-2.7b": lm_paths["mamba2-2.7b"]}
    for row in rows[3:]:
        row["launches_by_path"] = dict(row.get("launches_by_path", {}),
                                       train=train[row["name"]])

    kernels = []
    for row in rows:
        src, replaces = meta[row["name"]]
        kernels.append({"name": row["name"], "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": counts[row["name"]],
                        **{k: v for k, v in row.items() if k != "name"}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
