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
   with rotating rows, and K2-K4's library calls on both timers;
3. serve ~48 seeded requests through ``SELCCKVPool`` + ``ServeLoop`` at
   the attention width of Qwen3-1.7B (16 query heads, 8 kv heads, head
   dim 128; ``src/repro/configs/qwen3_1p7b.py``) over the default pool
   (1024 pages x 16 tokens, 4 replicas, bf16: one layer's KV for 16,384
   tokens), checking every completion's KV readback bit for bit
   against ``ToyLM.expected_pages``, a sample of attend outputs against
   the plain kernel over the oracle bytes, the coherence invariants,
   the page accounting, and that every kernel launched during the run,
   each K2 call once; print K2's calls counted by (R, valid rows);
4. serve Qwen3-1.7B and then Mamba2-2.7B at full published width and
   depth (``src/repro/configs/qwen3_1p7b.py``, ``mamba2_2p7b.py``; random
   bf16 weights from a seeded ``torch.Generator`` on the card) through
   the port's ``launch.serve.main``: 16 and 8 requests, batch 4, prompt
   512, 32 generated tokens each; check finite logits, every token, and
   that K4 ran once per layer per prefill (Qwen3) and K5 likewise
   (Mamba2); then, at full width and 4 layers, hold a 512-token prefill
   against its token-by-token replay through ``decode_step`` (the plain
   decode path) and time the fp32 head product of a decode step;
5. print the ``kernels`` JSON line, then the result line.

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

def lm_serve(K, arch, requests, kernel, per_prefill, batch=4, prompt=512,
             gen=32):
    """The port's ``launch.serve.main`` at the full config of ``arch``;
    returns its counts and the kernels it launched."""
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
    assert counts[kernel] == per_prefill * prefills, \
        f"{arch}: {kernel} launched {counts[kernel]} times, expected " \
        f"{per_prefill} x {prefills}"
    return {"arch": arch, "requests": res["requests"],
            "tokens": res["tokens"], "serve_s": res["seconds"],
            "tok_per_s": res["tokens"] / res["seconds"],
            "wall_s_with_init": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts}


def replay_check(dev, arch, n_layers=4, s=512):
    """Full width, ``n_layers`` layers: the last logits of a prefill (K4
    or K5) against a token-by-token replay through ``decode_step`` (plain
    decode path), compared as ``tests/test_archs_smoke.py`` does, with
    the error stated relative to max |logit|; plus the time of the fp32
    head product one decode step pays (batch 4)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch).replace(n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    params = lm.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=dev)
    ctx = lm.NO_PARALLEL
    logits_pf, _ = lm.prefill(params, {"tokens": toks}, cfg, ctx)
    cache = lm.init_decode_cache(cfg, 1, s, device=dev)
    t0 = time.perf_counter()
    for i in range(s):
        logits_dec, cache = lm.decode_step(params, cache, toks[:, i:i + 1],
                                           cfg, ctx)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / s * 1e3
    err = float((logits_pf - logits_dec).abs().max())
    scale = float(logits_dec.abs().max())
    x = torch.randn((4, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    out = {"arch": arch, "layers": n_layers, "prompt": s,
           "max_abs_err": err, "max_abs_logit": scale,
           "rel_err": err / scale, "tolerance_rel": REPLAY_TOL,
           "decode_step_ms_4_layers": step_ms,
           "head_fp32_ms": graph_ms(lambda: lm._logits(params, x, cfg),
                                    iters=20),
           "head_bf16_ms": graph_ms(
               lambda: x @ lm._head(params, cfg), iters=20)}
    log(f"replay {arch}: " + json.dumps(out))
    assert np.isfinite(err) and err <= REPLAY_TOL * scale, \
        f"{arch}: prefill vs decode replay off by {err} (max |logit| " \
        f"{scale}, tolerance {REPLAY_TOL} x max |logit|)"
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
        if name in ("flash_attention", "paged_attention", "ssd_intra"):
            for fn, r, sp in funcs:
                log(f"    {fn}: {r} registers, {sp} spill bytes")
    if "flash_attention" in _build.BUILD_LOG:
        tc128 = [sp for fn, _, sp in ptxas_functions(
            _build.BUILD_LOG["flash_attention"])
            if "flash_attention_bf16_kernel<128>" in fn
            or "flash_attention_bf16_kernelILi128E" in fn]
        assert tc128 == [0], f"K4 bf16 at hd 128 spills: {tc128}"
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
    }
    rows = [check_latch(dev, K), check_fetch(dev, K),
            check_attention(dev, K), check_flash(dev, K),
            check_ssd(dev, K)]
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

    for arch, n_req, name, per in (("qwen3-1.7b", 16, "flash_attention", 28),
                                   ("mamba2-2.7b", 8, "ssd_intra", 64)):
        res = lm_serve(K, arch, n_req, name, per)
        log(f"lm {arch}: " + json.dumps(res))
        counts[name] = res["launches"][name]
    for arch in ("qwen3-1.7b", "mamba2-2.7b"):
        replay_check(dev, arch)

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
