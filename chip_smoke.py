"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``src/repro_torch/csrc`` and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, and time it (CUDA events; the
   kernel and the library call as CUDA-graph replays, the plain version
   eagerly), beside its bound: the larger of bytes over 3.35 TB/s and
   operations over the card's peak for their type;
3. serve ~48 seeded requests through ``SELCCKVPool`` + ``ServeLoop`` at
   the attention width of Qwen3-1.7B (16 query heads, 8 kv heads, head
   dim 128; ``src/repro/configs/qwen3_1p7b.py``) over the default pool
   (1024 pages x 16 tokens, 4 replicas, bf16: one layer's KV for 16,384
   tokens), checking every completion's KV readback bit for bit
   against ``ToyLM.expected_pages``, a sample of attend outputs against
   the plain kernel over the oracle bytes, the coherence invariants,
   the page accounting, and that every kernel launched during the run;
4. print the ``kernels`` JSON line, then the result line.

Needs one CUDA device; exits 1 without one, before printing anything
on standard output.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside tensor cores
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


def graph_ms(fn, iters=200) -> float:
    """Device time of one ``fn()`` call: captured once in a CUDA graph,
    replayed ``iters`` times between two events (no host overhead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
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
    return a.elapsed_time(b) / iters


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


def bound_ms(n_bytes: float, n_flops: float = 0.0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
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
            "plain_ms": eager_ms(lambda: latch_apply_plain(
                w, *[req[k] for k in REQ_KEYS])),
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def check_fetch(dev, K):
    """K2 at the serving round's shape: R = 32 rows of W = 16384 int32
    lanes from a 1024-page image, duplicates with unequal bits; exact."""
    from repro_torch.kernels.gcl_fetch import gcl_fetch_plain
    rng = np.random.default_rng(SEED + 1)
    p, e, r = 1024, 16384, 32
    pages = torch.from_numpy(rng.integers(-2**31, 2**31, (p, e))
                             .astype(np.int32)).to(dev)
    words_np = rng.integers(0, 2**20, (p, 2)).astype(np.int32)
    words_np[::3, 0] |= 5 << 24
    req_np = rng.integers(0, p, r).astype(np.int32)
    req_np[5] = req_np[6] = req_np[7]              # duplicate requests
    req_np[::9] = -1
    args = [torch.from_numpy(a).to(dev) for a in (
        words_np, req_np, rng.integers(0, 2**30, r).astype(np.int32),
        rng.integers(0, 2**30, r).astype(np.int32))]
    got = K.fetch(pages, *args)
    want = gcl_fetch_plain(pages, *args)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    assert err == 0, f"gcl_fetch disagrees with its plain version ({err})"
    row = e * 4
    n_valid = int((args[1] >= 0).sum())
    n_bytes = n_valid * row + r * row + 2 * p * 8 + 6 * r * 4
    bms, by = bound_ms(n_bytes)
    idx = args[1].long().clamp(min=0)
    return {"name": "gcl_fetch", "max_abs_err": float(err),
            "ms": graph_ms(lambda: K.fetch(pages, *args)),
            "plain_ms": eager_ms(lambda: gcl_fetch_plain(pages, *args)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": graph_ms(lambda: torch.index_select(pages, 0,
                                                              idx))}


def check_attention(dev, K):
    """K3 at the serving tick's shape: B = 16 slots, Hq = 16, Hkv = 8,
    hd = 128, page = 16, max_pages = 16, fp32 q, bf16 k/v read as views
    of a 1024-page int32 payload image (as ``pool.attend`` passes them).
    Tolerance 1e-4: fp32 accumulation in another order than the plain
    version's."""
    from repro_torch.dsm.kvpool import KVPoolConfig, decode_kv
    from repro_torch.kernels.paged_attention import paged_attention_plain
    import torch.nn.functional as F
    cfg = KVPoolConfig()
    rng = np.random.default_rng(SEED + 2)
    b, hq, hkv, hd, page, mp = 16, 16, 8, 128, 16, 16
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
        tbl_np[i, :used] = perm[i * mp:i * mp + used]
    tbl = torch.from_numpy(tbl_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    got = K.decode_paged(q, k_pages, v_pages, tbl, lens)
    want = paged_attention_plain(q, k_pages, v_pages, tbl, lens)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err < 1e-4, f"paged_attention off by {err} (tolerance 1e-4)"
    toks = int(lens_np.sum())
    n_bytes = (2 * toks * hkv * hd * 2 + 2 * b * hq * hd * 4
               + int(sum(-(-int(n) // page) for n in lens_np)) * 4 + b * 4)
    bms, by = bound_ms(n_bytes, 4.0 * hq * hd * toks)
    # yardstick: SDPA over the gathered pages (bf16, GQA, length mask)
    k_seq = k_pages[tbl.long().clamp(min=0)].reshape(b, mp * page, hkv, hd) \
        .transpose(1, 2).contiguous()
    v_seq = v_pages[tbl.long().clamp(min=0)].reshape(b, mp * page, hkv, hd) \
        .transpose(1, 2).contiguous()
    qb = q.to(torch.bfloat16).unsqueeze(2)                  # [B, Hq, 1, hd]
    mask = (torch.arange(mp * page, device=dev)[None, :]
            < lens[:, None]).view(b, 1, 1, mp * page)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qb, k_seq, v_seq, attn_mask=mask, enable_gqa=True))
    return {"name": "paged_attention", "max_abs_err": err,
            "ms": graph_ms(lambda: K.decode_paged(q, k_pages, v_pages, tbl,
                                                  lens)),
            "plain_ms": eager_ms(lambda: paged_attention_plain(
                q, k_pages, v_pages, tbl, lens)),
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


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
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(int(w) for line in text.splitlines()
                     for w, nxt in zip(line.split(), line.split()[1:])
                     if nxt == "bytes" and "spill" in line)
        log(f"  ptxas {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers, {spills} spill bytes")

    meta = {
        "latch_ops": ("src/repro_torch/csrc/latch_ops.cu",
                      "src/repro/kernels/latch_ops/latch_ops.py:90"),
        "gcl_fetch": ("src/repro_torch/csrc/gcl_fetch.cu",
                      "src/repro/kernels/gcl_fetch/gcl_fetch.py:63"),
        "paged_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:108"),
    }
    rows = [check_latch(dev, K), check_fetch(dev, K),
            check_attention(dev, K)]
    for row in rows:
        log(f"kernel {row['name']}: max_abs_err {row['max_abs_err']} "
            f"ms {row['ms']} plain_ms {row['plain_ms']} "
            f"library_ms {row['library_ms']} bound_ms {row['bound_ms']} "
            f"({row['bound_by']})")

    K.reset_launch_counts()
    res = serve(dev)
    counts = K.launch_counts()
    log("serve: " + json.dumps(res))
    for name, n in counts.items():
        assert n > 0, f"kernel {name} never launched on the main path"

    kernels = []
    for row in rows:
        src, replaces = meta[row["name"]]
        kernels.append({"name": row["name"], "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": counts[row["name"]],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
