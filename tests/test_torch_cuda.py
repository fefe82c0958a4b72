"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no GPU is present;
on a machine with one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it runs where only PyTorch is installed).
Tolerances: the latch and fetch kernels must match exactly; paged
attention agrees within 2e-5 with an fp32 output and 3e-2 with a bf16
one (the kernel sums in another order than the plain version); flash
attention within 2e-5 in fp32 and, in bf16, within 2e-2 of max(1,
|want|) elementwise (``test_kernels.py``'s tolerances, the bf16 one
scaled above 1 with the output's rounding step; the bf16 kernel also
rounds its probabilities to bf16);
ssd_intra within 2e-4 of the output's scale (fp32 sums of up to 256
terms in another order) and, with bf16 inputs, within 2e-2 of max(1,
|want|) elementwise (the output's rounding step).  The backward kernels
of K4 and K5 are held against their plain versions (tolerances at
``BWD_TOL`` and in each test).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.gcl_fetch import gcl_fetch_plain  # noqa: E402
from repro_torch.kernels.latch_ops import REQ_KEYS, \
    latch_apply_plain  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd_plain, flash_attention_plain  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention_plain  # noqa: E402
from repro_torch.kernels.ssd_intra import ssd_intra_plain  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,n,r,n_hot", [(0, 1024, 32, 8),
                                            (1, 4096, 1500, 64),
                                            (2, 64, 0, 1)])
def test_latch_kernel_matches_plain(cuda, seed, n, r, n_hot):
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 2))
                             .astype(np.int32))
    words[:4, 1] = -1                          # lo = 0xFFFFFFFF: carries
    line = rng.integers(0, n_hot, r).astype(np.int32)
    line[rng.random(r) < 0.15] = -1
    cmp = words.numpy()[np.maximum(line, 0)]
    req = {"line": line, "op": rng.integers(0, 2, r).astype(np.int32),
           "arg_hi": rng.integers(-4, 4, r).astype(np.int32),
           "arg_lo": rng.integers(-2**31, 2**31, r).astype(np.int32),
           "cmp_hi": cmp[:, 0].copy(), "cmp_lo": cmp[:, 1].copy()}
    req = {k: torch.from_numpy(v) for k, v in req.items()}
    want = latch_apply_plain(words, *[req[k] for k in REQ_KEYS])
    got = K.apply_batch(words.to(cuda), {k: v.to(cuda)
                                         for k, v in req.items()})
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("same_line", [False, True])
@pytest.mark.parametrize("n", [1, 63, 4097])
@pytest.mark.parametrize("r", [0, 1, 33, 1025, 1500])
def test_latch_kernel_line_slices(cuda, r, n, same_line):
    """K1 over one or several 1024-line slices (4097: a one-line tail),
    more requests than one staged tile (1025, 1500), empty slots and
    lines past N (replies of zeros, not ok, like an empty slot), and,
    with ``same_line``, one chain that every request is on."""
    rng = np.random.default_rng(r * 7 + n)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 2))
                             .astype(np.int32))
    words[:2, 1] = -1                          # lo = 0xFFFFFFFF: carries
    if same_line:
        line = np.full(r, n - 1, np.int32)
    else:
        line = rng.integers(-1, n + 3, r).astype(np.int32)
    cmp = words.numpy()[np.clip(line, 0, n - 1)]
    req = {"line": line, "op": rng.integers(0, 2, r).astype(np.int32),
           "arg_hi": rng.integers(-4, 4, r).astype(np.int32),
           "arg_lo": rng.integers(-2**31, 2**31, r).astype(np.int32),
           "cmp_hi": cmp[:, 0].copy(), "cmp_lo": cmp[:, 1].copy()}
    req = {k: torch.from_numpy(v) for k, v in req.items()}
    plain_req = dict(req, line=torch.where(req["line"] < n, req["line"], -1))
    want = latch_apply_plain(words, *[plain_req[k] for k in REQ_KEYS])
    got = K.apply_batch(words.to(cuda), {k: v.to(cuda)
                                         for k, v in req.items()})
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def test_latch_kernel_unaligned_words(cuda):
    """words at an 8-byte offset (a view one line into its storage) take
    the copy path of single lanes instead of 16-byte vectors."""
    rng = np.random.default_rng(9)
    n, r = 2049, 40
    store = torch.from_numpy(rng.integers(-2**31, 2**31, (n + 1, 2))
                             .astype(np.int32))
    words = store[1:]
    line = rng.integers(-1, n, r).astype(np.int32)
    line[:10] = 2047                           # a chain on one line
    cmp = words.numpy()[np.maximum(line, 0)]
    req = {"line": line, "op": rng.integers(0, 2, r).astype(np.int32),
           "arg_hi": rng.integers(-4, 4, r).astype(np.int32),
           "arg_lo": rng.integers(-2**31, 2**31, r).astype(np.int32),
           "cmp_hi": cmp[:, 0].copy(), "cmp_lo": cmp[:, 1].copy()}
    req = {k: torch.from_numpy(v) for k, v in req.items()}
    want = latch_apply_plain(words, *[req[k] for k in REQ_KEYS])
    dev_words = store.to(cuda)[1:]
    assert dev_words.is_contiguous() and dev_words.data_ptr() % 16 == 8
    got = K.apply_batch(dev_words, {k: v.to(cuda) for k, v in req.items()})
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("dtype,e", [(torch.int32, 16384),
                                     (torch.float32, 96),
                                     (torch.int32, 7),
                                     (torch.bfloat16, 24)])
def test_fetch_kernel_matches_plain(cuda, dtype, e):
    rng = np.random.default_rng(4)
    p, r = 64, 32
    pages = torch.from_numpy(rng.normal(size=(p, e)) * 1000).to(dtype)
    words = torch.from_numpy(rng.integers(0, 2**20, (p, 2))
                             .astype(np.int32))
    words[::3, 0] |= 5 << 24
    req = torch.from_numpy(rng.integers(0, p // 2, r).astype(np.int32))
    req[::5] = -1
    bits = [torch.from_numpy(rng.integers(0, 2**30, r).astype(np.int32))
            for _ in range(2)]                 # unequal duplicate bits
    want = gcl_fetch_plain(pages, words, req, *bits)
    got = K.fetch(*[t.to(cuda) for t in (pages, words, req, *bits)])
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def _fetch_inputs(seed, p, e, r, n_valid, dtype=torch.int32):
    """Pages [p, e], words with some writer bytes set, r requests of
    which n_valid name one of the first p / 4 pages (so that pages
    repeat, with unequal bits) and the rest -1, and random reader
    bits."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        pages = torch.from_numpy(rng.integers(-2**31, 2**31, (p, e))
                                 .astype(np.int32))
    else:
        pages = torch.from_numpy(rng.normal(size=(p, e)) * 1000).to(dtype)
    words = torch.from_numpy(rng.integers(0, 2**20, (p, 2)).astype(np.int32))
    words[::3, 0] |= 5 << 24
    req = np.full(r, -1, np.int32)
    slots = rng.permutation(r)[:n_valid]
    req[slots] = rng.integers(0, max(1, p // 4), n_valid)
    bits = [torch.from_numpy(rng.integers(0, 2**30, r).astype(np.int32))
            for _ in range(2)]
    return pages, words, torch.from_numpy(req), bits


@pytest.mark.parametrize("p,e,r,n_valid,dtype", [
    (1024, 16384, 32, 28, torch.int32),    # the dense round (chip_smoke)
    (1024, 16384, 32, 1, torch.int32),     # the serve's mix
    (1024, 16384, 32, 0, torch.int32),     # every row empty
    (1024, 16384, 0, 0, torch.int32),      # no request: words copied
    (64, 16384, 1500, 1200, torch.int32),  # many merge passes; 8 vectors
    (2100, 96, 40, 30, torch.int32),       # P past two page slices
    (3000, 7, 50, 40, torch.int32),        # 28-byte rows: byte path
    (64, 4096, 32, 20, torch.bfloat16),
    (64, 1000, 32, 20, torch.float32),     # ragged last chunk
])
def test_fetch_kernel_cases(cuda, p, e, r, n_valid, dtype):
    """The one-launch kernel against its plain version, exactly, with
    duplicate requests of unequal bits, at the main path's shapes and
    at the edges of its partition.  Two empty slots name pages far past
    P instead of -1 (2^30 and 2^31 - 1): they stay empty slots."""
    pages, words, req, bits = _fetch_inputs(p + r, p, e, r, n_valid, dtype)
    want = gcl_fetch_plain(pages, words, req, *bits)
    far, empty = req.clone(), torch.nonzero(req < 0).squeeze(1)[:2]
    far[empty] = torch.tensor([2**30, 2**31 - 1],
                              dtype=torch.int32)[:len(empty)]
    got = K.fetch(*[t.to(cuda) for t in (pages, words, far, *bits)])
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def test_fetch_kernel_unaligned_pages(cuda):
    """pages 4 bytes past a 16-byte boundary (a view one lane into its
    storage) take the byte path although the rows are 64 bytes."""
    pages, words, req, bits = _fetch_inputs(3, 40, 16, 24, 20)
    store = torch.empty(40 * 16 + 1, dtype=torch.int32, device=cuda)
    dev_pages = store[1:].view(40, 16)
    dev_pages.copy_(pages.to(cuda))
    assert dev_pages.is_contiguous() and dev_pages.data_ptr() % 16 == 4
    want = gcl_fetch_plain(pages, words, req, *bits)
    got = K.fetch(dev_pages, *[t.to(cuda) for t in (words, req, *bits)])
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def test_fetch_is_one_kernel_launch(cuda):
    """One call is one kernel on the device, with no copy of the words
    beside it, and counts one launch."""
    from torch.profiler import ProfilerActivity, profile
    pages, words, req, bits = _fetch_inputs(5, 1024, 16384, 32, 1)
    args = [t.to(cuda) for t in (pages, words, req, *bits)]
    K.fetch(*args)                              # built and warm
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.fetch(*args)
        torch.cuda.synchronize()
    assert K.launch_counts()["gcl_fetch"] == 1
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "gcl_fetch_kernel" in names[0], names


@pytest.mark.parametrize("hd,qdt,kvdt,tol", [
    (64, torch.float32, torch.float32, 2e-5),
    (256, torch.float32, torch.float32, 2e-5),
    (128, torch.float32, torch.bfloat16, 2e-5),
    (256, torch.bfloat16, torch.bfloat16, 3e-2),
    (128, torch.bfloat16, torch.float32, 3e-2),
])
def test_paged_attention_kernel_matches_plain(cuda, hd, qdt, kvdt, tol):
    rng = np.random.default_rng(2)
    b, hq, hkv, page, mp, pool = 6, 16, 8, 16, 8, 64
    q = torch.from_numpy(rng.normal(size=(b, hq, hd))).to(qdt)
    kp = torch.from_numpy(rng.normal(size=(pool, page, hkv, hd))).to(kvdt)
    vp = torch.from_numpy(rng.normal(size=(pool, page, hkv, hd))).to(kvdt)
    lens = torch.from_numpy(rng.integers(1, mp * page + 1, b)
                            .astype(np.int32))
    lens[0] = 0
    tbl = torch.from_numpy(rng.integers(0, pool, (b, mp)).astype(np.int32))
    for i, n in enumerate(lens.tolist()):
        tbl[i, -(-n // page):] = -1            # -1 past the valid pages
    ins = (q, kp, vp, tbl, lens)
    want = paged_attention_plain(*ins).float()
    got = K.decode_paged(*[t.to(cuda) for t in ins]).float().cpu()
    assert got.dtype == want.dtype
    assert (got - want).abs().max().item() < tol
    assert not got[0].any()                    # lens == 0 -> zeros


@pytest.mark.parametrize("window,page", [(1, 1), (16, 4), (256, 16),
                                         (1024, 16)])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 16, 32])
def test_paged_attention_kernel_cluster_split(cuda, group, window, page):
    """K3 over GQA groups (3: a padded head; 16 and 32: heads in chunks
    of 8 on separate lane groups) and windows of one, several and many
    cluster slices (1, 16, 256, 1024 tokens: clusters of 1, 2, 2 and 2),
    with lens of 0, a full window, ragged ones, and -1 past the valid
    pages; the serve's fp32 q over bf16 k/v, fp32 output: 2e-5."""
    from repro_torch.kernels.paged_attention import cluster_size
    rng = np.random.default_rng(group * 7919 + window)
    hkv, hd, mp = 2, 128, window // page
    b = 5
    pool = b * mp + 4
    assert cluster_size(mp) == (1 if mp == 1 else 2)
    q = torch.from_numpy(rng.normal(size=(b, hkv * group, hd))
                         .astype(np.float32))
    kp, vp = [torch.from_numpy(rng.normal(size=(pool, page, hkv, hd))
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2)]
    lens = torch.from_numpy(rng.integers(1, window + 1, b).astype(np.int32))
    lens[0], lens[1] = 0, window
    tbl = torch.from_numpy(rng.permutation(pool)[:b * mp].reshape(b, mp)
                           .astype(np.int32))
    for i, n in enumerate(lens.tolist()):
        tbl[i, -(-n // page):] = -1            # -1 past the valid pages
    ins = (q, kp, vp, tbl, lens)
    want = paged_attention_plain(*ins)
    K.reset_launch_counts()
    got = K.decode_paged(*[t.to(cuda) for t in ins]).cpu()
    assert K.launch_counts()["paged_attention"] == 1
    assert (got - want).abs().max().item() < 2e-5
    assert not got[0].any()                    # lens == 0 -> zeros


def test_paged_attention_kernel_reads_pool_views(cuda):
    """The pool passes k/v as strided bf16 views of its int32 lanes."""
    from repro_torch.dsm.kvpool import KVPoolConfig, decode_kv
    cfg = KVPoolConfig(n_pages=32)
    rng = np.random.default_rng(8)
    image = torch.from_numpy(rng.normal(size=(32, 2, 16, 8, 128))
                             .astype(np.float32)).to(torch.bfloat16) \
        .reshape(32, -1).view(torch.int32)
    k, v = decode_kv(image, cfg)
    q = torch.from_numpy(rng.normal(size=(4, 16, 128)).astype(np.float32))
    tbl = torch.from_numpy(rng.permutation(32)[:16].reshape(4, 4)
                           .astype(np.int32))
    lens = torch.tensor([64, 1, 17, 40], dtype=torch.int32)
    want = paged_attention_plain(q, k, v, tbl, lens)
    kc, vc = decode_kv(image.to(cuda), cfg)
    got = K.decode_paged(q.to(cuda), kc, vc, tbl.to(cuda),
                         lens.to(cuda)).cpu()
    assert (got - want).abs().max().item() < 2e-5


def test_cuda_wrappers_count_launches(cuda):
    K.reset_launch_counts()
    w = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    req = {k: torch.zeros(2, dtype=torch.int32, device=cuda)
           for k in REQ_KEYS}
    K.apply_batch(w, req)
    K.fetch(torch.zeros((8, 4), device=cuda), w, req["line"], req["op"],
            req["op"])
    torch.cuda.synchronize()
    assert K.launch_counts() == {"latch_ops": 1, "gcl_fetch": 1,
                                 "paged_attention": 0,
                                 "flash_attention": 0, "ssd_intra": 0,
                                 "flash_attention_bwd": 0,
                                 "ssd_intra_bwd": 0}


def test_serve_on_gpu_matches_cpu(cuda):
    """The whole slice on the card (engine + all three kernels) against
    the same trace on the CPU: identical tokens, rounds per tick and
    final state; attend outputs within 2e-5 (fp32 sums)."""
    from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool
    from repro_torch.serve import ServeLoop, ToyLM
    cfg = KVPoolConfig(n_pages=48, page_size=16, n_kv_heads=2,
                       head_dim=64, n_replicas=3)
    rng = np.random.default_rng(6)
    trace = [([int(x) for x in rng.integers(0, 97, int(rng.integers(1, 40)))],
              int(rng.integers(1, 30))) for _ in range(10)]
    runs = []
    for dev in ("cpu", cuda):
        K.reset_launch_counts()
        pool = SELCCKVPool(cfg, device=dev)
        pool.open_rounds_plane()
        attn = {}
        loop = ServeLoop(pool, ToyLM(cfg, n_q_heads=4), n_slots=4,
                         max_pages=6, prefill_chunk=8,
                         on_complete=lambda r, s: attn.__setitem__(
                             r.rid, s.last_attn))
        reqs = [loop.submit(p, g) for p, g in trace]
        rounds = []
        while loop.has_work():
            rounds.append(loop.tick().last_rounds)
        counts = K.launch_counts()
        state = {k: v.cpu() for k, v in pool.rounds_state.items()}
        runs.append(([r.generated for r in reqs], rounds, state, attn,
                     counts))
    (tok_c, rnd_c, st_c, at_c, cnt_c), (tok_g, rnd_g, st_g, at_g, cnt_g) = \
        runs
    assert tok_g == tok_c and rnd_g == rnd_c
    for k in st_c:
        assert torch.equal(st_g[k], st_c[k]), k
    for rid in at_c:
        assert np.abs(at_g[rid] - at_c[rid]).max() < 2e-5
    assert set(cnt_c.values()) == {0}
    assert min(cnt_g[k] for k in ("latch_ops", "gcl_fetch",
                                  "paged_attention")) > 0


def test_btree_on_gpu_matches_cpu(cuda):
    """The B-link tree on the card (fused descent, RMW inserts, splits,
    scans, write-back) against the same trace on the CPU: identical
    results, stats and state leaves, and K1 and K2 launched."""
    from repro_torch.index import DeviceBTree
    rng = np.random.default_rng(8)
    keys = rng.choice(3000, 120, replace=False).astype(np.int32)
    vals = rng.integers(1, 1 << 20, 120).astype(np.int32)
    runs = []
    for dev in ("cpu", cuda):
        K.reset_launch_counts()
        tree = DeviceBTree.create(4, 256, fanout=4, write_back=True,
                                  device=dev)
        out = []
        for i in range(0, 120, 24):
            tree.insert_batch(keys[i:i + 24], vals[i:i + 24], node=i % 4)
            v, f = tree.lookup_batch(keys[:i + 30], node=(i + 1) % 4)
            out.append((v.tolist(), f.tolist()))
        out.append(tree.scan_batch(keys[:5], 9, node=2))
        tree.check_invariants()
        state = {k: v.cpu() for k, v in tree.state.items()}
        runs.append((out, dict(tree.stats), tree.items(), state,
                     K.launch_counts()))
    (out_c, st_c, it_c, s_c, n_c), (out_g, st_g, it_g, s_g, n_g) = runs
    assert out_g == out_c and st_g == st_c and it_g == it_c
    assert st_c["splits"] > 0
    for k in s_c:
        assert torch.equal(s_g[k], s_c[k]), k
    assert set(n_c.values()) == {0}
    assert n_g["latch_ops"] > 0 and n_g["gcl_fetch"] > 0


@pytest.mark.parametrize("algo", ["2pl", "to"])
def test_txn_engine_on_gpu_matches_cpu(cuda, algo):
    """The transaction engine on the card against the CPU on the same
    batches: identical decisions, completion order, retries, rounds and
    state, and K1 and K2 launched."""
    from repro_torch.apps import (DeviceTxnConfig, DeviceTxnEngine,
                                  TxnBatchConfig, device_txn_batches)
    from repro_torch.core.rounds import (DevicePlane, make_state,
                                         txn_payload_width)
    cfg = TxnBatchConfig(n_gcls=12, tuples_per_gcl=4, batch=8, iters=3,
                         max_group_lines=4, zipf_theta=0.9, n_nodes=3)
    runs = []
    for dev in ("cpu", cuda):
        K.reset_launch_counts()
        eng = DeviceTxnEngine(
            DevicePlane.open(make_state(3, 12, payload_width=
                                        txn_payload_width(4), device=dev)),
            DeviceTxnConfig(algo=algo, tuples_per_gcl=4))
        out = []
        for txns, node, ts in device_txn_batches(cfg, seed=3):
            r, _ = eng.run_batch(node, txns, ts=ts)
            out.append((r.decision.tolist(), r.exec_step.tolist(),
                        r.retries.tolist(), r.iters, r.rounds))
        state = {k: v.cpu() for k, v in eng.plane.state.items()}
        runs.append((out, state, K.launch_counts()))
    (out_c, s_c, n_c), (out_g, s_g, n_g) = runs
    assert out_g == out_c
    for k in s_c:
        assert torch.equal(s_g[k], s_c[k]), k
    assert set(n_c.values()) == {0}
    assert n_g["latch_ops"] > 0 and n_g["gcl_fetch"] > 0


def test_latch_kernel_at_the_btree_shape(cuda):
    """K1 at the B-tree plane's size: N = 2^21 words, R = 1024 reader
    FAAs, the root named by four nodes and every other slot by one
    request a line; exact."""
    rng = np.random.default_rng(21)
    n, r = 1 << 21, 1024
    words = torch.from_numpy(rng.integers(0, 2**24, (n, 2))
                             .astype(np.int32))
    line = (1 + rng.choice(n - 1, r, replace=False)).astype(np.int32)
    line[:4] = 0
    zeros = np.zeros(r, np.int32)
    req = {"line": line, "op": np.ones(r, np.int32), "arg_hi": zeros,
           "arg_lo": (1 << (np.arange(r) % 4)).astype(np.int32),
           "cmp_hi": zeros, "cmp_lo": zeros}
    req = {k: torch.from_numpy(v) for k, v in req.items()}
    want = latch_apply_plain(words, *[req[k] for k in REQ_KEYS])
    got = K.apply_batch(words.to(cuda), {k: v.to(cuda)
                                         for k, v in req.items()})
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def test_latch_kernel_at_the_txn_finalize_shape(cuda):
    """K1 at the txn plane's FINALIZE spin: N = 2^20 words, R = 4096
    slots over four request tiles, about half empty, write CASes that
    hit and miss, reader FAAs, and hot lines whose word carries from
    tile to tile (``chip_smoke.latch_app_inputs``); exact."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    words, req = cs.latch_app_inputs(1 << 20, 4096, "finalize")
    words = torch.from_numpy(words)
    req = {k: torch.from_numpy(v) for k, v in req.items()}
    want = latch_apply_plain(words, *[req[k] for k in REQ_KEYS])
    got = K.apply_batch(words.to(cuda), {k: v.to(cuda)
                                         for k, v in req.items()})
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("p,e,r,n_valid", [
    (1 << 21, 40, 1024, 1024),     # the B-tree round: 160-byte rows
    (1 << 20, 18, 4096, 2048),     # the txn FINALIZE spin: byte path
])
def test_fetch_kernel_at_the_application_shapes(cuda, p, e, r, n_valid):
    pages, words, req, bits = _fetch_inputs(p + e, p, e, r, n_valid)
    want = gcl_fetch_plain(pages, words, req, *bits)
    got = K.fetch(*[t.to(cuda) for t in (pages, words, req, *bits)])
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def _bf16_err(got, want):
    """Largest |got - want| / max(1, |want|): a bf16 output's rounding
    step grows with its magnitude, so two correct results of size 4 may
    already sit one step, 2**-5, apart."""
    want = want.float()
    return ((got.float() - want).abs() / want.abs().clamp(min=1.0)) \
        .max().item()


@pytest.mark.parametrize("s", [64, 500, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_kernel_matches_plain(cuda, hd, group, causal,
                                             dtype, s):
    """K4 over head dims, GQA groups, masks, dtypes and ragged S, read
    through the model's [B, S, H, hd] layout (transposed views)."""
    rng = np.random.default_rng(hd + group + s)
    b, hkv = 2, 2
    q, k, v = [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                                .astype(np.float32)).to(cuda, dtype)
               for h in (hkv * group, hkv, hkv)]
    ins = [t.transpose(1, 2) for t in (q, k, v)]
    want = flash_attention_plain(*ins, causal=causal)
    got = K.flash_attention(*ins, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        assert _bf16_err(got, want) < 2e-2
    else:
        assert (got - want).abs().max().item() < 2e-5


@pytest.mark.parametrize("s", [1, 17, 127])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_bf16_ragged_and_wide(cuda, hd, group, causal, s):
    """The bf16 tensor-core K4 at S shorter than, or not a multiple of,
    its 64-row q and key tiles, and at a GQA group of 16."""
    rng = np.random.default_rng(hd * 3 + group + s)
    b, hkv = 2, 1
    ins = [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                            .astype(np.float32)).to(cuda, torch.bfloat16)
           .transpose(1, 2) for h in (hkv * group, hkv, hkv)]
    want = flash_attention_plain(*ins, causal=causal)
    got = K.flash_attention(*ins, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_err(got, want) < 2e-2


@pytest.mark.parametrize("wsel", ["one", "inside", "beyond"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 500, 4096])
@pytest.mark.parametrize("group", [1, 10])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_window_matches_plain(cuda, hd, group, s, dtype,
                                              wsel):
    """Windowed K4 (key j visible to query i iff j <= i and j > i - W)
    against its plain version: W = 1 (the diagonal alone), W inside S
    (S // 3 + 5: q tiles whose walk starts past key 0, tiles crossing
    the window's lower edge) and W >= S (no key is cut), over head dims,
    GQA groups of 1 and 10 (recurrentgemma-2b's 10 q heads over one kv
    head), ragged and long S and both dtypes."""
    rng = np.random.default_rng(hd + group + s)
    window = {"one": 1, "inside": s // 3 + 5, "beyond": s + 7}[wsel]
    b, hkv = 1, 1
    ins = [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                            .astype(np.float32)).to(cuda, dtype)
           .transpose(1, 2) for h in (hkv * group, hkv, hkv)]
    want = flash_attention_plain(*ins, causal=True, window=window)
    got = K.flash_attention(*ins, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        assert _bf16_err(got, want) < 2e-2
    else:
        assert (got - want).abs().max().item() < 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 37])
@pytest.mark.parametrize("sk", [128, 500])
@pytest.mark.parametrize("sq", [1, 17, 512])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_unequal_lengths_and_offset(cuda, hd, sq, sk,
                                                    q_offset, causal, dtype):
    """K4 with Sq != Sk (the encoder-decoder's cross-attention and its
    decode step, Sq 1; Sq 512 over fewer keys than queries too) and with
    query row i at position q_offset + i, causal or not, over head dims
    and both dtypes, against its plain version."""
    rng = np.random.default_rng(hd + sq + sk + q_offset)
    b, hkv, group = 2, 2, 2
    ins = [torch.from_numpy(rng.normal(size=(b, n, h, hd))
                            .astype(np.float32)).to(cuda, dtype)
           .transpose(1, 2)
           for n, h in ((sq, hkv * group), (sk, hkv), (sk, hkv))]
    want = flash_attention_plain(*ins, causal=causal, q_offset=q_offset)
    got = K.flash_attention(*ins, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape == (b, 4, sq, hd)
    if dtype == torch.bfloat16:
        assert _bf16_err(got, want) < 2e-2
    else:
        assert (got - want).abs().max().item() < 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,q_offset,window,causal", [
    (17, 128, 100, 30, True), (512, 500, 0, 64, True),
    (17, 128, 120, 20, False), (64, 300, 200, 150, True),
    (1, 128, 200, 80, False)])
def test_flash_attention_offset_with_a_window(cuda, sq, sk, q_offset, window,
                                              causal, dtype):
    """K4 with a query offset and a window together (a q tile's walk then
    starts at the key tile holding q_offset + q0 - W + 1), hd 128."""
    rng = np.random.default_rng(sq + sk + window)
    ins = [torch.from_numpy(rng.normal(size=(1, n, h, 128))
                            .astype(np.float32)).to(cuda, dtype)
           .transpose(1, 2) for n, h in ((sq, 4), (sk, 1), (sk, 1))]
    kw = {"causal": causal, "q_offset": q_offset, "window": window}
    want = flash_attention_plain(*ins, **kw)
    got = K.flash_attention(*ins, **kw)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert _bf16_err(got, want) < 2e-2
    else:
        assert (got - want).abs().max().item() < 2e-5


def test_flash_attention_refuses_a_row_with_no_visible_key(cuda):
    """A window whose last query row starts at or past the last key
    leaves that row nothing to attend to: the wrapper raises before any
    launch, and the C entry point refuses such a call itself."""
    import ctypes
    import math
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _SIGNATURES
    x = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros((1, 1, 40, 64), device=cuda, dtype=torch.bfloat16)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="sees no key"):
        K.flash_attention(x, kv, kv, causal=False, q_offset=40, window=8)
    with pytest.raises(ValueError, match="sees no key"):
        K.flash_attention(x, kv[:, :, :0], kv[:, :, :0], causal=False)
    assert K.launch_counts()["flash_attention"] == 0
    lib = _build.load("flash_attention", _SIGNATURES)
    out = torch.empty_like(x)
    strides = (ctypes.c_longlong * 12)(*[
        st for t in (x, kv, kv, out) for st in t.stride()[:3]])
    for sk, off, window in ((40, 40, 8), (0, 0, 0), (40, -1, 0)):
        rc = lib.flash_attention_launch(
            x.data_ptr(), kv.data_ptr(), kv.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), 1, 2, 1, 8, sk, off, 64,
            1.0 / math.sqrt(64), 0, window, 1, _build.stream_of(x))
        assert rc != 0, (sk, off, window)


@pytest.mark.parametrize("bc,q,h,p", [(8, 256, 80, 64), (3, 100, 5, 24),
                                      (4, 32, 6, 16), (2, 256, 3, 128),
                                      (2, 37, 3, 10)])
def test_ssd_intra_kernel_matches_plain(cuda, bc, q, h, p):
    """K5 at the Mamba2-2.7B prefill shape, at ragged ones (Q 100, P 24,
    head counts its group of 2 does not divide), at the smoke config's
    chunk, at P 128, and with rows that are not 16-byte aligned (Q 37,
    P 10: loaded element by element, odd stores); the cumsum is steep
    enough that exp overflows above the diagonal."""
    rng = np.random.default_rng(q)
    cb = torch.from_numpy(rng.normal(size=(bc, q, q)).astype(np.float32))
    cs = torch.from_numpy((-np.abs(rng.normal(size=(bc, q, h)))
                           .cumsum(axis=1)).astype(np.float32))
    win = torch.from_numpy(rng.normal(size=(bc, q, h, p)).astype(np.float32))
    ins = [t.to(cuda) for t in (cb, cs, win)]
    want = ssd_intra_plain(*ins)
    got = K.ssd_intra(*ins)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() < 2e-4 * max(1.0, scale)


def test_ssd_intra_kernel_bf16(cuda):
    """bf16 inputs, widened to fp32 on load: within 2e-2 of max(1,
    |want|), the output's bf16 rounding step."""
    rng = np.random.default_rng(7)
    bc, q, h, p = 2, 64, 4, 32
    ins = [torch.from_numpy(a.astype(np.float32)).to(cuda, torch.bfloat16)
           for a in (rng.normal(size=(bc, q, q)),
                     -np.abs(rng.normal(size=(bc, q, h))).cumsum(axis=1),
                     rng.normal(size=(bc, q, h, p)))]
    want = ssd_intra_plain(*ins).float()
    got = K.ssd_intra(*ins)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    rel = (got.float() - want).abs() / want.abs().clamp(min=1.0)
    assert rel.max().item() < 2e-2


def _grad_err(got, want) -> float:
    """Largest error of any of the gradient tensors, over that tensor's
    largest |want| (at least 1)."""
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp(min=1.0)).item()
               for g, w in zip(got, want))


# K4's backward: fp32 within 1e-4 of each gradient's scale (fp32 sums in
# another order); bf16 within 3e-2 of it (P and dS rounded to bf16
# before their products, bf16 inputs and outputs).  Each gradient row
# also within 1e-4 (fp32) or 1e-2 (bf16) of its L2 norm, floored at a
# tenth of the tensor's RMS row norm (chip_smoke.grad_row_rel): the
# scale is set by a few early rows and keys, so the bound over it alone
# is as large as a typical entry and would pass a tile or head walked
# wrong.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
BWD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _bwd_case(cuda, dtype, b, sq, sk, hq, hkv, hd, seed, **mask):
    rng = np.random.default_rng(seed)
    q, k, v, do = [torch.from_numpy(rng.normal(size=(b, n, h, hd))
                                    .astype(np.float32)).to(cuda, dtype)
                   .transpose(1, 2)
                   for n, h in ((sq, hq), (sk, hkv), (sk, hkv), (sq, hq))]
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **mask)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **mask)
    K.reset_launch_counts()
    got = K.flash_attention_bwd(q, k, v, out, lse, do, **mask)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention_bwd"] == 1
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert torch.isfinite(g).all()
    # the [B, S, H, hd] memory layout of the model's tensors
    assert all(g.transpose(1, 2).is_contiguous() for g in got)
    err = _grad_err(got, want)
    assert err < BWD_TOL[dtype], err
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import grad_row_rel
    row_err = grad_row_rel(got, want)
    assert row_err < BWD_ROW_TOL[dtype], row_err
    return err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [17, 64, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bwd_kernel_matches_plain(cuda, hd, group, causal,
                                                 s, dtype):
    """K4's backward over head dims, GQA groups, masks, dtypes and
    ragged S (tiles of 64 keys and of 32 or 64 rows)."""
    _bwd_case(cuda, dtype, 2, s, s, 2 * group, 2, hd, hd + s + group,
              causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,q_offset,window,causal,hd", [
    (512, 512, 0, 2048, True, 128), (300, 300, 0, 40, True, 64),
    (512, 128, 0, None, False, 64), (1, 128, 0, None, False, 64),
    (512, 1664, 1152, None, True, 128), (33, 100, 67, 20, True, 64)])
def test_flash_attention_bwd_masks(cuda, sq, sk, q_offset, window, causal,
                                   hd, dtype):
    """The backward with every mask the forward takes: a window (wider
    than S and biting), cross-attention (Sq != Sk, not causal, a decode
    row), a query offset, and an offset with a window."""
    _bwd_case(cuda, dtype, 2, sq, sk, 4, 2, hd, sq + sk,
              causal=causal, window=window, q_offset=q_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_and_autograd(cuda, dtype):
    """With a gradient asked for, K4's forward writes each row's
    log-sum-exp (held against the plain one) and autograd reaches the
    backward kernel; the gradients match CPU autograd of the plain
    forward.  Without one, no backward is set up."""
    from repro_torch.kernels.flash_attention import _launch_fwd
    rng = np.random.default_rng(3)
    b, s, hq, hkv, hd = 2, 96, 4, 2, 64
    cpu = [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                            .astype(np.float32)).to(dtype).transpose(1, 2)
           for h in (hq, hkv, hkv)]
    gpu = [t.to(cuda) for t in cpu]
    out, lse = _launch_fwd(*gpu, True, None, 0, True)
    _, want_lse = flash_attention_plain(*gpu, return_lse=True)
    assert (lse - want_lse).abs().max().item() < 1e-3
    do = torch.from_numpy(rng.normal(size=(b, hq, s, hd))
                          .astype(np.float32)).to(dtype)
    cpu = [t.detach().float().requires_grad_() for t in cpu]
    (flash_attention_plain(*cpu).float() * do.float()).sum().backward()
    gpu = [t.detach().requires_grad_() for t in gpu]
    K.reset_launch_counts()
    o = K.flash_attention(*gpu)
    o.backward(do.to(cuda))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["flash_attention"] == 1 and \
        counts["flash_attention_bwd"] == 1
    err = _grad_err([t.grad.cpu() for t in gpu], [t.grad for t in cpu])
    assert err < BWD_TOL[dtype], err
    with torch.no_grad():
        assert K.flash_attention(*gpu).grad_fn is None


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("sq,sk,mask", [
    (200, 200, {"causal": True}), (130, 77, {"causal": False}),
    (300, 300, {"causal": True, "window": 70}),
    (100, 260, {"causal": True, "q_offset": 160}),
    (150, 330, {"causal": True, "q_offset": 180, "window": 90}),
    (1, 190, {"causal": False})])
def test_flash_attention_bwd_groups_ragged_and_masks(cuda, group, sq, sk,
                                                     mask):
    """The bf16 backward (wgmma dQ and dK/dV passes) at GQA groups 1, 2,
    4 and 8, with Sq and Sk not multiples of the 64-row tiles or the
    128-key blocks, under every mask route: causal, cross-attention (Sq
    != Sk), a window, a query offset, both, and a decode row."""
    _bwd_case(cuda, torch.bfloat16, 2, sq, sk, 2 * group, 2,
              64 if group % 2 else 128, sq + sk + group, **mask)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bwd_is_deterministic(cuda, hd):
    """Two calls on the same inputs give the same bits (no value
    atomics: each output written by one block)."""
    rng = np.random.default_rng(hd)
    b, s, hq, hkv = 2, 300, 8, 2
    q, k, v, do = [torch.from_numpy(rng.normal(size=(b, s, h, hd))
                                    .astype(np.float32))
                   .to(cuda, torch.bfloat16).transpose(1, 2)
                   for h in (hq, hkv, hkv, hq)]
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    first = K.flash_attention_bwd(q, k, v, out, lse, do)
    second = K.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_flash_attention_bwd_refuses_hd_256(cuda):
    x = torch.zeros((1, 2, 8, 256), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="hd 256"):
        K.flash_attention_bwd(x, x, x, x, lse, x)


@pytest.mark.parametrize("bc,q,h,p", [(8, 256, 80, 64), (3, 100, 5, 32),
                                      (4, 32, 6, 16), (2, 256, 3, 128),
                                      (2, 37, 3, 16)])
def test_ssd_intra_bwd_kernel_matches_plain(cuda, bc, q, h, p):
    """K5's backward at the Mamba2-2.7B training shape, ragged chunks
    (Q 100, 37: partial key tiles), the smoke config's chunk and P 128,
    with a cumsum steep enough that exp overflows above the diagonal:
    within 1e-4 of each gradient's scale (fp32 sums in another order;
    dcs is a difference of two sums of up to 256 terms)."""
    from repro_torch.kernels.ssd_intra import ssd_intra_bwd_plain
    rng = np.random.default_rng(q + p)
    cb = rng.normal(size=(bc, q, q))
    cs = -np.abs(rng.normal(size=(bc, q, h))).cumsum(axis=1)
    win, dy = rng.normal(size=(2, bc, q, h, p))
    ins = [torch.from_numpy(a.astype(np.float32)).to(cuda)
           for a in (cb, cs, win, dy)]
    want = ssd_intra_bwd_plain(*ins)
    y = K.ssd_intra(*ins[:3])
    K.reset_launch_counts()
    got = K.ssd_intra_bwd(*ins, y)
    torch.cuda.synchronize()
    assert K.launch_counts()["ssd_intra_bwd"] == 1
    assert all(torch.isfinite(g).all() for g in got)
    err = _grad_err(got, want)
    assert err < 1e-4, err
    cpu = [t.cpu().requires_grad_() for t in ins[:3]]
    gpu = [t.detach().clone().requires_grad_() for t in ins[:3]]
    (ssd_intra_plain(*cpu) * ins[3].cpu()).sum().backward()
    K.ssd_intra(*gpu).backward(ins[3])
    assert _grad_err([t.grad.cpu() for t in gpu],
                     [t.grad for t in cpu]) < 1e-4


@pytest.mark.parametrize("p", [16, 32, 64, 128])
@pytest.mark.parametrize("q", [100, 200])
def test_ssd_intra_bwd_head_dims_and_ragged_chunks(cuda, q, p):
    """K5's backward (3xTF32) at every head dim it takes and chunks that
    are not a multiple of its 64-key tiles, 11 heads (a partial group of
    8), a steep cumsum: within 1e-4 of each gradient's scale, and two
    calls give the same bits."""
    from repro_torch.kernels.ssd_intra import ssd_intra_bwd_plain
    rng = np.random.default_rng(q * p)
    cb = rng.normal(size=(2, q, q))
    cs = -np.abs(rng.normal(size=(2, q, 11))).cumsum(axis=1)
    win, dy = rng.normal(size=(2, 2, q, 11, p))
    ins = [torch.from_numpy(a.astype(np.float32)).to(cuda)
           for a in (cb, cs, win, dy)]
    y = K.ssd_intra(*ins[:3])
    got = K.ssd_intra_bwd(*ins, y)
    again = K.ssd_intra_bwd(*ins, y)
    torch.cuda.synchronize()
    assert all(torch.equal(x, z) for x, z in zip(got, again))
    assert all(torch.isfinite(g).all() for g in got)
    assert _grad_err(got, ssd_intra_bwd_plain(*ins)) < 1e-4


def test_lm_wrappers_count_and_reject(cuda):
    K.reset_launch_counts()
    x = torch.zeros((1, 2, 64, 64), device=cuda)
    K.flash_attention(x, x[:, :1], x[:, :1])
    K.ssd_intra(torch.zeros((1, 8, 8), device=cuda),
                torch.zeros((1, 8, 2), device=cuda),
                torch.zeros((1, 8, 2, 16), device=cuda))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["flash_attention"] == 1 and counts["ssd_intra"] == 1
    with pytest.raises(ValueError, match="head_dim"):
        K.flash_attention(*[torch.zeros((1, 2, 8, 32), device=cuda)] * 3)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        K.flash_attention(x, x[:, :1].bfloat16(), x[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention(x.transpose(2, 3), x[:, :1], x[:, :1])
    xb = torch.zeros((1, 2, 64, 68), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        K.flash_attention(*[xb[..., :64]] * 3)
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="window"):
            K.flash_attention(x, x[:, :1], x[:, :1], window=bad)
    with pytest.raises(ValueError, match="too large"):
        K.ssd_intra(torch.zeros((1, 512, 512), device=cuda),
                    torch.zeros((1, 512, 1), device=cuda),
                    torch.zeros((1, 512, 1, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        K.ssd_intra(torch.zeros((1, 8, 8), device=cuda),
                    torch.zeros((1, 2, 8), device=cuda).transpose(1, 2),
                    torch.zeros((1, 8, 2, 4), device=cuda))
    assert K.launch_counts() == counts


def test_lm_attention_raises_where_k4_cannot_serve(cuda):
    """Nothing the models call raises on the card any more: a window, a
    query offset and cross-attention (Sq != Sk) each launch K4 once and
    agree with the CPU's ``attention()``; only a row with no visible key
    raises, before any launch."""
    from repro_torch.models.attention import attention
    rng = np.random.default_rng(9)
    q, kv = [torch.from_numpy(rng.normal(size=(1, n, h, 64))
                              .astype(np.float32)) for n, h in ((16, 4),
                                                                (24, 2))]
    for kw, k in (({"window": 8}, q[:, :, :2]), ({"q_offset": 4}, kv),
                  ({"causal": False}, kv[:, :8])):
        want = attention(q, k, k, **kw)
        K.reset_launch_counts()
        got = attention(q.to(cuda), k.to(cuda), k.to(cuda), **kw)
        assert K.launch_counts()["flash_attention"] == 1, kw
        assert got.shape == q.shape
        assert (got.cpu() - want).abs().max().item() < 2e-5, kw
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="sees no key"):
        attention(q.to(cuda), kv[:, :8].to(cuda), kv[:, :8].to(cuda),
                  causal=False, q_offset=8, window=8)
    assert K.launch_counts()["flash_attention"] == 0


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b",
                                  "deepseek-moe-16b", "starcoder2-7b",
                                  "recurrentgemma-2b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_lm_serve_on_gpu_matches_cpu(cuda, arch):
    """A small prefill + 4 decode steps in fp32, same weights, on the
    card (K4 or K5 in the prefill) and on the CPU (plain versions):
    logits within 1e-3 of their scale, caches likewise (bf16 leaves also
    within one bf16 rounding step, 2**-7 relative).  The hybrid model's
    window (48) is shorter than the 64-token prompt and does not divide
    it: the windowed K4 and the ring both work on the card.  The vlm
    prompt carries 16 seeded patch embeddings, the encdec prompt 16
    seeded frames: K4 serves the encoder, the decoder's self- and
    cross-attention in the prefill and the cross-attention of every
    decode step."""
    from repro_torch import configs
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import lm
    cfg = configs.get_smoke_config(arch).replace(dtype="float32", d_model=128)
    if cfg.family in ("dense", "moe", "vlm"):
        cfg = cfg.replace(n_heads=4, n_kv_heads=2, head_dim=64)
    if cfg.family == "encdec":
        cfg = cfg.replace(n_heads=2, n_kv_heads=2, head_dim=64)
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_heads=2, n_kv_heads=1, head_dim=64,
                          lru_width=128, local_window=48)
    gen = torch.Generator().manual_seed(2)
    params = lm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((2, cfg.n_patches, 128),
                                            generator=gen)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((2, 16, 128), generator=gen)
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    runs = []
    for dev in ("cpu", cuda):
        K.reset_launch_counts()
        p = _tree_to(params, dev)
        logits, cache = lm.prefill(p, _tree_to(batch, dev), cfg,
                                   lm.NO_PARALLEL)
        cache = grow_cache(cfg, cache, prefix + 68)
        out = [logits]
        for i in range(4):
            logits, cache = lm.decode_step(p, cache, toks[:, i:i + 1].to(dev),
                                           cfg, lm.NO_PARALLEL)
            out.append(logits)
        dtypes = {k: v.dtype for k, v in cache.items()}
        runs.append(([o.cpu() for o in out],
                     {k: v.cpu().float() for k, v in cache.items()},
                     K.launch_counts()))
    (lc, cc, nc), (lg, cg, ng) = runs
    for a, b in zip(lc, lg):
        assert (a - b).abs().max().item() < 1e-3 * a.abs().max().item()
    for k in cc:          # a bf16 leaf may also differ by one bf16 step
        allow = 1e-3 * max(1.0, cc[k].abs().max().item()) \
            + (cc[k].abs() * 2.0 ** -7 if dtypes[k] == torch.bfloat16 else 0)
        assert ((cc[k] - cg[k]).abs() <= allow).all(), k
    name = "ssd_intra" if cfg.family == "ssm" else "flash_attention"
    launches = sum(cfg.pattern_at(i) == "a" for i in range(
        cfg.n_layers)) if cfg.family == "hybrid" else cfg.n_layers
    if cfg.family == "encdec":      # the prefill's encoder, decoder self-
        # and cross-attention, then cross-attention in 4 decode steps
        launches = cfg.n_enc_layers + 2 * cfg.n_layers + 4 * cfg.n_layers
    assert set(nc.values()) == {0} and ng[name] == launches


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b",
                                  "deepseek-moe-16b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_train_step_on_gpu_matches_cpu(cuda, arch):
    """``train_loss`` and every gradient leaf in fp32, same weights and
    batch, on the card (K4 or K5 forward, remat recompute and backward
    kernels) and on the CPU (plain versions under autograd): the loss
    within 1e-5 of itself, each leaf within 1e-3 of its max |want| (fp32
    sums in other orders through the layers); every leaf gets a
    gradient, and the kernels launch twice a layer forward (remat) and
    once backward.  The moe config runs at the no-drop capacity factor
    (a route that flips at a gate margin would move a token's
    gradient)."""
    from repro_torch import configs
    from repro_torch import tree as pt
    from repro_torch.models import lm
    from repro_torch.train.step import value_and_grad
    cfg = configs.get_smoke_config(arch).replace(dtype="float32",
                                                 d_model=128)
    if cfg.family in ("dense", "moe", "vlm"):
        cfg = cfg.replace(n_heads=4, n_kv_heads=2, head_dim=64)
    if cfg.family == "encdec":
        cfg = cfg.replace(n_heads=2, n_kv_heads=2, head_dim=64)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    gen = torch.Generator().manual_seed(4)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((2, cfg.n_patches, 128),
                                            generator=gen)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((2, 16, 128), generator=gen)

    def loss_fn(p, b):
        return lm.train_loss(p, b, cfg, lm.NO_PARALLEL, remat=True)
    want_loss, want, _ = value_and_grad(loss_fn, params, batch)
    K.reset_launch_counts()
    loss, got, missing = value_and_grad(loss_fn, _tree_to(params, cuda),
                                        _tree_to(batch, cuda))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert missing == 0
    if cfg.family == "ssm":
        assert (counts["ssd_intra"], counts["ssd_intra_bwd"]) == (
            2 * cfg.n_layers, cfg.n_layers)
    else:
        n_attn = cfg.n_layers if cfg.family != "encdec" else \
            cfg.n_enc_layers + 2 * cfg.n_layers
        assert (counts["flash_attention"],
                counts["flash_attention_bwd"]) == (2 * n_attn, n_attn)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    for g, w in zip(pt.leaves(got), pt.leaves(want)):
        err = (g.cpu() - w).abs().max().item()
        assert err <= 1e-3 * w.abs().max().item() + 1e-7, err
