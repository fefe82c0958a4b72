"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no GPU is present;
on a machine with one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it runs where only PyTorch is installed).
Tolerances: the latch and fetch kernels must match exactly; paged
attention agrees within 2e-5 with an fp32 output and 3e-2 with a bf16
one (the kernel sums in another order than the plain version).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.gcl_fetch import gcl_fetch_plain  # noqa: E402
from repro_torch.kernels.latch_ops import REQ_KEYS, \
    latch_apply_plain  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention_plain  # noqa: E402

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


@pytest.mark.parametrize("hd,qdt,kvdt,tol", [
    (64, torch.float32, torch.float32, 2e-5),
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
                                 "paged_attention": 0}


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
    assert set(cnt_c.values()) == {0} and min(cnt_g.values()) > 0
