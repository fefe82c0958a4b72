"""The port's kernels against the JAX package's kernels.

Each plain PyTorch version (what a wrapper runs for CPU tensors) is held
against the JAX reference (``backend="ref"``) on the same numpy inputs,
plus one small case through the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it.  Tolerances: the latch and fetch
kernels are integer/bit copies and must match exactly; paged attention
agrees within 2e-5 in fp32 and 3e-2 in bf16 (summation order), on rows
with ``lens > 0`` (for ``lens == 0`` the port follows the Pallas kernel
and returns zeros, while the JAX ``ref.py`` returns a mean).

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import coherence as co  # noqa: E402
from repro.kernels.gcl_fetch.ops import fetch as jax_fetch  # noqa: E402
from repro.kernels.latch_ops.ops import \
    apply_batch as jax_apply_batch  # noqa: E402
from repro.kernels.paged_attention.ops import \
    decode_paged as jax_decode_paged  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.gcl_fetch import gcl_fetch_plain  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention_plain  # noqa: E402

KEYS = ("line", "op", "arg_hi", "arg_lo", "cmp_hi", "cmp_lo")


def _lanes64(value):
    v = value & ((1 << 64) - 1)
    return (np.int32(np.uint32(v >> 32)), np.int32(np.uint32(v & 0xFFFFFFFF)))


def _latch_inputs(seed, n, r, n_hot):
    """Random batch on n words: lines drawn from n_hot hot lines (long
    same-line chains) plus -1 slots; CAS compares against the current
    word half the time so swaps happen; addends reach the lane carry."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, (n, 2)).astype(np.int32)
    words[:4, 1] = -1                          # lo = 0xFFFFFFFF: carries
    words[0, 0] = -1                           # whole word 2**64 - 1
    line = rng.integers(0, n_hot, r).astype(np.int32)
    line[rng.random(r) < 0.15] = -1
    op = rng.integers(0, 2, r).astype(np.int32)
    cmp = words[np.maximum(line, 0)].copy()
    miss = rng.random(r) < 0.5
    cmp[miss] = rng.integers(-2**31, 2**31, (miss.sum(), 2))
    req = {"line": line, "op": op,
           "arg_hi": rng.integers(-4, 4, r).astype(np.int32),
           "arg_lo": rng.integers(-2**31, 2**31, r).astype(np.int32),
           "cmp_hi": cmp[:, 0].astype(np.int32),
           "cmp_lo": cmp[:, 1].astype(np.int32)}
    return words, req


def _port_latch(words, req, device="cpu"):
    out = K.apply_batch(torch.from_numpy(words).to(device),
                        {k: torch.from_numpy(v).to(device)
                         for k, v in req.items()})
    return [o.cpu().numpy() for o in out]


def _jax_latch(words, req, backend="ref"):
    out = jax_apply_batch(jnp.asarray(words),
                          {k: jnp.asarray(v) for k, v in req.items()},
                          backend=backend)
    return [np.asarray(o) for o in out]


# ------------------------------------------------------------ K1 latch_ops

@pytest.mark.parametrize("seed,n,r,n_hot", [
    (0, 64, 32, 4), (1, 64, 48, 16), (2, 256, 64, 64), (3, 16, 8, 2)])
def test_latch_plain_matches_jax(seed, n, r, n_hot):
    words, req = _latch_inputs(seed, n, r, n_hot)
    for want, got in zip(_jax_latch(words, req), _port_latch(words, req)):
        np.testing.assert_array_equal(got, want)


def test_latch_plain_matches_pallas_interpret():
    words, req = _latch_inputs(11, 1024, 24, 6)
    want = _jax_latch(words, req, backend="pallas")
    for w, g in zip(want, _port_latch(words, req)):
        np.testing.assert_array_equal(g, w)


def test_latch_plain_chain_carry_and_wrap():
    """Same-line FAAs chain in request order; the lo->hi carry and the
    2**64 wrap behave like the NIC's 64-bit atomic."""
    words = np.zeros((8, 2), np.int32)
    words[5] = _lanes64(0xFFFFFFFF)            # lo all ones
    words[6] = _lanes64((1 << 64) - 1)         # whole word all ones
    one = _lanes64(1)
    req = {"line": np.asarray([5, 5, 6, -1, 5], np.int32),
           "op": np.asarray([1, 1, 1, 1, 0], np.int32),
           "arg_hi": np.asarray([one[0]] * 4 + [0], np.int32),
           "arg_lo": np.asarray([one[1]] * 4 + [7], np.int32),
           "cmp_hi": np.asarray([0, 0, 0, 0, 1], np.int32),
           "cmp_lo": np.asarray([0, 0, 0, 0, 1], np.int32)}
    new, old_hi, old_lo, ok = _port_latch(words, req)
    olds = [co.from_lanes(int(np.uint32(h)), int(np.uint32(lo)))
            for h, lo in zip(old_hi, old_lo)]
    assert olds == [0xFFFFFFFF, 1 << 32, (1 << 64) - 1, 0, (1 << 32) + 1]
    assert list(ok) == [1, 1, 1, 0, 1]         # slot 4: CAS hits 2**32+1
    assert tuple(new[5]) == (0, 7)             # swapped in by the CAS
    assert tuple(new[6]) == (0, 0)             # wrapped
    for want, got in zip(_jax_latch(words, req), (new, old_hi, old_lo, ok)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ K2 gcl_fetch

def _fetch_inputs(seed, p, e, r, dtype, dup_free):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        pages = rng.integers(-2**31, 2**31, (p, e)).astype(np.int32)
    else:
        pages = rng.normal(size=(p, e)).astype(dtype)
    words = rng.integers(0, 2**20, (p, 2)).astype(np.int32)
    words[::3, 0] |= 5 << 24                   # some exclusive holders
    # page 0 is never requested: JAX's reference merges bits with
    # .at[].set, where a -1 slot (index 0) would race a real request
    if dup_free:
        req = 1 + rng.permutation(p - 1)[:r].astype(np.int32)
        bits = rng.integers(1, 2**8, (2, r)).astype(np.int32)
    else:                                      # duplicates, equal bits
        req = rng.integers(1, p // 2, r).astype(np.int32)
        bits = np.stack([np.full(r, 1 << 3), np.full(r, 1 << 9)]) \
            .astype(np.int32)
    req[rng.random(r) < 0.2] = -1
    return pages, words, req, bits[0], bits[1]


@pytest.mark.parametrize("dtype,dup_free", [
    (np.float32, True), (np.int32, True), (np.int32, False)])
def test_fetch_plain_matches_jax(dtype, dup_free):
    args = _fetch_inputs(3, 32, 96, 20, dtype, dup_free)
    want = jax_fetch(*[jnp.asarray(a) for a in args], backend="ref")
    got = gcl_fetch_plain(*[torch.from_numpy(a) for a in args])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fetch_plain_matches_pallas_interpret():
    args = _fetch_inputs(5, 16, 128, 8, np.float32, True)
    want = jax_fetch(*[jnp.asarray(a) for a in args], backend="pallas",
                     interpret=True)
    got = gcl_fetch_plain(*[torch.from_numpy(a) for a in args])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fetch_duplicate_requests_or_their_bits():
    """Port-only: duplicate requests for one page OR their reader bits
    (the reference's docstring; JAX's .at[].set leaves it undefined)."""
    pages = torch.arange(12, dtype=torch.int32).view(4, 3)
    words = torch.zeros((4, 2), dtype=torch.int32)
    req = torch.tensor([2, 2, -1, 2, 1], dtype=torch.int32)
    bit_hi = torch.tensor([1, 2, 64, 0, 8], dtype=torch.int32)
    bit_lo = torch.tensor([16, 0, 64, 32, 4], dtype=torch.int32)
    payload, _, _, granted, new = K.fetch(pages, words, req, bit_hi, bit_lo)
    assert new.tolist() == [[0, 0], [8, 4], [3, 48], [0, 0]]
    assert payload[2].tolist() == [0, 0, 0] and granted.tolist() == \
        [1, 1, 0, 1, 1]


# ----------------------------------------------------- K3 paged_attention

def _attn_inputs(seed, b, hq, hkv, hd, page, mp, pool, tails=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, hd)).astype(np.float32)
    kp = rng.normal(size=(pool, page, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(pool, page, hkv, hd)).astype(np.float32)
    lens = rng.integers(1, mp * page + 1, b).astype(np.int32)
    lens[0] = 0                                 # an idle slot
    tbl = rng.integers(0, pool, (b, mp)).astype(np.int32)
    if tails:                                   # -1 past the valid pages
        for i, n in enumerate(lens):
            tbl[i, -(-int(n) // page):] = -1
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("b,hq,hkv,hd,page,mp,pool,dtype,tol", [
    (4, 8, 2, 64, 16, 8, 64, "float32", 2e-5),
    (3, 4, 4, 128, 8, 4, 16, "float32", 2e-5),
    (4, 16, 8, 128, 16, 4, 32, "bfloat16", 3e-2),
    (2, 4, 1, 32, 4, 6, 12, "bfloat16", 3e-2),
])
def test_paged_attention_plain_matches_jax(b, hq, hkv, hd, page, mp, pool,
                                           dtype, tol):
    q, kp, vp, tbl, lens = _attn_inputs(7, b, hq, hkv, hd, page, mp, pool)
    jdt = getattr(jnp, dtype)
    want = jax_decode_paged(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                            jnp.asarray(vp, jdt), jnp.asarray(tbl),
                            jnp.asarray(lens), backend="ref")
    tdt = getattr(torch, dtype)
    got = K.decode_paged(torch.from_numpy(q).to(tdt),
                         torch.from_numpy(kp).to(tdt),
                         torch.from_numpy(vp).to(tdt),
                         torch.from_numpy(tbl), torch.from_numpy(lens))
    assert got.dtype == tdt
    live = lens > 0
    err = np.abs(got.float().numpy()[live]
                 - np.asarray(want.astype(jnp.float32))[live]).max()
    assert err < tol
    assert not got[~torch.from_numpy(live)].any()   # lens == 0 -> zeros


def test_paged_attention_plain_matches_pallas_interpret():
    q, kp, vp, tbl, lens = _attn_inputs(9, 2, 4, 2, 64, 8, 4, 16,
                                        tails=False)
    lens[0] = 5
    want = jax_decode_paged(*[jnp.asarray(a) for a in (q, kp, vp, tbl,
                                                       lens)],
                            backend="pallas", interpret=True)
    got = paged_attention_plain(*[torch.from_numpy(a) for a in
                                  (q, kp, vp, tbl, lens)])
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match="words"):
        K.apply_batch(torch.zeros((4, 3), dtype=torch.int32),
                      {k: torch.zeros(2, dtype=torch.int32) for k in KEYS})
    with pytest.raises(ValueError, match="int32"):
        K.fetch(torch.zeros((4, 8)), torch.zeros((4, 2), dtype=torch.int32),
                torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="geometry"):
        K.decode_paged(torch.zeros((1, 3, 8)), torch.zeros((2, 4, 2, 8)),
                       torch.zeros((2, 4, 2, 8)),
                       torch.zeros((1, 2), dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32))
