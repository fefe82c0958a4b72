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


def test_plain_versions_treat_out_of_range_as_empty():
    """Port-only: a K1 line at or past N, or a K2 page at or past P, is
    an empty slot in the plain versions, as in the kernels (the JAX
    references clamp the read and drop the write instead): every output
    equals the one for the same batch with those slots at -1."""
    words, req = _latch_inputs(4, 16, 24, 6)
    far = req["line"].copy()
    far[[1, 5, 9, 13]] = [16, 19, 16, 19]          # N and N + 3
    cut = far.copy()
    cut[[1, 5, 9, 13]] = -1
    got = _port_latch(words, {**req, "line": far})
    want = _port_latch(words, {**req, "line": cut})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[3][[1, 5, 9, 13]] == 0).all() and got[3].any()
    pages, words, req_page, bit_hi, bit_lo = _fetch_inputs(
        6, 8, 16, 12, np.int32, False)
    far = req_page.copy()
    far[[0, 3, 7]] = [2**30, 2**31 - 1, 2**30]
    cut = far.copy()
    cut[[0, 3, 7]] = -1
    got, want = (gcl_fetch_plain(*[torch.from_numpy(a) for a in
                                   (pages, words, p, bit_hi, bit_lo)])
                 for p in (far, cut))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (got[3][[0, 3, 7]] == 0).all() and got[3].any()


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


# ------------------------------------------- K4 and K5 backward (plain)
# The Pallas kernels are forward-only; JAX differentiates their jnp
# references.  Each plain backward is held against jax.vjp of the
# kernel's ref.py (and of the model's dense_attention for the masks the
# Pallas kernel lacks) and against torch autograd of the plain forward.
# Tolerances: fp32 within 2e-5 of each gradient's scale (max(1, |want|);
# fp32 sums in another order), bf16 inputs within 2e-2 of it (the two
# sides round their bf16 outputs, and the port's D reads the bf16 output).

def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _torch_in(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,dtype,tol", [
    (2, 64, 4, 2, 32, True, "float32", 2e-5),     # GQA group 2
    (1, 50, 4, 2, 16, True, "float32", 2e-5),     # ragged S
    (2, 33, 2, 2, 16, False, "float32", 2e-5),
    (2, 64, 4, 2, 32, True, "bfloat16", 2e-2)])
def test_flash_bwd_plain_matches_jax_vjp(b, s, hq, hkv, hd, causal, dtype,
                                         tol):
    import jax
    from repro.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain)
    rng = np.random.default_rng(s + hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v = [jnp.asarray(rng.normal(size=(b, h, s, hd)), jdt)
               for h in (hq, hkv, hkv)]
    do = jnp.asarray(rng.normal(size=(b, hq, s, hd)), jdt)
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_ref(
        q, k, v, causal=causal), q, k, v)
    want = vjp(do)
    tq, tk, tv, tdo = [_torch_in(a, tdt) for a in (q, k, v, do)]
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                    causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        assert _rel(g.float().numpy(), w) < tol
    ins = [t.detach().float().requires_grad_() for t in (tq, tk, tv)]
    (flash_attention_plain(*ins, causal=causal) * tdo.float()).sum() \
        .backward()
    for g, t in zip(got, ins):
        assert _rel(g.float().numpy(), t.grad.numpy()) < tol


@pytest.mark.parametrize("sq,sk,q_offset,window,causal", [
    (40, 40, 0, 9, True), (24, 56, 0, None, False), (1, 56, 0, None, False),
    (24, 56, 32, None, True), (24, 56, 32, 12, True)])
def test_flash_bwd_plain_masks_match_dense_attention(sq, sk, q_offset,
                                                     window, causal):
    """Window, Sq != Sk and query offsets against jax.vjp of the model's
    dense_attention ([B, S, H, hd] layout), fp32."""
    import jax
    from repro.models.attention import dense_attention
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain)
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k, v = rng.normal(size=(2, 2, sk, 2, 16)).astype(np.float32)
    do = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, vjp = jax.vjp(lambda q, k, v: dense_attention(q, k, v, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = [torch.from_numpy(a).transpose(1, 2)
                       for a in (q, k, v, do)]
    out, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, **kw)
    for g, w in zip(got, want):
        assert _rel(g.transpose(1, 2).numpy(), w) < 2e-5


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("bc,q,h,p", [(2, 32, 3, 16), (3, 20, 2, 8)])
def test_ssd_bwd_plain_matches_jax_vjp(bc, q, h, p, steep):
    """The plain K5 backward against jax.vjp and torch autograd of the
    plain forward, fp32 (2e-5 of each gradient's scale).  With a mild
    cumsum, against the kernel's ref.py itself; with one steep enough
    that exp overflows above the diagonal, ref.py's vjp is NaN there
    (``where(mask, exp(seg), 0)``: 0 times the derivative inf), so the
    reference is the same function with the select also before the exp,
    and the port's gradients must be finite."""
    import jax
    from repro.kernels.ssd_intra.ref import ssd_intra_ref
    from repro_torch.kernels.ssd_intra import (ssd_intra_bwd_plain,
                                               ssd_intra_plain)
    rng = np.random.default_rng(q)
    cb = rng.normal(size=(bc, q, q)).astype(np.float32)
    cs = (-np.abs(rng.normal(size=(bc, q, h)) * (40 if steep else 0.1))
          ).cumsum(1).astype(np.float32)
    win, dy = rng.normal(size=(2, bc, q, h, p)).astype(np.float32)

    def safe_ref(cb, cs, win):
        seg = cs[:, :, None, :] - cs[:, None, :, :]
        mask = jnp.tril(jnp.ones((q, q), bool))[None, :, :, None]
        l_mat = jnp.where(mask, jnp.exp(jnp.where(mask, seg, 0.0)), 0.0)
        return jnp.einsum("bqk,bqkh,bkhp->bqhp", cb, l_mat, win)
    assert np.isfinite(np.asarray(jax.vjp(
        ssd_intra_ref, jnp.asarray(cb), jnp.asarray(cs),
        jnp.asarray(win))[1](jnp.asarray(dy))[1])).all() != steep
    _, vjp = jax.vjp(safe_ref if steep else ssd_intra_ref, jnp.asarray(cb),
                     jnp.asarray(cs), jnp.asarray(win))
    want = vjp(jnp.asarray(dy))
    ins = [torch.from_numpy(a) for a in (cb, cs, win)]
    got = ssd_intra_bwd_plain(*ins, torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        assert _rel(g.numpy(), w) < 2e-5
    ins = [t.clone().requires_grad_() for t in ins]
    (ssd_intra_plain(*ins) * torch.from_numpy(dy)).sum().backward()
    for g, t in zip(got, ins):
        assert _rel(g.numpy(), t.grad.numpy()) < 2e-5


def test_backward_wrappers_run_plain_on_the_cpu():
    """On CPU tensors the backward wrappers run their plain versions and
    count no launch."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    K.reset_launch_counts()
    x = torch.randn(1, 2, 8, 16)
    out, lse = flash_attention_plain(x, x, x, return_lse=True)
    dq, dk, dv = K.flash_attention_bwd(x, x, x, out, lse, x)
    assert dq.shape == x.shape and torch.isfinite(dq).all()
    cs = -torch.rand(1, 8, 2).cumsum(1)
    cb, win = torch.randn(1, 8, 8), torch.randn(1, 8, 2, 4)
    grads = K.ssd_intra_bwd(cb, cs, win, torch.randn(1, 8, 2, 4),
                            K.ssd_intra(cb, cs, win))
    assert [tuple(g.shape) for g in grads] == [(1, 8, 8), (1, 8, 2),
                                               (1, 8, 2, 4)]
    assert K.launch_counts() == dict.fromkeys(K.WRAPPERS, 0)


def test_gradient_row_check_catches_a_wrong_key_tile():
    """The card's check of K4's backward (``chip_smoke.grad_row_rel``,
    each gradient row within 1e-2 of its L2 norm, floored at a tenth of
    the tensor's RMS row norm) catches dK off by 30 % on the last key
    tile of one head, which the bound over the tensor's max passes
    (3e-2); and the floor takes the causal row that sees one key, whose
    exact dq is zero (P = 1, dS = dP - D = 0): there both versions are
    rounding noise."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain)
    rng = np.random.default_rng(3)
    b, s, hq, hkv, hd = 1, 512, 4, 2, 64
    q, k, v, do = [torch.from_numpy(rng.normal(size=(b, n, h, hd))
                                    .astype(np.float32)).transpose(1, 2)
                   for n, h in ((s, hq), (s, hkv), (s, hkv), (s, hq))]
    out, lse = flash_attention_plain(q, k, v, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do)
    rms = float(want[0].norm(dim=-1).square().mean().sqrt())
    assert float(want[0][:, :, 0].norm(dim=-1).max()) < 1e-5 * rms
    dk = want[1].clone()
    dk[:, 1, 448:] *= 0.7
    bad = (want[0], dk, want[2])
    assert cs._grad_rel(bad, want) < cs.BWD_TOL
    assert cs.grad_row_rel(bad, want) > 0.29
    noise = torch.from_numpy(rng.normal(size=want[0].shape)
                             .astype(np.float32)) * 1e-6 * rms
    noisy = (want[0] + noise, want[1], want[2])
    assert cs.grad_row_rel(noisy, want) < cs.BWD_ROW_TOL
