"""The port's hybrid family (recurrentgemma-2b: RG-LRU blocks and local
attention) against the JAX package's, on the CPU.

The same numpy inputs (and the same JAX-initialised weights, carried by
``convert.lm_params_to_torch``) go through both packages:

* the log-depth scan against a sequential fp32 loop, without underflow
  over 4096 steps; ``rg_lru`` (with and without h0), ``rg_lru_step``,
  ``_causal_conv`` and ``recurrent_block`` (prefill and decode) against
  JAX within 1e-5 in fp32 (a log-depth scan sums in its own order);
* windowed ``attention()`` against JAX's ``dense_attention`` and
  ``blockwise_attention`` with a window (2e-5), and the plain windowed
  K4 against ``dense_attention``; JAX's ``blockwise_attention`` with a
  window and ``block_q != block_k`` (its defaults) drops block pairs it
  needs, which the port does not copy, and a test records that;
* the ring of the local window: at smoke size (W 64), a prefill of S
  tokens then 8 decode steps against a prefill of S + 1 .. S + 8 tokens,
  within 1e-4 of the logits' scale in fp32, at S = 64 and at S = 80
  (> W, not a multiple of it), where the port's prefill puts position p
  at slot p % W; at S = 64 it also equals JAX's decode, and a test
  records that JAX's own continuation differs at S = 80 (its prefill
  keeps the last W keys at slots 0..W-1);
* ``convert.lm_params_to_torch`` carries the hybrid tree (a list of
  per-layer dicts) bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


ARCH = "recurrentgemma-2b"


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ RG-LRU

@pytest.mark.parametrize("s", [1, 7, 64, 4096])
def test_linear_scan_matches_a_sequential_loop(s):
    """Every prefix of h_t = a_t h_{t-1} + b_t, with a in (0, 1) as the
    RG-LRU makes it: the product of a over 4096 steps underflows fp32,
    the scan never forms it."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.05, 0.999, (2, s, 8)).astype(np.float32)
    b = rng.normal(size=(2, s, 8)).astype(np.float32)
    want = np.zeros_like(b)
    h = np.zeros((2, 8), np.float32)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = trg.linear_scan(_t(a), _t(b))
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s", [16, 100])
def test_rg_lru_matches_jax(s, h0):
    rng = np.random.default_rng(s + h0)
    x, r, i = (rng.normal(size=(2, s, 32)).astype(np.float32)
               for _ in range(3))
    lam = rng.normal(size=(32,)).astype(np.float32)
    hp = rng.normal(size=(2, 32)).astype(np.float32) if h0 else None
    yj, hj = jax.jit(jrg.rg_lru)(*[jnp.asarray(a) for a in (x, r, i, lam)],
                                 h0=None if hp is None else jnp.asarray(hp))
    yt, ht = trg.rg_lru(*[_t(a) for a in (x, r, i, lam)],
                        h0=None if hp is None else _t(hp))
    _close(yt, yj, 1e-5)
    _close(ht, hj, 1e-5)
    assert ht.dtype == torch.float32
    yj, hj = jrg.rg_lru_step(*[jnp.asarray(a[:, 0]) for a in (x, r, i)],
                             jnp.asarray(lam), hj)
    yt, ht = trg.rg_lru_step(*[_t(a[:, 0]) for a in (x, r, i)], _t(lam),
                             ht)
    _close(yt, yj, 1e-5)
    _close(ht, hj, 1e-5)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 20, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    yj, tj = jrg._causal_conv(jnp.asarray(x), jnp.asarray(w))
    yt, tt = trg._causal_conv(_t(x), _t(w))
    _close(yt, yj, 1e-6)
    _close(tt, tj, 0)
    x1 = rng.normal(size=(2, 1, 16)).astype(np.float32)
    yj, tj = jrg._causal_conv(jnp.asarray(x1), jnp.asarray(w), tj)
    yt, tt = trg._causal_conv(_t(x1), _t(w), tt)
    _close(yt, yj, 1e-6)
    _close(tt, tj, 0)


def _jax_prefill(jcfg, params, toks):
    """JAX's ``lm.prefill`` of ``toks``, jitted (eager JAX runs the
    associative scan op by op)."""
    fn = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t}, jcfg,
                                          jlm.NO_PARALLEL))
    return fn(params, jnp.asarray(toks))


def _jax_params(dtype="float32", seed=0, **over):
    jcfg = jax_smoke_config(ARCH).replace(dtype=dtype, **over)
    params = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = configs.get_smoke_config(ARCH).replace(dtype=dtype, **over)
    tparams = convert.lm_params_to_torch(
        jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, tcfg, tparams


def test_recurrent_block_matches_jax():
    jcfg, params, tcfg, tparams = _jax_params()
    jp, tp = params["blocks"][0]["rec"], tparams["blocks"][0]["rec"]
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 48, tcfg.d_model)).astype(np.float32)
    block = jax.jit(lambda x, p, c=None: jrg.recurrent_block(x, p, jcfg,
                                                             cache=c))
    yj, (hj, cj) = block(jnp.asarray(x), jp)
    yt, (ht, ct) = trg.recurrent_block(_t(x), tp, tcfg)
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        _close(a, b, 1e-5)
    x1 = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    yj, (hj, cj) = block(jnp.asarray(x1), jp, (hj, cj))
    yt, (ht, ct) = trg.recurrent_block(_t(x1), tp, tcfg, cache=(ht, ct))
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        _close(a, b, 1e-5)


# ------------------------------------------------ windowed attention

def _qkv(seed, s, hq=4, hkv=2, hd=32, b=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, hd)).astype(np.float32)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 5, 20, 64, 100])
def test_windowed_attention_matches_jax(window, causal):
    """``attention()`` with a window against JAX's ``dense_attention``
    (the port's dense path) and JAX's ``blockwise_attention`` with equal
    blocks (the port's blockwise path), and the plain K4 likewise."""
    q, k, v = _qkv(window, 64)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    dense = jattn.dense_attention(qj, kj, vj, causal=causal, window=window)
    blockwise = jattn.blockwise_attention(qj, kj, vj, causal=causal,
                                          window=window, block_q=16,
                                          block_k=16)
    np.testing.assert_allclose(np.asarray(blockwise), np.asarray(dense),
                               atol=2e-5)
    got = tattn.attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert np.abs(_np(got) - np.asarray(dense)).max() < 2e-5
    got = tattn.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          dense_threshold=16, block_q=16, block_k=16)
    assert np.abs(_np(got) - np.asarray(blockwise)).max() < 2e-5
    got = flash_attention(*[_t(a).transpose(1, 2) for a in (q, k, v)],
                          causal=causal, window=window).transpose(1, 2)
    assert np.abs(_np(got) - np.asarray(dense)).max() < 2e-5


@pytest.mark.parametrize("s,window,bq,bk", [(256, 48, 32, 64),
                                            (256, 48, 64, 32),
                                            (512, 100, 64, 128)])
def test_blockwise_window_with_unequal_blocks(s, window, bq, bk):
    """JAX's ``_block_pairs`` compares a q block index with a k block
    index of another size, so with a window and block_q != block_k it
    leaves out pairs that hold visible keys; its defaults (512, 1024) do
    that at S 4096 with W 2048.  The port counts block extents in token
    positions and matches the dense result."""
    q, k, v = _qkv(s + window, s)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    dense = np.asarray(jattn.dense_attention(qj, kj, vj, window=window))
    jblock = np.asarray(jattn.blockwise_attention(
        qj, kj, vj, window=window, block_q=bq, block_k=bk))
    print(f"S {s}, W {window}, blocks {bq}/{bk}: JAX's blockwise off "
          f"dense by {np.abs(jblock - dense).max():.4g}")
    assert np.abs(jblock - dense).max() > 0.1         # the reference's fault
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), window=window,
                                    block_q=bq, block_k=bk)
    assert np.abs(_np(got) - dense).max() < 2e-5


def test_block_pairs_skip_only_wholly_masked_pairs():
    """Every (q block, k block) pair the port leaves out has no visible
    (query, key) pair, and every pair it keeps has one, for causal and
    windowed footprints with unequal blocks and a query offset."""
    for bq, bk, window, off in [(16, 32, 20, 0), (32, 16, 7, 0),
                                (16, 16, None, 0), (8, 24, 50, 40)]:
        n_q, n_k = 96 // bq, 144 // bk
        pairs = set(tattn._block_pairs(n_q, n_k, bq, bk, True, window, off))
        for iq in range(n_q):
            for ik in range(n_k):
                qp = off + np.arange(iq * bq, (iq + 1) * bq)[:, None]
                kp = np.arange(ik * bk, (ik + 1) * bk)[None, :]
                vis = (kp <= qp) & (kp > qp - (window or 10 ** 9))
                assert ((iq, ik) in pairs) == bool(vis.any()), \
                    (bq, bk, window, off, iq, ik)


def test_flash_rejects_a_window_below_one():
    x = torch.zeros((1, 2, 8, 64))
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError, match="window"):
            flash_attention(x, x[:, :1], x[:, :1], window=bad)


# ------------------------------------------------------- the ring

def _tokens(n, vocab, seed=13):
    return np.random.default_rng(seed).integers(0, vocab, (2, n)).astype(
        np.int32)


def _port_continuation(tparams, tcfg, toks, s, n_dec):
    """The port's prefill of ``toks[:, :s]`` then ``n_dec`` decode steps
    on ``toks[:, s:]``: the logits of each step."""
    logits, cache = tlm.prefill(tparams, {"tokens": _t(toks[:, :s]).long()},
                                tcfg, tlm.NO_PARALLEL)
    cache = tserve.grow_cache(tcfg, cache, s + n_dec)
    out = []
    for i in range(n_dec):
        logits, cache = tlm.decode_step(tparams, cache,
                                        _t(toks[:, s + i:s + i + 1]).long(),
                                        tcfg, tlm.NO_PARALLEL)
        out.append(_np(logits))
    return out


@pytest.mark.parametrize("s", [64, 80, 150])
def test_ring_continuation_equals_the_longer_prefill(s):
    """W = 64: a prefill of S tokens then 8 decode steps gives, at every
    step, the last logits of a prefill of the tokens so far, within 1e-4
    of their scale (fp32; at S > W the ring holds the prefill's fp32
    keys, so no bf16 rounding enters)."""
    _, _, tcfg, tparams = _jax_params()
    assert tcfg.local_window == 64
    n_dec = 8
    toks = _tokens(s + n_dec, tcfg.vocab)
    got = _port_continuation(tparams, tcfg, toks, s, n_dec)
    for i in range(n_dec):
        want, _ = tlm.prefill(tparams,
                              {"tokens": _t(toks[:, :s + i + 1]).long()},
                              tcfg, tlm.NO_PARALLEL)
        want = _np(want)
        assert np.abs(got[i] - want).max() < 1e-4 * np.abs(want).max(), i


def test_ring_prefill_puts_position_p_at_slot_p_mod_w():
    """At S = 80 the port's ring is JAX's (the last 64 keys) rolled so
    that position p sits at slot p % 64."""
    jcfg, params, tcfg, tparams = _jax_params()
    toks = _tokens(80, tcfg.vocab)
    _, jc = _jax_prefill(jcfg, params, toks)
    _, tc = tlm.prefill(tparams, {"tokens": _t(toks).long()}, tcfg,
                        tlm.NO_PARALLEL)
    for key in ("k", "v"):
        want = np.roll(np.asarray(jc[key]), 80 % 64, axis=2)
        np.testing.assert_allclose(_np(tc[key]), want, rtol=1e-5, atol=1e-5)
    for key in ("hrec", "conv"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                   rtol=1e-5, atol=1e-5)


def _jax_continuation(jcfg, params, toks, s, n_dec):
    ctx = jlm.NO_PARALLEL
    logits, cache = _jax_prefill(jcfg, params, toks[:, :s])
    b = toks.shape[0]
    full = jlm.init_decode_cache(jcfg, b, s + n_dec)
    for k in cache:           # repro/launch/serve.py's cache growth
        if k in full and cache[k].shape != full[k].shape and k != "pos":
            full[k] = full[k].at[tuple(slice(0, n) for n in
                                       cache[k].shape)].set(cache[k])
        else:
            full[k] = cache[k]
    step = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg, ctx))
    out = []
    for i in range(n_dec):
        logits, full = step(params, full,
                            jnp.asarray(toks[:, s + i:s + i + 1]))
        out.append(np.asarray(logits))
    return out


def test_ring_decode_matches_jax_where_the_layouts_agree():
    """S = 64 = W: JAX's prefill layout is p % W too, and the port's
    prefill-then-decode equals JAX's within 1e-4 of the scale (fp32)."""
    jcfg, params, tcfg, tparams = _jax_params()
    toks = _tokens(72, tcfg.vocab)
    got = _port_continuation(tparams, tcfg, toks, 64, 8)
    want = _jax_continuation(jcfg, params, toks, 64, 8)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 1e-4 * np.abs(w).max()


def test_jax_ring_continuation_differs_past_the_window():
    """The reference's fault, recorded: at S = 80 (> W = 64, 80 % 64 =
    16) JAX's first decode step overwrites slot 16, which holds position
    32 (still inside the window of position 80) instead of position 16;
    its continuation leaves the longer prefill by more than 1e-2 of the
    scale, while the port's stays within 1e-4."""
    jcfg, params, tcfg, tparams = _jax_params()
    n_dec = 6
    toks = _tokens(80 + n_dec, tcfg.vocab)
    jax_dec = _jax_continuation(jcfg, params, toks, 80, n_dec)
    port_dec = _port_continuation(tparams, tcfg, toks, 80, n_dec)
    jax_err = port_err = 0.0
    for i in range(n_dec):
        want, _ = _jax_prefill(jcfg, params, toks[:, :81 + i])
        want = np.asarray(want)
        scale = np.abs(want).max()
        jax_err = max(jax_err, np.abs(jax_dec[i] - want).max() / scale)
        port_err = max(port_err, np.abs(port_dec[i] - want).max() / scale)
    print(f"S 80, W 64, {n_dec} decode steps against the longer "
          f"prefills: JAX off by {jax_err:.4g}, the port by {port_err:.4g} "
          f"of the logits' scale")
    assert jax_err > 1e-2
    assert port_err < 1e-4


def test_ring_smaller_than_the_window_grows_for_decode():
    """A prompt shorter than W: the prefill's ring has S slots and
    ``grow_cache`` widens it to min(W, max_len), keeping position p at
    slot p, as JAX's serve loop does."""
    jcfg, params, tcfg, tparams = _jax_params()
    toks = _tokens(40, tcfg.vocab)
    _, tc = tlm.prefill(tparams, {"tokens": _t(toks[:, :32]).long()}, tcfg,
                        tlm.NO_PARALLEL)
    assert tc["k"].shape[2] == 32
    grown = tserve.grow_cache(tcfg, tc, 40)
    assert grown["k"].shape[2] == 40 and grown["k"].dtype == torch.bfloat16
    assert grown["hrec"].dtype == torch.float32
    np.testing.assert_array_equal(_np(grown["k"][:, :, :32]),
                                  _np(tc["k"].to(torch.bfloat16)))
    got = _port_continuation(tparams, tcfg, toks, 32, 8)
    want = _jax_continuation(jcfg, params, toks, 32, 8)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 1e-4 * np.abs(w).max()


def test_lm_params_to_torch_carries_the_hybrid_list():
    jcfg = jax_smoke_config(ARCH)
    params = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    back = convert.lm_params_to_torch(jax.tree.map(np.asarray, params),
                                      "cpu")
    assert isinstance(back["blocks"], list) and \
        len(back["blocks"]) == jcfg.n_layers
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert any(len(path) > 3 for path, _ in leaves)
    for path, a in leaves:
        t = back
        for p in path:
            t = t[p.idx] if hasattr(p, "idx") else t[p.key]
        assert t.dtype == (torch.float32 if a.dtype == np.float32
                           else torch.bfloat16)
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
