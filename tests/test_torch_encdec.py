"""The vlm and encdec families of the port against the JAX package's, on
the CPU.

The same numpy inputs (and the same JAX-initialised weights, carried by
``convert.lm_params_to_torch``) go through both packages:

* the encoder-decoder's pieces, ``_enc_forward``, ``_cross_kv`` and
  ``_dec_block`` (a prefill and a decode step), against JAX in fp32
  within 1e-4 and in bf16 within 5e-2 of max(1, |want|) (the two
  frameworks round bf16 at other points);
* ``attention()`` and K4's plain version at Sq != Sk, with a query
  offset and with a window, against JAX's ``dense_attention`` and
  ``blockwise_attention`` (2e-5, fp32); a call in which a query row sees
  no key raises in K4 (JAX's dense path returns the mean of all V rows
  there, and so does the port's CPU ``attention()``);
* two faults of the JAX serve driver (``repro/launch/serve.py:55-73``),
  printed and asserted: it pads the encoder's cross K/V with zero keys
  that every decode step attends to, and it grows a vlm cache to
  prompt + gen slots though the prefill holds n_patches + prompt, which
  fails when gen < n_patches.  The port's driver does neither, and its
  continuations agree with longer prefills: within 1e-4 of the logits'
  scale on an fp32 decode cache, and within 5e-3 (encdec) and 2e-2
  (vlm) on the bf16 one the driver makes, as in JAX, whose rounding of
  the prompt's keys and values is the whole difference;
* ``convert.lm_params_to_torch`` carries the encdec tree bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


ENCDEC = "seamless-m4t-medium"
VLM = "llava-next-mistral-7b"
TOLS = {"float32": 1e-4, "bfloat16": 5e-2}


def _t(a):
    """numpy / JAX array -> CPU tensor with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(_np(got) - want) / np.maximum(1.0, np.abs(want))
    assert err.max() < tol, float(err.max())


def _params(arch, dtype="float32", seed=0):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    params_np = jax.tree.map(np.asarray,
                             jlm.init_params(jax.random.PRNGKey(seed), jcfg))
    tcfg = configs.get_smoke_config(arch).replace(dtype=dtype)
    return (jcfg, jax.tree.map(jnp.asarray, params_np), tcfg,
            convert.lm_params_to_torch(params_np, "cpu"))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _frames(rng, cfg, b, se, dtype):
    """Seeded frame embeddings in the model's dtype, as JAX and torch."""
    e = jnp.asarray(rng.normal(size=(b, se, cfg.d_model)), _jdt(dtype))
    return e, _t(e)


# ------------------------------------------------------- encdec pieces

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_enc_forward_matches_jax(dtype):
    jcfg, params, tcfg, tparams = _params(ENCDEC, dtype)
    je, te = _frames(np.random.default_rng(1), tcfg, 2, 24, dtype)
    want = jlm._enc_forward(params, je, jcfg, jlm.NO_PARALLEL)
    got = tlm._enc_forward(tparams, te, tcfg, tlm.NO_PARALLEL)
    assert got.dtype == _t(np.asarray(want[:1])).dtype
    _close(got, want, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_matches_jax(dtype):
    jcfg, params, tcfg, tparams = _params(ENCDEC, dtype)
    je, te = _frames(np.random.default_rng(2), tcfg, 2, 12, dtype)
    wk, wv = jlm._cross_kv(params, je, jcfg)
    gk, gv = tlm._cross_kv(tparams, te, tcfg)
    assert tuple(gk.shape) == wk.shape == (tcfg.n_layers, 2, 12,
                                           tcfg.n_kv_heads, tcfg.hd)
    _close(gk, wk, TOLS[dtype])
    _close(gv, wv, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dec_block_matches_jax(dtype):
    """One decoder layer over a 20-token prefill with 12 encoder rows,
    then one decode step on its cache (grown to 24 slots): the output,
    and the self-attention K/V of both."""
    jcfg, params, tcfg, tparams = _params(ENCDEC, dtype)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: a[0], params["dec_blocks"])
    tp = {k: v[0] for k, v in tparams["dec_blocks"].items()}
    jx, tx = _frames(rng, tcfg, 2, 20, dtype)
    jck, tck = _frames(rng, tcfg, 2, 12, dtype)
    shape = (2, 12, tcfg.n_kv_heads, tcfg.hd)
    jck, jcv = jck.reshape(shape), jck[:, ::-1].reshape(shape)
    tck, tcv = tck.reshape(shape), tck.flip(1).reshape(shape)
    ctx = jlm.NO_PARALLEL
    wy, (wk, wv) = jlm._dec_block(jx, jp, jcfg, ctx, (jck, jcv))
    gy, (gk, gv) = tlm._dec_block(tx, tp, tcfg, tlm.NO_PARALLEL, (tck, tcv))
    for got, want in ((gy, wy), (gk, wk), (gv, wv)):
        _close(got, want, TOLS[dtype])

    def grow(k):
        return np.concatenate([np.asarray(k, np.float32),
                               np.zeros((2, 4) + k.shape[2:], np.float32)],
                              axis=1)
    jkc, jvc = (jnp.asarray(grow(a), jnp.bfloat16) for a in (wk, wv))
    tkc, tvc = (_t(a) for a in (jkc, jvc))
    pos = np.full((2,), 20, np.int32)
    jx1, tx1 = _frames(rng, tcfg, 2, 1, dtype)
    wy, (wk, wv) = jlm._dec_block(jx1, jp, jcfg, ctx, (jck, jcv),
                                  cache=(jkc, jvc), pos=jnp.asarray(pos))
    gy, (gk, gv) = tlm._dec_block(tx1, tp, tcfg, tlm.NO_PARALLEL, (tck, tcv),
                                  cache=(tkc, tvc), pos=_t(pos))
    for got, want in ((gy, wy), (gk, wk), (gv, wv)):
        _close(got, want, TOLS[dtype])


# ------------------------------------------- attention: Sq != Sk, offset

@pytest.mark.parametrize("sq,sk,kw", [
    (16, 48, {"causal": False}),                     # cross-attention
    (1, 40, {"causal": False}),                      # its decode step
    (16, 64, {"q_offset": 48}),                      # the last 16 rows
    (32, 64, {"q_offset": 32, "window": 24}),
    (8, 40, {"causal": False, "q_offset": 30, "window": 16}),
    (24, 24, {"q_offset": 5}),                       # offset, Sq = Sk
    (32, 64, {"q_offset": 32, "dense_threshold": 16, "block_q": 16,
              "block_k": 16}),                       # blockwise
    (32, 64, {"q_offset": 32, "window": 24, "dense_threshold": 16,
              "block_q": 16, "block_k": 16}),
    (16, 48, {"causal": False, "dense_threshold": 8, "block_q": 8,
              "block_k": 16}),
])
def test_attention_with_offset_and_unequal_lengths_matches_jax(sq, sk, kw):
    """``attention()`` (dense, or block-wise under a low threshold) and
    the plain K4 against JAX's ``attention()``, whose route is the same
    (``dense_attention`` or ``blockwise_attention``), within 2e-5."""
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.normal(size=(2, sq, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw))
    got = tattn.attention(_t(q), _t(k), _t(v), **kw)
    assert np.abs(_np(got) - want).max() < 2e-5
    mask_kw = {n: kw[n] for n in ("causal", "window", "q_offset") if n in kw}
    ins = [_t(a).transpose(1, 2) for a in (q, k, v)]
    for fn in (flash_attention_plain, flash_attention):
        got = fn(*ins, **mask_kw).transpose(1, 2)
        assert np.abs(_np(got) - want).max() < 2e-5


@pytest.mark.parametrize("sq,sk,kw", [
    (8, 40, {"causal": False, "q_offset": 40, "window": 8}),
    (8, 16, {"q_offset": 20, "window": 4}),
    (4, 0, {"causal": False}),
])
def test_k4_refuses_a_row_with_no_visible_key(sq, sk, kw):
    """Where a query row sees no key, K4 (on every device) raises; JAX's
    dense path, and the port's CPU ``attention()`` that copies it, give
    that row the mean of all V rows."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, sq, 2, 32)).astype(np.float32)
    k = rng.normal(size=(1, sk, 1, 32)).astype(np.float32)
    ins = [_t(a).transpose(1, 2) for a in (q, k, k)]
    with pytest.raises(ValueError, match="sees no key"):
        flash_attention(*ins, **kw)
    if sk:
        want = np.asarray(jattn.dense_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), **kw))
        got = tattn.attention(_t(q), _t(k), _t(k), **kw)
        assert np.abs(_np(got) - want).max() < 2e-5
        np.testing.assert_allclose(want[0, -1, 0], k[0, :, 0].mean(0),
                                   atol=1e-5)


@pytest.mark.parametrize("bad", [-1, 2.5])
def test_k4_rejects_bad_offsets(bad):
    x = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(x, x[:, :1], x[:, :1], q_offset=bad)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_plain(x, x[:, :1], x[:, :1], q_offset=bad)


# ------------------------------------------- the JAX driver's two faults

def _jax_driver_grow(jcfg, cache, max_len, dtype=jnp.bfloat16):
    """``repro/launch/serve.py:63-73``, as the JAX driver runs it (into a
    bf16 cache unless ``dtype`` says otherwise)."""
    full = jlm.init_decode_cache(jcfg, cache["pos"].shape[0], max_len,
                                 dtype)
    for k in cache:
        if k in full and hasattr(cache[k], "shape") \
                and cache[k].shape != full[k].shape \
                and cache[k].ndim == full[k].ndim and k != "pos":
            sl = tuple(slice(0, s) for s in cache[k].shape)
            full[k] = full[k].at[sl].set(cache[k])
        else:
            full[k] = cache[k]
    return full


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def test_jax_driver_pads_the_cross_kv_with_zero_keys():
    """Smoke seamless-m4t-medium in fp32, prompt 64 with 16 random frames,
    gen 32, batch 2: the JAX driver grows ``cross_k``/``cross_v`` to
    (64 + 32) // 4 = 24 rows, and cross-attention takes no length, so a
    decode step also attends to 8 zero keys.  Against a prefill of the
    65 tokens over the same frames, JAX's step is off by more than 5e-2
    of max |logit|.  JAX's own step on a cache grown the same way but in
    fp32 and with the cross leaves kept at 16 rows is within 1e-4: the
    padding is the whole fault.  The port's driver (cross leaves kept,
    bf16 decode cache) is within 5e-3."""
    jcfg, params, tcfg, tparams = _params(ENCDEC)
    rng = np.random.default_rng(12)
    b, s, gen = 2, 64, 32
    toks = rng.integers(0, tcfg.vocab, (b, s + 1)).astype(np.int32)
    je, te = _frames(rng, tcfg, b, s // tcfg.enc_ratio, "float32")
    ctx = jlm.NO_PARALLEL
    jprefill = jax.jit(lambda p, t, e: jlm.prefill(
        p, {"tokens": t, "enc_embeds": e}, jcfg, ctx))
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg, ctx))
    want, _ = jprefill(params, jnp.asarray(toks), je)
    _, jc = jprefill(params, jnp.asarray(toks[:, :s]), je)
    nxt = jnp.asarray(toks[:, s:])
    padded = _jax_driver_grow(jcfg, jc, s + gen)
    assert padded["cross_k"].shape[2] == (s + gen) // tcfg.enc_ratio
    jax_err = _rel(jstep(params, padded, nxt)[0], want)
    kept = dict(_jax_driver_grow(jcfg, jc, s + gen, jnp.float32),
                cross_k=jc["cross_k"], cross_v=jc["cross_v"])
    kept_err = _rel(jstep(params, kept, nxt)[0], want)
    _, tc = tlm.prefill(tparams, {"tokens": _t(toks[:, :s]).long(),
                                  "enc_embeds": te}, tcfg, tlm.NO_PARALLEL)
    tc = tserve.grow_cache(tcfg, tc, s + gen)
    assert tc["cross_k"].shape[2] == s // tcfg.enc_ratio
    port_err = _rel(_np(tlm.decode_step(tparams, tc, _t(toks[:, s:]).long(),
                                        tcfg, tlm.NO_PARALLEL)[0]), want)
    print(f"seamless smoke fp32, S {s}, gen {gen}: one decode step against "
          f"a prefill of {s + 1} tokens is off by {jax_err:.4g} of max "
          f"|logit| with the JAX driver's padded cross K/V, {kept_err:.4g} "
          f"with them kept (fp32 cache), the port by {port_err:.4g} (bf16 "
          f"cache)")
    assert jax_err > 5e-2
    assert kept_err < 1e-4
    assert port_err < 5e-3


def test_jax_driver_growth_fails_when_the_image_outlasts_the_generation():
    """Smoke llava-next-mistral-7b (16 patches), prompt 64, gen 8: the
    prefill's cache holds 80 positions and the JAX driver grows it to
    64 + 8 = 72 slots, which raises.  The port's driver grows it to
    16 + 64 + 8 slots, and 8 decode steps on it agree with prefills of
    the same patches and the tokens so far within 2e-2 of the logits'
    scale; on the same layout in fp32, within 1e-4 (the bf16 cache's
    rounding of the patches' keys and values, which are larger than the
    tokens', is the difference)."""
    jcfg, params, tcfg, tparams = _params(VLM)
    rng = np.random.default_rng(13)
    b, s, gen = 2, 64, 8
    toks = rng.integers(0, tcfg.vocab, (b, s + gen)).astype(np.int32)
    patches = rng.normal(size=(b, tcfg.n_patches, tcfg.d_model)).astype(
        np.float32)
    _, jc = jlm.prefill(params, {"tokens": jnp.asarray(toks[:, :s]),
                                 "patch_embeds": jnp.asarray(patches)},
                        jcfg, jlm.NO_PARALLEL)
    assert jc["k"].shape[2] == tcfg.n_patches + s
    with pytest.raises(ValueError, match="Incompatible shapes") as err:
        _jax_driver_grow(jcfg, jc, s + gen)
    print(f"llava smoke, {tcfg.n_patches} patches, prompt {s}, gen {gen}: "
          f"the JAX driver's growth raises {str(err.value)[:120]}")

    def port_prefill(n):
        return tlm.prefill(tparams, {"tokens": _t(toks[:, :n]).long(),
                                     "patch_embeds": _t(patches)}, tcfg,
                           tlm.NO_PARALLEL)
    _, pf = port_prefill(s)
    assert pf["pos"].tolist() == [tcfg.n_patches + s] * b
    max_len = tserve.prefix_len(tcfg) + s + gen
    grown = tserve.grow_cache(tcfg, pf, max_len)
    assert grown["k"].shape[2] == max_len
    fp32 = tlm.init_decode_cache(tcfg, b, max_len, dtype=torch.float32,
                                 device="cpu")
    for k in ("k", "v"):
        fp32[k][:, :, :pf[k].shape[2]] = pf[k]
    fp32["pos"] = pf["pos"]
    wants = [_np(port_prefill(s + i + 1)[0]) for i in range(gen)]
    for name, tc, tol in (("bf16", grown, 2e-2), ("fp32", fp32, 1e-4)):
        worst = 0.0
        for i in range(gen):
            got, tc = tlm.decode_step(tparams, tc, _t(
                toks[:, s + i:s + i + 1]).long(), tcfg, tlm.NO_PARALLEL)
            worst = max(worst, _rel(_np(got), wants[i]))
        print(f"the port's {gen} decode steps on a {name} cache: off the "
              f"longer prefills by {worst:.4g} of max |logit|")
        assert worst < tol, name


# ---------------------------------------------------------- conversion

def test_lm_params_to_torch_carries_the_encdec_tree():
    """Every leaf of a bf16 seamless tree (``enc_blocks``, ``dec_blocks``
    with its ``x_`` and ``ln3`` leaves, ``enc_norm``) arrives with its
    path, shape and bits."""
    jcfg = jax_smoke_config(ENCDEC)
    params = jlm.init_params(jax.random.PRNGKey(4), jcfg)
    back = convert.lm_params_to_torch(jax.tree.map(np.asarray, params),
                                      "cpu")
    assert set(back) == {"embed", "final_norm", "head", "enc_blocks",
                         "dec_blocks", "enc_norm"}
    assert {"x_wq", "x_wk", "x_wv", "x_wo", "x_bq", "ln3"} <= set(
        back["dec_blocks"])
    n = 0
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        t = back
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16))
        n += 1
    assert n == sum(len(v) if isinstance(v, dict) else 1
                    for v in back.values())
