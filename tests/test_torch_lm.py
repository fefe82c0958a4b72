"""The port's LM serving path against the JAX package's, on the CPU.

The same numpy inputs (and the same JAX-initialised weights, carried by
``convert.lm_params_to_torch``) go through both packages:

* K4: the plain ``flash_attention`` against the Pallas kernel in
  interpret mode at the shapes of ``tests/test_kernels.py`` (fp32 2e-5,
  bf16 2e-2, that file's tolerances), and against JAX's
  ``dense_attention`` at ragged S (2e-5);
* K5: the plain ``ssd_intra`` against the Pallas kernel in interpret
  mode (fp32 2e-4, bf16 5e-2) and against the model's einsum branch;
* ``attention()``, ``ssd_chunked`` and ``mamba2_block`` against JAX;
* ``prefill`` and 8 ``decode_step``s for the smoke config of every
  architecture (dense, moe, ssm, hybrid, vlm with seeded patch
  embeddings, encdec with seeded frame embeddings): in fp32 within 1e-4 of
  the logits' scale (max |logit|; the algorithm, with the decode cache
  in bf16 as in JAX), in bf16 within 5e-2 of it (the two frameworks
  round bf16 at other points).  Both sides grow the prefill's cache as
  the port's driver does (the vlm cache by its patches, the encoder's
  cross K/V kept at its own length).  Each decode step is held against
  JAX's free-running decode and against JAX's step on the port's own
  cache;
  command-r-plus-104b in fp32 only against the latter
  (``TEACHER_FORCED_ONLY``: its fp32 prefill K/V and JAX's each lie
  within fp32 rounding of a float64 prefill, and a few elements land
  one bf16 step apart in the cache, which a test shows).  The caches are held against JAX's
  free-running ones.
  The moe family in bf16 is compared layer by layer instead
  (``tests/test_torch_moe.py``): a route there can flip at a gate
  margin below the bf16 noise of the router's input.  starcoder2-7b
  also runs with nonzero biases (JAX initialises every bias to zero);
* ``launch.serve.main`` on the CPU gives the same greedy tokens in fp32
  as the same loop run in JAX (dense, ssm, moe, hybrid, vlm, encdec; the
  vlm and encdec prompts take the JAX driver's zero stand-ins).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ops import \
    attention as jax_flash  # noqa: E402
from repro.kernels.ssd_intra.ops import intra_chunk  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_intra import ssd_intra  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


ARCHS = ("qwen3-1.7b", "mamba2-2.7b", "deepseek-moe-16b", "dbrx-132b",
         "command-r-plus-104b", "starcoder2-7b", "llama3-405b",
         "recurrentgemma-2b", "llava-next-mistral-7b", "seamless-m4t-medium")
MOE_ARCHS = ("deepseek-moe-16b", "dbrx-132b")
# Held only to JAX's step on the port's own cache: command-r-plus-104b's
# smoke heads (8 dims) move its fp32 logits by 1.35e-4 of their scale
# when one bf16 cache element rounds the other way, the one bf16 step
# that the cache check allows; free-running, that step compounds.  The
# step comes from fp32 rounding on both sides, which matching the
# projections' summation order does not remove
# (test_command_r_fp32_cache_within_fp32_rounding).
TEACHER_FORCED_ONLY = {("command-r-plus-104b", "float32")}


def _t(a):
    """numpy / JAX array -> CPU tensor with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy()


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,dtype", [
    (2, 256, 4, 2, 64, True, jnp.float32),
    (1, 512, 8, 8, 128, True, jnp.float32),
    (2, 256, 4, 1, 128, False, jnp.float32),
    (1, 256, 8, 4, 64, True, jnp.bfloat16),
    (1, 128, 2, 2, 256, True, jnp.float32),
])
def test_flash_plain_matches_pallas(b, s, hq, hkv, hd, causal, dtype):
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(b, s, hq, hd)), dtype)
    k = jnp.asarray(rng.normal(size=(b, s, hkv, hd)), dtype)
    v = jnp.asarray(rng.normal(size=(b, s, hkv, hd)), dtype)
    want = jax_flash(q, k, v, causal=causal, backend="pallas",
                     interpret=True, block_q=128, block_k=128)
    got = flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                          _t(v).transpose(1, 2), causal=causal)
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    assert _maxdiff(_np(got.transpose(1, 2)), want) < tol


@pytest.mark.parametrize("s", [40, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_matches_dense(s, causal):
    """Any S, as the JAX ``attention()`` accepts through its dense path
    (the Pallas kernel itself needs S to be a multiple of its block)."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 64)).astype(np.float32)
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    got = flash_attention(*[_t(a).transpose(1, 2) for a in (q, k, v)],
                          causal=causal).transpose(1, 2)
    assert _maxdiff(_np(got), want) < 2e-5


# ------------------------------------------------------------------ K5

@pytest.mark.parametrize("b,q,h,p,dtype", [
    (2, 32, 4, 16, jnp.float32),
    (1, 64, 8, 64, jnp.float32),
    (3, 16, 2, 32, jnp.bfloat16),
])
def test_ssd_intra_plain_matches_pallas(b, q, h, p, dtype):
    rng = np.random.default_rng(4)
    cb = jnp.asarray(rng.normal(size=(b, q, q)) * 0.3, dtype)
    cs = jnp.asarray(-np.abs(rng.normal(size=(b, q, h))).cumsum(axis=1)
                     * 0.1, dtype)
    win = jnp.asarray(rng.normal(size=(b, q, h, p)), dtype)
    want = intra_chunk(cb, cs, win, backend="pallas", interpret=True)
    got = ssd_intra(_t(cb), _t(cs), _t(win))
    assert got.dtype == _t(win).dtype
    tol = 5e-2 if dtype == jnp.bfloat16 else 2e-4
    assert _maxdiff(_np(got), want) < tol


def test_ssd_intra_plain_matches_model_branch():
    """The plain K5 against the einsum branch of JAX's ``ssd_chunked``,
    fed the same (cb, cs, dt * x), with exp overflowing to inf above the
    diagonal (a steep cumsum): the mask must select, not multiply."""
    rng = np.random.default_rng(5)
    b, q, h, p, n = 2, 32, 4, 16, 8
    dt = np.abs(rng.normal(size=(b, q, h))).astype(np.float32) * 4.0
    a = -np.exp(rng.normal(size=(h,)).astype(np.float32))
    cs = np.cumsum(dt * a, axis=1) * 30.0                   # to -1e3 and past
    bmat = rng.normal(size=(b, q, n)).astype(np.float32)
    cmat = rng.normal(size=(b, q, n)).astype(np.float32)
    x = rng.normal(size=(b, q, h, p)).astype(np.float32)
    cb = np.einsum("bqn,bkn->bqk", cmat, bmat)
    win = dt[..., None] * x
    seg = jnp.asarray(cs)[:, :, None, :] - jnp.asarray(cs)[:, None, :, :]
    l_mat = jnp.where(jnp.tril(jnp.ones((q, q), bool))[None, :, :, None],
                      jnp.exp(seg), 0.0)
    want = jnp.einsum("bqk,bqkh,bkhp->bqhp", cb, l_mat, win)
    got = ssd_intra(_t(cb), _t(cs), _t(win))
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("s,chunk", [(64, 32), (48, 16), (32, 32)])
def test_ssd_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 2, 4, 8, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, s, h))).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32) * 0.3
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    ins = (x, dt, a_log, bm, cm, d)
    yj, hj = jssm.ssd_chunked(*[jnp.asarray(a) for a in ins], chunk)
    yt, ht = tssm.ssd_chunked(*[_t(a) for a in ins], chunk)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), rtol=1e-4,
                               atol=1e-4)


# -------------------------------------------------- attention, mamba2

@pytest.mark.parametrize("kw", [
    {},                                         # dense, causal
    {"causal": False},
    {"window": 8},
    {"q_offset": 16},
    {"dense_threshold": 16, "block_q": 16, "block_k": 32},   # blockwise
    {"dense_threshold": 16, "block_q": 16, "block_k": 16, "window": 20},
])
def test_attention_matches_jax(kw):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 64, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 32)).astype(np.float32)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
    got = tattn.attention(_t(q), _t(k), _t(v), **kw)
    assert _maxdiff(_np(got), want) < 2e-5


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(3, 1, 8, 64)).astype(np.float32)
    kc = rng.normal(size=(3, 40, 2, 64)).astype(np.float32)
    vc = rng.normal(size=(3, 40, 2, 64)).astype(np.float32)
    lens = np.array([1, 17, 40], np.int32)
    want = jattn.decode_attention(*[jnp.asarray(a) for a in (q, kc, vc,
                                                             lens)])
    got = tattn.decode_attention(*[_t(a) for a in (q, kc, vc, lens)])
    assert _maxdiff(_np(got), want) < 2e-5


def _jax_params(arch, dtype="float32", seed=0, perturb=None):
    """JAX's smoke params and the port's copy; ``perturb(params_np)``
    may edit the numpy tree before both sides get it."""
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    params_np = jax.tree.map(np.asarray,
                             jlm.init_params(jax.random.PRNGKey(seed), jcfg))
    if perturb is not None:
        params_np = perturb(params_np)
    params = jax.tree.map(jnp.asarray, params_np)
    tcfg = configs.get_smoke_config(arch).replace(dtype=dtype)
    tparams = convert.lm_params_to_torch(params_np, "cpu")
    return jcfg, params, tcfg, tparams


def test_mamba2_block_matches_jax():
    jcfg, params, tcfg, tparams = _jax_params("mamba2-2.7b")
    jp = jax.tree.map(lambda a: a[0], params["blocks"])
    tp = {k: v[0] for k, v in tparams["blocks"].items()}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 64, tcfg.d_model)).astype(np.float32)
    yj, (sj, cj) = jssm.mamba2_block(jnp.asarray(x), jp, jcfg)
    yt, (st, ct) = tssm.mamba2_block(_t(x), tp, tcfg)
    for a, b in ((yt, yj), (st, sj), (ct, cj)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    x1 = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    yj, (sj, cj) = jssm.mamba2_block(jnp.asarray(x1), jp, jcfg,
                                     cache=(sj, cj))
    yt, (st, ct) = tssm.mamba2_block(_t(x1), tp, tcfg, cache=(st, ct))
    for a, b in ((yt, yj), (st, sj), (ct, cj)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------- whole model

def _jax_grow(jcfg, cache, max_len):
    """``repro/launch/serve.py``'s cache-growth step as the port's
    ``grow_cache`` takes it: the encoder's cross K/V are kept at their
    own length (the JAX driver pads them with zero keys; the caller
    passes the vlm's patches in ``max_len``)."""
    b = cache["pos"].shape[0]
    full = jlm.init_decode_cache(jcfg, b, max_len)
    for k in cache:
        if k in tserve.GROW and cache[k].shape != full[k].shape:
            sl = tuple(slice(0, s) for s in cache[k].shape)
            full[k] = full[k].at[sl].set(cache[k])
        else:
            full[k] = cache[k]
    return full


def _leaf_close(got, want, tol):
    """A cache leaf within ``tol`` of its largest magnitude; a bf16 leaf
    may also differ by one bf16 step (2**-7 relative) where the two fp32
    values before rounding fall on either side of a rounding boundary."""
    ref = np.asarray(want, np.float32)
    err = np.abs(_np(got) - ref)
    allow = tol * max(1.0, float(np.abs(ref).max()))
    if got.dtype == torch.bfloat16:
        allow = allow + np.abs(ref) * 2.0 ** -7
    assert (err <= allow).all(), float(err.max())


def _cache_to_jax(cache):
    """A copy of the port's cache as JAX arrays, dtypes kept (the port
    updates its leaves in place; JAX may alias a numpy buffer)."""
    return {k: jnp.asarray(np.array(_np(v)),
                           jnp.bfloat16 if v.dtype == torch.bfloat16
                           else np.dtype(str(v.dtype).split(".")[-1]))
            for k, v in cache.items()}


@pytest.mark.parametrize("arch,dtype,tol", [
    (arch, dtype, tol) for arch in ARCHS
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2))
    if not (arch in MOE_ARCHS and dtype == "bfloat16")])
def test_prefill_and_decode_match_jax(arch, dtype, tol):
    _prefill_and_decode_match_jax(
        *_jax_params(arch, dtype), tol,
        free_running=(arch, dtype) not in TEACHER_FORCED_ONLY)


def _f64_dense_prefill_kv(params, cfg, toks):
    """The K/V cache [L, B, S, Hkv, hd] of a dense config's prefill
    (no biases, no qk norm, swiglu), in float64 numpy from the same
    weights: the exact value both packages' fp32 round."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    b, s = toks.shape
    hd, g = cfg.hd, cfg.n_heads // cfg.n_kv_heads
    ang = np.arange(s)[:, None] / cfg.rope_theta ** (np.arange(0, hd, 2) / hd)
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]

    def rope(t):
        t1, t2 = np.split(t, 2, -1)
        return np.concatenate([t1 * cos - t2 * sin, t2 * cos + t1 * sin], -1)

    def norm(t, sc):
        return t / np.sqrt((t * t).mean(-1, keepdims=True) + cfg.rms_eps) \
            * (1 + f(sc))
    x = f(params["embed"])[toks]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = {k: f(v[i]) for k, v in params["blocks"].items()}
        h = norm(x, p["ln1"])
        q = rope((h @ p["wq"]).reshape(b, s, cfg.n_heads, hd))
        k = rope((h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd))
        v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        ks.append(k)
        vs.append(v)
        lg = np.einsum("bqhd,bshd->bhqs", q, np.repeat(k, g, 2)) / np.sqrt(hd)
        lg = np.where(np.tril(np.ones((s, s), bool)), lg, -np.inf)
        w = np.exp(lg - lg.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        x = x + np.einsum("bhqs,bshd->bqhd", w, np.repeat(v, g, 2)) \
            .reshape(b, s, -1) @ p["wo"]
        h = norm(x, p["ln2"])
        a = h @ p["wg"]
        x = x + (a / (1 + np.exp(-a)) * (h @ p["wu"])) @ p["wd"]
    return {"k": np.stack(ks), "v": np.stack(vs)}


def _xla_order_dense(x, w, b=None):
    """``x @ w`` summed in XLA's CPU order at the smoke widths: four
    partial products over k mod 4, each a sequential fused multiply-add
    over its k (torch's CPU product's order), added pairwise."""
    y = [x[..., i::4] @ w[i::4] for i in range(4)]
    y = (y[0] + y[1]) + (y[2] + y[3])
    return y if b is None else y + b


@pytest.mark.parametrize("order", ["torch", "xla"])
def test_command_r_fp32_cache_within_fp32_rounding(monkeypatch, order):
    """Why command-r-plus-104b in fp32 is held teacher-forced
    (``TEACHER_FORCED_ONLY``).  Against a float64 prefill from the same
    weights, JAX's and the port's fp32 prefill K/V each lie within fp32
    rounding of the exact value (16 eps of its scale), with the port's
    projections in torch's order ("torch") or in XLA's ("xla",
    :func:`_xla_order_dense`).  The decode cache's cast to bf16 then puts
    at most a few elements exactly one bf16 step apart, where the two
    fp32 values fall on either side of a rounding midpoint; free-running,
    such a step compounds.  Printed (``-s``): each side's error in eps of
    the scale, the elements of equal fp32 bits, the straddles, and at how
    many of them each side rounds as the exact value does.  A port that
    came nearer to the exact value shows as smaller numbers here."""
    if order == "xla":
        monkeypatch.setattr(tlm.layers, "dense", _xla_order_dense)
    jcfg, params, tcfg, tparams = _jax_params("command-r-plus-104b")
    toks = np.random.default_rng(11).integers(0, tcfg.vocab, (2, 64)) \
        .astype(np.int32)
    _, jc = jax.jit(lambda p, bt: jlm.prefill(p, bt, jcfg, jlm.NO_PARALLEL))(
        params, {"tokens": jnp.asarray(toks)})
    _, tc = tlm.prefill(tparams, {"tokens": _t(toks).long()}, tcfg,
                        tlm.NO_PARALLEL)
    exact = _f64_dense_prefill_kv(jax.tree.map(np.asarray, params), tcfg,
                                  toks)
    eps = float(np.finfo(np.float32).eps)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    straddles = 0
    for key in ("k", "v"):
        want, got, ref = np.asarray(jc[key], np.float32), _np(tc[key]), \
            exact[key]
        unit = eps * np.abs(ref).max()
        err_jax = np.abs(want - ref).max() / unit
        err_port = np.abs(got - ref).max() / unit
        assert err_jax <= 16 and err_port <= 16, (key, err_jax, err_port)
        wb, gb, rb = bf16(want), bf16(got), bf16(ref.astype(np.float32))
        at = [tuple(i) for i in np.argwhere(wb != gb)]
        for i in at:
            step = 2.0 ** (np.floor(np.log2(min(abs(wb[i]), abs(gb[i])))) - 7)
            assert abs(wb[i] - gb[i]) == step, (key, i)
            mid = (wb[i] + gb[i]) / 2
            assert min(want[i], got[i]) <= mid <= max(want[i], got[i])
        straddles += len(at)
        print(f"{order} {key}: eps of scale jax {err_jax:.3f} port "
              f"{err_port:.3f}; equal fp32 {np.mean(want == got):.4f}; "
              f"straddles {len(at)}, exact's side jax "
              f"{sum(wb[i] == rb[i] for i in at)} port "
              f"{sum(gb[i] == rb[i] for i in at)}")
    assert straddles <= 16, straddles


def test_starcoder2_with_nonzero_biases_matches_jax():
    """starcoder2-7b's biased projections and GELU MLP with every bias
    drawn nonzero in numpy (JAX initialises them to zero), fp32."""
    rng = np.random.default_rng(21)

    def perturb(p):
        blocks = dict(p["blocks"])
        for k in ("bq", "bk", "bv", "bo", "bu", "bd"):
            blocks[k] = (rng.normal(size=blocks[k].shape) * 0.3).astype(
                blocks[k].dtype)
        return dict(p, blocks=blocks)

    jcfg, params, tcfg, tparams = _jax_params("starcoder2-7b",
                                              perturb=perturb)
    assert float(np.abs(np.asarray(params["blocks"]["bu"])).min()) > 0
    _prefill_and_decode_match_jax(jcfg, params, tcfg, tparams, 1e-4)


def _embeds(rng, cfg, b, s):
    """Seeded stand-ins of the modality frontends, as numpy arrays: the
    vlm's patch embeddings (fp32; each side casts them to its token
    embeddings' dtype) and the encdec's frame embeddings (in the
    model's dtype, as the encoder takes them)."""
    if cfg.family == "vlm":
        return {"patch_embeds": rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        e = rng.normal(size=(b, max(1, s // cfg.enc_ratio), cfg.d_model))
        return {"enc_embeds": np.asarray(jnp.asarray(
            e, jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32))}
    return {}


def _prefill_and_decode_match_jax(jcfg, params, tcfg, tparams, tol,
                                  free_running=True):
    rng = np.random.default_rng(11)
    b, s, n_dec = 2, 64, 8
    toks = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    extra = _embeds(rng, tcfg, b, s)
    ctx = jlm.NO_PARALLEL
    jl, jc = jax.jit(lambda p, bt: jlm.prefill(p, bt, jcfg, ctx))(
        params, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(a) for k, a in extra.items()}})
    tl, tc = tlm.prefill(tparams, {"tokens": _t(toks).long(),
                                   **{k: _t(a) for k, a in extra.items()}},
                         tcfg, tlm.NO_PARALLEL)
    scale = float(np.abs(np.asarray(jl, np.float32)).max())
    assert _maxdiff(_np(tl), jl) < tol * scale
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        _leaf_close(tc[key], jc[key], tol)

    max_len = tserve.prefix_len(tcfg) + s + n_dec
    jc = _jax_grow(jcfg, jc, max_len)
    tc = tserve.grow_cache(tcfg, tc, max_len)
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg, ctx))
    dec = rng.integers(0, tcfg.vocab, (n_dec, b, 1)).astype(np.int32)
    for i in range(n_dec):
        # each step is held against JAX's step on the port's own cache
        # and, unless exempted, against JAX's free-running decode
        wl, _ = jstep(params, _cache_to_jax(tc), jnp.asarray(dec[i]))
        jl, jc = jstep(params, jc, jnp.asarray(dec[i]))
        tl, tc = tlm.decode_step(tparams, tc, _t(dec[i]).long(), tcfg,
                                 tlm.NO_PARALLEL)
        scale = float(np.abs(np.asarray(wl, np.float32)).max())
        assert _maxdiff(_np(tl), wl) < tol * scale, i
        if free_running:
            scale = float(np.abs(np.asarray(jl, np.float32)).max())
            assert _maxdiff(_np(tl), jl) < tol * scale, i
    for key in jc:
        assert tc[key].dtype == _t(np.asarray(jc[key][:1])).dtype, key
        _leaf_close(tc[key], jc[key], tol)


@pytest.mark.parametrize("arch,prompt", [("qwen3-1.7b", 16),
                                         ("mamba2-2.7b", 32),
                                         ("deepseek-moe-16b", 16),
                                         ("recurrentgemma-2b", 16),
                                         ("llava-next-mistral-7b", 16),
                                         ("seamless-m4t-medium", 16)])
def test_serve_main_matches_jax_loop(arch, prompt, monkeypatch):
    """``launch.serve.main`` on the CPU, in fp32 with JAX's weights,
    emits JAX's greedy tokens: prefill -> grow cache -> decode.  The JAX
    loop feeds the JAX driver's zero stand-ins (in the model's dtype:
    JAX's encoder scan keeps its input's dtype) and grows as the port
    does; with 5 tokens to generate under 16 patches, the JAX driver's
    own growth would fail for the vlm."""
    jcfg, params, tcfg, tparams = _jax_params(arch)
    monkeypatch.setattr(tserve, "get_smoke_config", lambda name: tcfg)
    monkeypatch.setattr(tserve.lm, "init_params",
                        lambda cfg, gen, dev: tparams)
    n_req, batch, gen = 3, 2, 5
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", str(n_req), "--batch", str(batch),
                       "--prompt-len", str(prompt), "--gen", str(gen)])
    assert res["requests"] == n_req and res["tokens"] == n_req * gen
    assert res["finite"] and res["generated"].shape == (n_req, gen)

    ctx = jlm.NO_PARALLEL
    jprefill = jax.jit(lambda p, bt: jlm.prefill(p, bt, jcfg, ctx))
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg, ctx))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, prompt).tolist()
               for _ in range(n_req)]
    want = []
    for i in range(0, n_req, batch):
        toks = jnp.asarray(prompts[i:i + batch], jnp.int32)
        bt = {"tokens": toks}
        b = toks.shape[0]
        if jcfg.family == "vlm":
            bt["patch_embeds"] = jnp.zeros(
                (b, jcfg.n_patches, jcfg.d_model), jnp.bfloat16)
        if jcfg.family == "encdec":
            bt["enc_embeds"] = jnp.zeros(
                (b, max(1, prompt // jcfg.enc_ratio), jcfg.d_model),
                jnp.float32)
        logits, cache = jprefill(params, bt)
        cache = _jax_grow(jcfg, cache, tserve.prefix_len(tcfg) + prompt
                          + gen)
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out = []
        for _ in range(gen):
            logits, cache = jstep(params, cache, nxt)
            nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out.append(np.asarray(nxt))
        want.append(np.concatenate(out, axis=1))
    np.testing.assert_array_equal(res["generated"], np.concatenate(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_consistency(arch):
    """Port of ``test_archs_smoke.test_prefill_then_decode_consistency``
    for every family: the last logits of a prefill equal those of a
    token-by-token ``decode_step`` replay (rtol/atol 2e-2, bf16).  The
    moe family runs at the no-drop capacity factor n_experts / top_k: at
    the published 1.25 a 32-token prefill may drop assignments that a
    one-token decode step (capacity 4) never drops, so the two would
    differ by design (``tests/test_torch_moe.py`` holds the drop mask
    at the published factor against JAX).  The encdec model encodes 8
    seeded frames once: the replay starts from a cache whose cross K/V
    are the prefill's.  The vlm model runs on tokens alone (no
    ``decode_step`` takes patches)."""
    cfg = configs.get_smoke_config(arch)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    gen = torch.Generator().manual_seed(0)
    params = tlm.init_params(cfg, gen, "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 32), generator=gen)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((1, 8, cfg.d_model), generator=gen)
    logits_pf, cache_pf = tlm.prefill(params, batch, cfg, tlm.NO_PARALLEL)
    cache = tlm.init_decode_cache(cfg, 1, 48, device="cpu")
    if cfg.family == "encdec":
        cache["cross_k"], cache["cross_v"] = (cache_pf["cross_k"],
                                              cache_pf["cross_v"])
    for i in range(toks.shape[1]):
        logits_dec, cache = tlm.decode_step(params, cache, toks[:, i:i + 1],
                                            cfg, tlm.NO_PARALLEL)
    np.testing.assert_allclose(_np(logits_pf), _np(logits_dec), rtol=2e-2,
                               atol=2e-2)


# ------------------------------------------------------ configs, init

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_init_match_jax(arch):
    from repro.configs import get_config as jax_config
    for get_t, get_j in ((configs.get_config, jax_config),
                         (configs.get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
    jcfg = jax_smoke_config(arch)
    jshapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tcfg = configs.get_smoke_config(arch)
    tparams = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat_j = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    flat_t = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert flat_j.keys() == flat_t.keys()
    for key, a in flat_j.items():
        t = flat_t[key]
        assert tuple(t.shape) == a.shape, key
        assert str(t.dtype).split(".")[-1] == str(a.dtype), key


def test_unported_archs_name_their_roadmap_item():
    """No architecture is left unported: every one of the JAX package's
    has a config here (held against JAX's by
    ``test_configs_and_init_match_jax``, for which ``ARCHS`` is the whole
    list) and none raises ``NotImplementedError``; an unknown name is a
    ``KeyError``."""
    from repro.configs import all_arch_ids as jax_arch_ids
    assert configs.all_arch_ids() == jax_arch_ids()
    assert sorted(configs.all_arch_ids()) == sorted(ARCHS)
    for arch in configs.all_arch_ids():
        assert configs.get_config(arch).name == arch
        assert configs.get_smoke_config(arch).name == arch
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_lm_params_to_torch_keeps_bits():
    jcfg = jax_smoke_config("qwen3-1.7b")
    params = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    back = convert.lm_params_to_torch(jax.tree.map(np.asarray, params),
                                      "cpu")
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        t = back
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16))
