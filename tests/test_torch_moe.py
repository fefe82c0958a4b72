"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

The same numpy inputs (and the same JAX-initialised weights, carried by
``convert.lm_params_to_torch``) go through both packages:

* ``_capacity`` and the top-k tie order (``jax.lax.top_k`` puts the
  lower index first);
* the routes of ``_dispatch`` (top expert, slot, keep) and its buffer
  exactly, in fp32 and in bf16 fed the same input, at a capacity small
  enough to drop; the weights and the aux loss within 1e-6 relative;
* ``moe_ffn`` for the smoke configs of deepseek-moe-16b (shared
  experts) and dbrx-132b, and with GEGLU and GELU experts: within 1e-5
  in fp32 and 2e-2 x max(1, |want|) in bf16 (the frameworks round bf16
  at other points);
* the drop mask of a prefill at the published capacity factor equals
  JAX's;
* the moe smoke models in bf16, layer by layer: each port layer gets
  JAX's layer input (and JAX's cache), for a prefill and 8 decode
  steps.  A route may flip between the two where the router's bf16
  input differs by a rounding step and two gates lie closer than that
  difference can move them; such a token's logit margin is printed and
  must be below twice the largest router-logit difference of its layer,
  and it (with any assignment whose slot the flip moved past the
  capacity) is left out of that layer's output comparison.  Every other
  row agrees within 5e-2 of the layer's scale, and the logits from
  JAX's last hidden state within 5e-2 of theirs.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

MOE_ARCHS = ("deepseek-moe-16b", "dbrx-132b")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy()


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


@pytest.mark.parametrize("tokens,k,e,cf", [
    (2, 6, 64, 1.25), (2048, 6, 64, 1.25), (128, 2, 8, 1.25), (7, 4, 16, 1.0),
    (512, 6, 64, 64 / 6), (1, 1, 4, 0.5)])
def test_capacity_matches_jax(tokens, k, e, cf):
    assert tmoe._capacity(tokens, k, e, cf) == jmoe._capacity(tokens, k, e,
                                                               cf)


def test_top_k_ties_keep_the_lower_index():
    """Exact ties among the gates: ``jax.lax.top_k`` lists the lower
    expert index first, and so must the port (``torch.topk`` promises no
    order on ties)."""
    rng = np.random.default_rng(0)
    g = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4.0
    wv, we = jax.lax.top_k(jnp.asarray(g), 6)
    tv, te = tmoe._top_k(_t(g), 6)
    np.testing.assert_array_equal(te.numpy(), np.asarray(we))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,e,k,cap", [(96, 8, 2, 16), (64, 16, 4, 12),
                                       (40, 4, 1, 4)])
def test_dispatch_routes_are_exact(t, e, k, cap, dtype):
    """Fed the same tokens and fp32 logits, the port's routes (token,
    top expert, slot, keep) and dispatch buffer equal JAX's exactly; the
    weights and the aux loss agree within 1e-6 relative (the two
    softmaxes' exp differ in the last bit).  The capacity is small
    enough that assignments drop; some gates are tied exactly."""
    rng = np.random.default_rng(t + e)
    x = rng.normal(size=(t, 24)).astype(np.float32)
    logits = rng.normal(size=(t, e)).astype(np.float32)
    logits[::5, 1] = logits[::5, 0]                   # exact ties
    xj = jnp.asarray(x, _jdt(dtype))
    bj, rj, aj = jmoe._dispatch(xj, jnp.asarray(logits), k, e, cap)
    bt, rt, at = tmoe._dispatch(_t(xj), _t(logits), k, e, cap)
    names = ("flat_tok", "e_idx", "s_idx", "flat_w", "keep")
    for name, a, b in zip(names, rj, rt):
        if name == "flat_w":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
    keep = np.asarray(rj[4])
    assert 0 < keep.sum() < keep.size               # some drop, some stay
    np.testing.assert_array_equal(_np(bt), np.asarray(bj, np.float32))
    assert bt.dtype == _t(xj).dtype
    assert float(at) == pytest.approx(float(aj), rel=1e-6)


def _moe_case(arch, dtype, ffn_type=None):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    tcfg = configs.get_smoke_config(arch).replace(dtype=dtype)
    if ffn_type is not None:
        jcfg, tcfg = (c.replace(ffn_type=ffn_type) for c in (jcfg, tcfg))
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(1), jcfg,
                                               _jdt(dtype)))
    return jcfg, tcfg, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,ffn_type", [
    ("deepseek-moe-16b", None), ("dbrx-132b", None),
    ("deepseek-moe-16b", "geglu"), ("dbrx-132b", "gelu")])
def test_moe_ffn_matches_jax(arch, ffn_type, dtype):
    jcfg, tcfg, p = _moe_case(arch, dtype, ffn_type)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 48, jcfg.d_model)), _jdt(dtype))
    yj, aj = jmoe.moe_ffn(x, jax.tree.map(jnp.asarray, p), jcfg)
    yt, at = tmoe.moe_ffn(_t(x), convert.lm_params_to_torch(p, "cpu"), tcfg)
    assert yt.dtype == _t(x).dtype and tuple(yt.shape) == yj.shape
    want = np.asarray(yj, np.float32)
    err = np.abs(_np(yt) - want)
    if dtype == "bfloat16":
        assert (err / np.maximum(1.0, np.abs(want))).max() < 2e-2
    else:
        assert err.max() < 1e-5
    assert float(at) == pytest.approx(float(aj), rel=1e-5)


def _record_routes(monkeypatch):
    """Record (logits, e_idx, keep) of every ``_dispatch`` call in both
    packages (JAX's through a debug callback, so jitted calls report)."""
    rec = {"jax": [], "torch": []}
    jd, td = jmoe._dispatch, tmoe._dispatch

    def jrec(x, logits, k, e, cap):
        out = jd(x, logits, k, e, cap)
        jax.debug.callback(
            lambda lg, ei, kp: rec["jax"].append(
                (np.asarray(lg), np.asarray(ei), np.asarray(kp))),
            logits, out[1][1], out[1][4])
        return out

    def trec(x, logits, k, e, cap):
        out = td(x, logits, k, e, cap)
        rec["torch"].append((logits.numpy(), out[1][1].numpy(),
                             out[1][4].numpy()))
        return out
    monkeypatch.setattr(jmoe, "_dispatch", jrec)
    monkeypatch.setattr(tmoe, "_dispatch", trec)
    return rec


def test_drop_mask_of_a_prefill_at_the_published_factor_matches_jax(
        monkeypatch):
    """A whole deepseek-moe-16b smoke prefill in fp32 (2 x 64 tokens:
    capacity 44 for 256 assignments over 8 experts) at the published
    capacity factor 1.25, fed JAX's weights: every layer's keep mask,
    experts and slots equal JAX's, and some assignments drop."""
    rec = _record_routes(monkeypatch)
    jcfg = jax_smoke_config("deepseek-moe-16b").replace(dtype="float32")
    tcfg = configs.get_smoke_config("deepseek-moe-16b").replace(
        dtype="float32")
    assert tcfg.capacity_factor == 1.25
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.lm_params_to_torch(jax.tree.map(np.asarray, params),
                                         "cpu")
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 64))
    jax.block_until_ready(jlm.prefill(params, {"tokens": jnp.asarray(toks)},
                                      jcfg, jlm.NO_PARALLEL))
    tlm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                tlm.NO_PARALLEL)
    assert len(rec["jax"]) == len(rec["torch"]) == jcfg.n_layers
    dropped = 0
    for (_, je, jk), (_, te, tk) in zip(rec["jax"], rec["torch"]):
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(te, je)
        dropped += int((~jk).sum())
    assert dropped > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_drop_mask_at_the_published_factor_matches_jax_bf16(arch,
                                                            monkeypatch):
    """``moe_ffn`` in bf16 at the published capacity factor, fed the same
    128 tokens that share a common direction (so the router favours some
    experts): the keep mask, experts and slots equal JAX's, with
    drops."""
    rec = _record_routes(monkeypatch)
    jcfg, tcfg, p = _moe_case(arch, "bfloat16")
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, 64, jcfg.d_model))
                    + 3.0 * rng.normal(size=(jcfg.d_model,)), jnp.bfloat16)
    jax.block_until_ready(jmoe.moe_ffn(x, jax.tree.map(jnp.asarray, p),
                                       jcfg))
    tmoe.moe_ffn(_t(x), convert.lm_params_to_torch(p, "cpu"), tcfg)
    (_, je, jk), (_, te, tk) = rec["jax"][0], rec["torch"][0]
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(te, je)
    assert 0 < jk.sum() < jk.size


def test_moe_ffn_refuses_expert_parallelism():
    jcfg, tcfg, p = _moe_case("dbrx-132b", "float32")
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tmoe.moe_ffn(x, convert.lm_params_to_torch(p, "cpu"), tcfg,
                     parallel=object())


def test_init_moe_shapes_and_distributions():
    """The port's init: JAX's leaves and dtypes, the router in fp32 with
    std 0.02, experts He-scaled and drawn one layer at a time."""
    cfg = configs.get_smoke_config("deepseek-moe-16b").replace(d_model=256)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      stack=(3,))
    jp = jax.eval_shape(lambda: jmoe.init_moe(
        jax.random.PRNGKey(0), jax_smoke_config("deepseek-moe-16b").replace(
            d_model=256), jnp.bfloat16, stack=(3,)))
    assert p.keys() == jp.keys()
    for k, a in jp.items():
        assert tuple(p[k].shape) == a.shape and \
            str(p[k].dtype).split(".")[-1] == str(a.dtype), k
    assert p["router"].std().item() == pytest.approx(0.02, rel=0.05)
    assert p["we_g"].float().std().item() == pytest.approx(256 ** -0.5,
                                                           rel=0.05)
    assert not torch.equal(p["we_g"][0], p["we_g"][1])


# ------------------------------------------------- moe models, bf16

def _top(logits, softmax, k):
    """Each token's k experts as the framework ranks them: its own fp32
    softmax of the logits, then a stable descending order (ties to the
    lower index, as both packages take the top k)."""
    gates = np.asarray(softmax(logits))
    return np.argsort(-gates, axis=-1, kind="stable")[:, :k]


def _affected(jr, tr, k):
    """Rows whose route differs between the packages: (rows, the logit
    margin of each token whose top-k experts or their order differ, the
    largest router-logit difference).  A margin is the least gap between
    neighbours in the token's sorted logits down to the (k+1)-th: any
    change of the top k, or of its order, swaps such a pair.  A kept /
    dropped difference of an assignment whose token did not flip must
    follow an earlier flip that moved its expert's slots."""
    (jlog, _, jk), (tlog, _, tk) = jr, tr
    jtop = _top(jlog, lambda a: jax.nn.softmax(jnp.asarray(a), -1), k)
    ttop = _top(tlog, lambda a: torch.softmax(torch.from_numpy(a), -1), k)
    srt = -np.sort(-jlog, axis=-1)
    gaps = (srt[:, :k] - srt[:, 1:k + 1]).min(-1)
    flips = np.nonzero((jtop != ttop).any(-1))[0]
    first_flip = {}
    for t in flips:
        moved = (jtop[t] != ttop[t])
        for e in set(jtop[t][moved]) | set(ttop[t][moved]):
            first_flip.setdefault(int(e), int(t))
    rows = set(int(t) for t in flips)
    jk, tk = jk.reshape(-1, k), tk.reshape(-1, k)
    for t, j in zip(*np.nonzero(jk != tk)):
        if t in rows:
            continue
        e = int(jtop[t, j])
        assert first_flip.get(e, t) < t, \
            f"token {t}: keep differs with no earlier flip of expert {e}"
        rows.add(int(t))
    return sorted(rows), gaps[flips], float(np.abs(jlog - tlog).max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_bf16_layer_by_layer(arch, monkeypatch):
    rec = _record_routes(monkeypatch)
    jcfg = jax_smoke_config(arch).replace(dtype="bfloat16")
    tcfg = configs.get_smoke_config(arch).replace(dtype="bfloat16")
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.lm_params_to_torch(jax.tree.map(np.asarray, params),
                                         "cpu")
    ctx, tctx = jlm.NO_PARALLEL, tlm.NO_PARALLEL
    rng = np.random.default_rng(11)
    b, s, n_dec = 2, 64, 8
    toks = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    dec = rng.integers(0, jcfg.vocab, (n_dec, b, 1)).astype(np.int32)
    jblock = jax.jit(lambda x, p: jlm.moe_block(x, p, jcfg, ctx))
    jblock_dec = jax.jit(lambda x, p, kc, vc, pos: jlm.moe_block(
        x, p, jcfg, ctx, cache=(kc, vc), pos=pos))
    jlayer = [jax.tree.map(lambda a, i=i: a[i], params["blocks"])
              for i in range(jcfg.n_layers)]
    tlayer = tlm._layers(tparams["blocks"], jcfg.n_layers)
    flips_seen = []

    def check_layer(step, i, y_j, y_t):
        jax.block_until_ready(y_j)
        assert len(rec["jax"]) == len(rec["torch"]) == 1
        jr, tr = rec["jax"].pop(), rec["torch"].pop()
        rows, margins, dlog = _affected(jr, tr, jcfg.top_k)
        for m in margins:
            print(f"{arch} {step} layer {i}: route flip at logit margin "
                  f"{m:.3e} (largest router-logit difference {dlog:.3e})")
            assert m <= 2 * dlog
        flips_seen.extend(margins)
        want = np.asarray(y_j, np.float32).reshape(-1, jcfg.d_model)
        got = _np(y_t).reshape(-1, jcfg.d_model)
        keep = np.setdiff1d(np.arange(want.shape[0]), rows)
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got[keep] - want[keep]).max() < 5e-2 * scale, \
            (step, i)

    def logits_check(x_last):
        # JAX's head on JAX's last hidden state, the port's on the same
        h = jlayers.rms_norm(x_last, params["final_norm"], jcfg.rms_eps)
        want = np.asarray(h[:, -1].astype(jnp.float32)
                          @ jlm._head(params, jcfg).astype(jnp.float32))
        th = tlayers.rms_norm(_t(x_last), tparams["final_norm"],
                              tcfg.rms_eps)
        got = _np(tlm._logits(tparams, th[:, -1], tcfg))
        assert np.abs(got - want).max() < 5e-2 * np.abs(want).max()

    x = jlm.embed_tokens(params, jnp.asarray(toks), jcfg)
    ks, vs = [], []
    for i in range(jcfg.n_layers):
        y_j, (kj, vj), _ = jblock(x, jlayer[i])
        y_t, (kt, vt), _ = tlm.moe_block(_t(x), tlayer[i], tcfg, tctx)
        check_layer("prefill", i, y_j, y_t)
        for a, c in ((kt, kj), (vt, vj)):
            ref = np.asarray(c, np.float32)
            allow = 5e-2 * max(1.0, np.abs(ref).max()) + np.abs(ref) * 2 ** -7
            assert (np.abs(_np(a) - ref) <= allow).all()
        ks.append(kj)
        vs.append(vj)
        x = y_j
    logits_check(x)
    # the grown decode cache (bf16, prompt + n_dec slots), as serving
    # makes it; both packages read the same one at every layer and step
    grow = (jnp.zeros((jcfg.n_layers, b, s + n_dec, jcfg.n_kv_heads,
                       jcfg.hd), jnp.bfloat16).at[:, :, :s])
    kc, vc = grow.set(jnp.stack(ks)), grow.set(jnp.stack(vs))
    for n in range(n_dec):
        pos = jnp.full((b,), s + n, jnp.int32)
        x = jlm.embed_tokens(params, jnp.asarray(dec[n]), jcfg)
        nk, nv = [], []
        for i in range(jcfg.n_layers):
            y_j, (kj, vj), _ = jblock_dec(x, jlayer[i], kc[i], vc[i], pos)
            kt, vt = _t(kc[i]), _t(vc[i])
            y_t, _, _ = tlm.moe_block(_t(x), tlayer[i], tcfg, tctx,
                                      cache=(kt, vt), pos=_t(pos))
            check_layer(f"decode {n}", i, y_j, y_t)
            ref = np.asarray(kj, np.float32)[:, s + n]
            allow = 5e-2 * max(1.0, np.abs(ref).max()) + np.abs(ref) * 2 ** -7
            assert (np.abs(_np(kt)[:, s + n] - ref) <= allow).all()
            nk.append(kj)
            nv.append(vj)
            x = y_j
        kc, vc = jnp.stack(nk), jnp.stack(nv)
        logits_check(x)
    print(f"{arch}: {len(flips_seen)} route flips, logit margins "
          f"{[f'{m:.3e}' for m in flips_seen]}")
