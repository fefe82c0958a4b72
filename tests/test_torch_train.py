"""The port's training stack against the JAX package's, on the CPU.

The same numpy inputs (and the same weights, carried by ``convert``)
go through both packages:

* ``lm.train_loss`` and every gradient leaf against
  ``jax.value_and_grad(lm.train_loss)`` with ``NO_PARALLEL``, for the
  smoke config of each family (dense, moe at the no-drop capacity
  factor, ssm, hybrid past its window, vlm with patch embeddings, encdec
  with frame embeddings) in fp32, remat on and off, with masked labels
  and a loss chunk smaller than S: the loss within 1e-5 of its value,
  each leaf within 2e-4 of its largest |want| plus 1e-6 (fp32 sums in
  other orders; a leaf's entries are sums over every position);
* one or two ``adamw_update`` steps for each tier of m (fp32, bf16, int8)
  and v (fp32, int8), against JAX's: parameters within 1e-6 of their
  scale (fp32 elementwise arithmetic), states within 1e-6 of theirs, an
  int8 code at most one step away (a rounding tie can fall either way);
  the same with the update sliced along leading axes (``SLICE`` at 300
  elements, remainder slices, int8 blocks sliced by rows);
* ``compress_grads`` with error feedback over two steps: codes at most
  one step away, scales and residuals within 1e-6 of their scale;
* ``SyntheticLM.batch_at`` token for token;
* ``launch.train.main`` on the CPU: its 5-step loss curve against a JAX
  loop of ``value_and_grad`` + ``adamw_update`` over the same batches
  from the same (bf16) weights, within 2e-2 of the loss (the two
  frameworks round bf16 at other points);
* checkpoints: a train state saved by the port restores in
  ``repro.checkpoint`` and the reverse, bit for bit; a run resumed from
  its step-3 checkpoint repeats the uninterrupted run's losses exactly;
* a micro-batch-2 step equals a batch-2x step (1e-5), and the
  autograd Functions that carry K4 and K5 on the card, driven here
  through their plain versions, give autograd's gradients with the
  launches the card's path counts (2 forwards a layer under remat).
"""

import importlib
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import configs, convert, kernels  # noqa: E402
from repro_torch import tree as pt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore, \
    save  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.specs import train_inputs  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.train import (TrainConfig, build_train_step,  # noqa: E402
                               init_train_state)
from repro_torch.train.step import value_and_grad  # noqa: E402

# the kernel modules (the package's names are the wrappers)
fa = importlib.import_module("repro_torch.kernels.flash_attention")
sd = importlib.import_module("repro_torch.kernels.ssd_intra")

FAMILY_ARCH = {"dense": "qwen3-1.7b", "moe": "deepseek-moe-16b",
               "ssm": "mamba2-2.7b", "hybrid": "recurrentgemma-2b",
               "vlm": "llava-next-mistral-7b",
               "encdec": "seamless-m4t-medium"}
# S per family: ragged against the loss chunk of 16 nowhere, a multiple
# of the ssm chunk (32), past the hybrid window (64)
SEQ = {"dense": 48, "moe": 48, "ssm": 64, "hybrid": 80, "vlm": 48,
       "encdec": 48}


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:                  # the port's bf16 bits
        a = a.view(ml_dtypes.bfloat16)
    return a.astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, rel, floor=0.0, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    allow = rel * float(np.max(np.abs(want))) + floor if want.size else 0.0
    assert err <= allow, (what, err, allow)


def _models(family, remat_seed=0):
    """JAX's fp32 smoke config, params (numpy) and the port's copies."""
    arch = FAMILY_ARCH[family]
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    tcfg = configs.get_smoke_config(arch).replace(dtype="float32")
    if family == "moe":                       # nothing drops
        cf = jcfg.n_experts / jcfg.top_k
        jcfg = jcfg.replace(capacity_factor=cf)
        tcfg = tcfg.replace(capacity_factor=cf)
    params_np = jax.tree.map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(remat_seed), jcfg))
    return jcfg, tcfg, params_np


def _batch(family, cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    s = SEQ[family]
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1                # masked positions
    if family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if family == "encdec":
        batch["enc_embeds"] = rng.normal(
            size=(b, max(1, s // cfg.enc_ratio), cfg.d_model)).astype(
                np.float32)
    return batch


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_train_loss_and_grads_match_jax(family, remat):
    jcfg, tcfg, params_np = _models(family)
    batch = _batch(family, tcfg, 2)

    def jloss(p):
        return jlm.train_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jcfg, jlm.NO_PARALLEL,
                              remat=remat, loss_chunk=16)
    want_loss, want_g = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, params_np))
    tparams = convert.lm_params_to_torch(params_np, "cpu")
    loss, grads, missing = value_and_grad(
        lambda p, b: tlm.train_loss(p, b, tcfg, tlm.NO_PARALLEL,
                                    remat=remat, loss_chunk=16),
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert missing == 0
    _close(_np(loss), want_loss, 1e-5, what="loss")
    got, want = pt.leaves(grads), jax.tree.leaves(want_g)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_np(g), w, 2e-4, 1e-6, what=f"leaf {i}")


# ------------------------------------------------------------- optimizer

PARAM_SHAPES = {"a": (3, 200), "b": {"c": (130,), "d": (2, 5, 64)}}


# for the sliced update at SLICE = 300 elements: 2-D and 3-D leaves that
# split into several slices of their leading axis with a shorter last one
# (rows of 130 -> 2 rows a slice; rows of 3 x 40 -> 2; rows of 400, past
# SLICE -> 1), int8 blocks of a padded last axis, and a 1-D leaf whole
SLICED_SHAPES = {"a": (7, 130), "b": {"c": (400,), "d": (5, 3, 40)},
                 "e": (3, 400)}


def _tree_np(rng, dtype, scale=1.0, shapes=PARAM_SHAPES):
    return jax.tree.map(lambda s: (rng.normal(size=s) * scale).astype(dtype),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _to_t(tree):
    return pt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("m_dtype,v_mode,p_dtype", [
    ("float32", "float32", "float32"), ("bfloat16", "float32", "float32"),
    ("int8", "float32", "float32"), ("float32", "int8", "float32"),
    ("int8", "int8", "float32"), ("bfloat16", "int8", "bfloat16")])
def test_adamw_matches_jax(m_dtype, v_mode, p_dtype):
    _adamw_case(m_dtype, v_mode, p_dtype, PARAM_SHAPES)


def _adamw_case(m_dtype, v_mode, p_dtype, shapes):
    """Two ``adamw_update`` steps of the port against JAX's: grad norm,
    lr, parameters and every state leaf (int8 codes within one step)."""
    rng = np.random.default_rng(1)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=4, m_dtype=m_dtype,
               v_mode=v_mode, grad_clip=0.5)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    p_np = _tree_np(rng, np.float32, shapes=shapes)
    jp = jax.tree.map(lambda a: jnp.asarray(a, p_dtype), p_np)
    tp = _to_t(p_np)
    if p_dtype == "bfloat16":
        tp = pt.tree_map(lambda t: t.to(torch.bfloat16), tp)
    jstate, tstate = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    for _ in range(2):
        g_np = _tree_np(rng, np.float32, 0.3, shapes)
        jp, jstate, jm = jadamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, g_np), jstate, jcfg)
        tp, tstate, tm = tadamw.adamw_update(tp, _to_t(g_np), tstate, tcfg)
        _close(_np(tm["grad_norm"]), jm["grad_norm"], 1e-6, what="gnorm")
        _close(_np(tm["lr"]), jm["lr"], 1e-6, what="lr")
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    for g, w in zip(pt.leaves(tp), jax.tree.leaves(jp)):
        _close(_np(g), w, 1e-6 if p_dtype == "float32" else 2 ** -8,
               what="param")
    for g, w in zip(pt.leaves(tstate["mu"]), jax.tree.leaves(jstate["mu"])):
        g = g.numpy() if g.dtype != torch.bfloat16 else _np(g)
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32)
                          - np.asarray(w).astype(np.int32)).max() <= 1
        else:
            _close(g, w, 1e-6 if m_dtype != "bfloat16" else 2 ** -8,
                   what="state")


@pytest.mark.parametrize("m_dtype,v_mode,p_dtype", [
    ("float32", "float32", "float32"), ("bfloat16", "float32", "float32"),
    ("int8", "float32", "float32"), ("float32", "int8", "float32"),
    ("int8", "int8", "float32"), ("bfloat16", "int8", "bfloat16")])
def test_sliced_adamw_matches_jax(monkeypatch, m_dtype, v_mode, p_dtype):
    """The update a slice of the leading axis at a time (on the card,
    Qwen3-1.7B's embedding and Mamba2-2.7B's input projection pass
    ``SLICE``), here with ``SLICE`` at 300 elements, against JAX's
    whole-leaf update for every m and v tier; the int8 state's
    [*lead, nb, Q_BLOCK] blocks are sliced by rows with the parameter."""
    monkeypatch.setattr(tadamw, "SLICE", 300)
    n_slices = [len(tadamw._slices(torch.empty(s))) for s in
                jax.tree.leaves(SLICED_SHAPES,
                                is_leaf=lambda x: isinstance(x, tuple))]
    assert n_slices == [4, 1, 3, 3], n_slices
    _adamw_case(m_dtype, v_mode, p_dtype, SLICED_SHAPES)


def test_compress_grads_matches_jax():
    rng = np.random.default_rng(2)
    jerr = terr = None
    for _ in range(2):
        g_np = _tree_np(rng, np.float32)
        jq, jerr = jcompress.compress_grads(
            jax.tree.map(jnp.asarray, g_np), jerr)
        tq, terr = tcompress.compress_grads(_to_t(g_np), terr)
        for g, w in zip(pt.leaves(tq), jax.tree.leaves(jq)):
            if g.dtype == torch.int8:
                assert np.abs(g.numpy().astype(np.int32)
                              - np.asarray(w).astype(np.int32)).max() <= 1
            else:
                _close(g.numpy(), w, 1e-6, what="scale")
        for g, w in zip(pt.leaves(terr), jax.tree.leaves(jerr)):
            _close(g.numpy(), w, 1e-6, 1e-7, what="error")
    back = tcompress.decompress_grads(tq, _to_t(g_np))
    want = jcompress.decompress_grads(jq, jax.tree.map(jnp.asarray, g_np))
    for g, w in zip(pt.leaves(back), jax.tree.leaves(want)):
        _close(g.numpy(), w, 1e-2, what="decompressed")


# ------------------------------------------------------------------ data

def test_synthetic_batches_match_jax():
    for cfg in (dict(vocab=512, batch=3, seq_len=17, seed=0),
                dict(vocab=97, batch=2, seq_len=40, seed=5)):
        mine, ref = SyntheticLM(DataConfig(**cfg)), \
            JSyntheticLM(JDataConfig(**cfg))
        for step, shard in ((0, 0), (7, 0), (3, 1)):
            got = mine.batch_at(step, shard, 2)
            want = ref.batch_at(step, shard, 2)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_train_inputs_shapes():
    cfg = configs.get_config("llava-next-mistral-7b")
    spec = train_inputs(cfg, 2048, 4)
    assert spec["tokens"].shape == (4, 2048 - cfg.n_patches)
    assert spec["patch_embeds"].shape == (4, cfg.n_patches, cfg.d_model)
    enc = train_inputs(configs.get_config("seamless-m4t-medium"), 512, 2)
    assert enc["enc_embeds"].shape[1] == 128
    assert enc["labels"].dtype == torch.int32


# ------------------------------------------------------------- the step

def test_micro_batches_match_big_batch():
    """2 micro-batches of 2 equal 1 batch of 4 (fp32: the same sums in
    another order, 1e-5); remat does not change the step."""
    cfg = configs.get_smoke_config("qwen3-1.7b").replace(dtype="float32")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=4, seq_len=32,
                                  seed=1))
    b = data.batch_at(0)
    out = {}
    for n_micro, remat in ((1, False), (2, False), (1, True)):
        tcfg = TrainConfig(remat=remat, micro_batches=n_micro,
                           opt=tadamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=5))
        step, _, n = build_train_step(cfg, tcfg, global_batch=4,
                                      device="cpu")
        assert n == n_micro
        state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
        state, metrics = step(state, b)
        out[(n_micro, remat)] = (float(metrics["loss"]), pt.leaves(
            convert.train_state_to_numpy(state["params"])))
    want_loss, want_p = out[(1, False)]
    for key in ((2, False), (1, True)):
        loss, params = out[key]
        assert abs(loss - want_loss) < 1e-5, key
        for g, w in zip(params, want_p):
            _close(g, w, 1e-5, 1e-7, what=str(key))


def test_train_loop_matches_jax_loop():
    """``launch.train.main`` against ``value_and_grad`` + ``adamw_update``
    in JAX from the port's own initial weights over the same batches."""
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
            "--steps", "5", "--batch", "2", "--seq", "32", "--lr", "3e-3"]
    rec = train_main(argv)
    assert rec["grads_missing"] == 0 and rec["steps"] == list(range(5))
    tcfg = configs.get_smoke_config("qwen3-1.7b")
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    p_np = convert.train_state_to_numpy(params)
    jparams = jax.tree.map(lambda a: jnp.asarray(
        a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a), p_np)
    jcfg = jax_smoke_config("qwen3-1.7b")
    ocfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=5)
    state = jadamw.adamw_init(jparams, ocfg)
    data = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, batch=2, seq_len=32))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, b, jcfg, jlm.NO_PARALLEL,
                                    remat=False)))
    want = []
    for step in range(5):
        b = {k: jnp.asarray(v) for k, v in data.batch_at(step).items()}
        loss, g = grad_fn(jparams, b)
        jparams, state, _ = jadamw.adamw_update(jparams, g, state, ocfg)
        want.append(float(loss))
    np.testing.assert_allclose(rec["losses"], want, rtol=2e-2)
    assert rec["losses"][0] > 5.0 and all(np.isfinite(rec["grad_norms"]))


# ------------------------------------------------------------ checkpoints

def _port_state():
    cfg = configs.get_smoke_config("mamba2-2.7b")
    tcfg = TrainConfig(compress_grads=True, opt=tadamw.AdamWConfig(
        m_dtype="int8", v_mode="int8"))
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(3),
                             "cpu")
    step, _, _ = build_train_step(cfg, tcfg, global_batch=2, device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=2, seq_len=32))
    state, _ = step(state, data.batch_at(0))
    return state


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def test_checkpoint_round_trips_with_jax(tmp_path):
    """bf16 params, int8 m and v blocks with fp32 scales, int32 step and
    the fp32 error-feedback tree: the port's save restores in JAX and
    JAX's save restores in the port, every leaf's bits kept."""
    state = _port_state()
    want = pt.leaves(convert.train_state_to_numpy(state))
    save(state, 1, tmp_path / "port")
    jlike = jax.tree.map(lambda a: jnp.asarray(
        a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a),
        convert.train_state_to_numpy(state))
    jtree, step = jckpt.restore(jlike, tmp_path / "port")
    assert step == 1
    got = jax.tree.leaves(jtree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits(g).dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), w)
    jckpt.save(jtree, 2, tmp_path / "jax")
    back, step = restore(state, tmp_path / "jax")
    assert step == 2
    for g, w in zip(pt.leaves(convert.train_state_to_numpy(back)), want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_resumed_run_repeats_uninterrupted_run(tmp_path):
    """6 steps with checkpoints after steps 3 and 5; drop the last one
    and resume: steps 4 and 5 give the same losses, bit for bit, and the
    same final parameters."""
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "32",
            "--ckpt", str(tmp_path), "--ckpt-every", "4"]
    full = train_main(argv)
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert steps == ["step_000003", "step_000005"]
    final = convert.train_state_to_numpy(full["state"])
    shutil.rmtree(tmp_path / "step_000005")
    resumed = train_main(argv + ["--resume"])
    assert resumed["start"] == 4 and resumed["steps"] == [4, 5]
    assert resumed["losses"] == full["losses"][4:]
    for g, w in zip(pt.leaves(convert.train_state_to_numpy(
            resumed["state"])), pt.leaves(final)):
        np.testing.assert_array_equal(g, w)
    mgr = CheckpointManager(tmp_path, keep=1, async_=False)
    mgr.save(full["state"], 9)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000009"]


# -------------------------------------- the card's autograd Functions

def test_kernel_functions_carry_gradients_under_remat(monkeypatch):
    """The autograd Functions that the card's path goes through, with
    their launches done by the plain versions on the CPU: train_loss and
    every gradient equal plain autograd's (1e-5), each layer's forward
    runs twice under remat (its recompute) and its backward once, and no
    parameter leaf is left without a gradient."""
    calls = {"fwd": 0, "bwd": 0, "sfwd": 0, "sbwd": 0}

    def fwd(q, k, v, causal, window, q_offset, with_lse):
        calls["fwd"] += 1
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        return_lse=True)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return fa.flash_attention_bwd_plain(*a, **kw)

    def sfwd(cb, cs, win):
        calls["sfwd"] += 1
        return sd.ssd_intra_plain(cb, cs, win)

    def sbwd(cb, cs, win, dy, y=None):
        calls["sbwd"] += 1
        return sd.ssd_intra_bwd_plain(cb, cs, win, dy)

    for family in ("dense", "ssm"):
        jcfg, tcfg, params_np = _models(family)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(family, tcfg, 2).items()}
        fn = lambda p, b: tlm.train_loss(p, b, tcfg, tlm.NO_PARALLEL,  # noqa
                                         remat=True, loss_chunk=16)
        params = convert.lm_params_to_torch(params_np, "cpu")
        want_loss, want_g, _ = value_and_grad(fn, params, batch)
        with monkeypatch.context() as m:
            m.setattr(fa, "_launch_fwd", fwd)
            m.setattr(fa, "flash_attention_bwd", bwd)
            m.setattr(sd, "_launch_fwd", sfwd)
            m.setattr(sd, "ssd_intra_bwd", sbwd)
            # the model's two call sites, routed as on the card
            m.setattr(tlm, "attention", lambda q, k, v, causal=True,
                      window=None, q_offset=0: fa._FlashAttentionFn.apply(
                          q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal, window,
                          q_offset).transpose(1, 2))
            m.setattr(tssm, "ssd_intra", sd._SsdIntraFn.apply)
            calls.update(fwd=0, bwd=0, sfwd=0, sbwd=0)
            loss, grads, missing = value_and_grad(fn, params, batch)
        assert missing == 0
        assert abs(float(loss) - float(want_loss)) < 1e-5
        for g, w in zip(pt.leaves(grads), pt.leaves(want_g)):
            _close(_np(g), _np(w), 1e-5, 1e-7, what=family)
        n = tcfg.n_layers
        if family == "dense":
            assert (calls["fwd"], calls["bwd"]) == (2 * n, n), calls
        else:
            assert (calls["sfwd"], calls["sbwd"]) == (2 * n, n), calls
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
