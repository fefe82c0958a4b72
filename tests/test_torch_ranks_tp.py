"""Tensor parallelism over the model ranks: each model rank, for every
family, holds its block of every leaf the reference's ``state_specs``
shard over ``model`` and computes its block of every layer
(``models.lm``, ``models.ssm``, ``models.rglru``;
``parallel.collectives.enter`` and ``sum_ranks``).

One module fixture spawns 4 gloo ranks on the CPU once
(``parallel.dist.spawn``: a ``file://`` rendezvous in the test's own
directory, a limit on the join; a rank that fails or outlasts it ends
them all, and every case then fails) running
``tests/_torch_rank_tp_worker.py``, which imports no JAX, in two layouts
of a (data 2, model 4) mesh: 4 model ranks (``m4``) and 2 data x 2 model
ranks (``d2m2``), over the fp32 smoke configs of one model of every
family (qwen3-1.7b, deepseek-moe-16b, mamba2-2.7b, recurrentgemma-2b,
llava-next-mistral-7b, seamless-m4t-medium); beside the ranks one
subprocess runs the reference's
``build_train_step`` on an ``Auto`` (2, 4) mesh of 8 CPU devices with
the default policy, so GSPMD's tensor parallelism
(``tests/_torch_data_reference.py``), on the port's parameters.  Held:

* a rank's draw equals ``convert.rank_state`` of the whole draw; every
  leaf whose spec names ``model`` is held as the rank's block, and its
  parameter bytes are the whole tree's with each such leaf divided by
  the model ranks (and each data-sharded one by the data ranks);
* ``value_and_grad`` (the step's ``grads_of``), with and without remat:
  the loss within 1e-6 relative of one process (the row-parallel sums
  reorder a reduction, so bits may differ), every gradient block within
  1e-5 of the leaf's largest magnitude of one process and within 2e-4 x
  max + 1e-6 of the reference's, no leaf missed; the replicated
  gradients and every moe router input bit-equal across the ranks that
  hold them; the collectives a call :func:`collectives_per_step`'s;
* one train step with fp32 and with int8 m and v: the grad norm within
  1e-5 relative and every parameter block within 1e-5 of one process;
  every model's fp32 state over 4 model ranks checkpointed and restored
  in one process and over 2 x 2, bit for bit;
* the bodies tensor parallelism reshaped, one layer each against the
  whole layer within 1e-5 (Mamba2's gated norm and block, RG-LRU's
  block, the cross-attention), also over the production mesh's 16
  model shards;
* a serve (prefill and teacher-forced decode) on the (2, 4) mesh (Hq 4
  on 4 model shards: each rank its heads, its cache the KV heads they
  read and its share of the recurrent state) and ``launch.serve --production-mesh`` over 4 ranks (Hq 4 on 16
  shards: q gathered whole): ids equal, the prefill's logits within
  1e-5 of their scale of one process, the decode's within 1e-4 (the
  bf16 cache rounds the ranks' keys, a reduction's rounding away from
  one process's, to other bf16 neighbours); and the witness, one
  process with each row-parallel product split into the ranks' blocks
  and summed in fp32 in rank order (``chip_smoke.tp_witness``), gives
  model rank 0's logits bit for bit;
* ``ShardingPolicy(tp_enable=False)`` leaves every dense leaf whole
  along ``model`` (the model axis becomes a data axis) and matches one
  process;
* ``launch.train --production-mesh`` over both layouts matches one
  process within 1e-5; checkpoints cross 4 model ranks -> 2 x 2 and one
  process, one process -> 4 model ranks;
* ``rank_dims`` ranks every spec'd leaf along ``model``, for every
  family (none with ``tp_enable=False``), and the KV heads a rank keeps
  are the ones its q heads read.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_rank_tp_worker as W  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401
from test_torch_ranks_data import (  # noqa: E402
    _close, _paths, _rank_cache, _write_params, check_checkpoint,
    check_leaf)
from test_torch_ranks_data import (  # noqa: E402
    collectives_per_step as _data_collectives)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 240
N_RANKS = {"m4": {"data": 1, "model": 4}, "d2m2": {"data": 2, "model": 2}}
LOSS_TOL = 1e-6          # relative, against one process
GRAD_TOL = 1e-5          # x the leaf's largest magnitude, one process
REF_TOL = 2e-4           # x the leaf's largest magnitude (+ 1e-6), JAX
STEP_TOL = 1e-5          # the step's grad norm (relative) and parameters


def _import_chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _driver(module, argv, config=W.driver_config):
    """``module.main(argv)`` in this process with the driver's config."""
    real = module.get_smoke_config
    module.get_smoke_config = lambda arch: config(real(arch))
    try:
        return module.main(argv)
    finally:
        module.get_smoke_config = real


def _fp32(cfg):
    return cfg.replace(dtype="float32")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch import serve, train
    from repro_torch.parallel import dist as pd
    tmp = tmp_path_factory.mktemp("ranks_tp")
    params = _write_params(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_data_reference.py"),
         str(tmp), "2", "4"], cwd=str(ROOT), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    # the uninterrupted one-process run; its checkpoint after step 2 is
    # the one the 4 model ranks resume from
    one = _driver(train, W.TRAIN_ARGV + ["--ckpt", str(tmp / "ckpt_one")])
    shutil.rmtree(tmp / "ckpt_one" / "step_000004")
    served = _driver(serve, W.PSERVE_ARGV + ["--logits-out",
                                             str(tmp / "pserve_one.npz")],
                     _fp32)
    got = {"tmp": tmp, "error": None, "params": params, "one": one,
           "served": served}
    t0 = time.monotonic()
    try:
        got["seconds"] = pd.spawn(W.main, 4, args=(str(tmp),),
                                  timeout=JOIN_S)
        got["ranks"] = [dict(np.load(tmp / f"rank{r}.npz"))
                        for r in range(4)]
    except RuntimeError as e:
        got["error"] = f"{e} after {time.monotonic() - t0:.1f} s"
    try:
        out, err = jax_ref.communicate(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        jax_ref.kill()
        out, err = jax_ref.communicate()
    got["jax"] = ({a: dict(np.load(tmp / f"{a}_ref.npz")) for a in W.ARCHS}
                  if "DATA_REFERENCE_OK" in out else err[-3000:])
    return got


def _of(ranks, rank: int, prefix: str) -> dict:
    assert ranks["error"] is None, ranks["error"]
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ranks["ranks"][rank].items()
            if k.startswith(prefix + "/")}


def _coords(ranks, layout, rank):
    assert ranks["error"] is None, ranks["error"]
    return tuple(int(c) for c in ranks["ranks"][rank][f"coords_{layout}"])


def _dims(ranks, layout, arch) -> list:
    """Each parameter leaf's ``{axis: dim}`` as the ranks held it."""
    got = _of(ranks, 0, f"grads_{layout}_{arch}")
    return [eval(s) for s in got["dims"]]


def _block(x, dims, layout, coords):
    """Rank ``coords``' block of the whole leaf ``x`` by ``dims``."""
    for axis, d in dims.items():
        n = N_RANKS[layout][axis]
        c = coords[0 if axis == "data" else 1]
        k = x.shape[d] // n
        x = np.take(x, np.arange(c * k, (c + 1) * k), axis=d)
    return x


def _mesh():
    from repro_torch.core.rounds import Mesh
    return Mesh(W.MESH, "cpu")


def _spec_models(arch, mesh=None) -> list:
    """Each parameter leaf's spec entry that names ``model`` (None for
    none) on ``mesh`` (the (2, 4) one unless given), in JAX's leaf
    order."""
    from repro_torch import tree as pt
    from repro_torch.parallel.sharding import _map
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import state_shapes, state_specs
    tcfg = TrainConfig()
    specs = state_specs(mesh or _mesh(), state_shapes(W.model_config(arch),
                                                      tcfg), tcfg)["params"]
    return [None if d < 0 else d for d in pt.leaves(_map(
        lambda _, s: next((i for i, a in enumerate(s) if a == "model"), -1),
        specs))]


# ----------------------------------------------------- the state and draw

ATTN = {"wq", "wk", "wv", "wo"}
# leaves every family's model ranks hold as their blocks (at least)
SPLIT = {
    "qwen3-1.7b": {"embed", "wg", "wu", "wd"} | ATTN,
    "deepseek-moe-16b": {"embed", "head", "s_wg", "s_wu", "s_wd", "we_g",
                         "we_u", "we_d"} | ATTN,
    "mamba2-2.7b": {"embed", "head", "w_in", "w_conv", "a_log", "dt_bias",
                    "d_skip", "norm", "w_out"},
    "recurrentgemma-2b": {"embed", "wg", "wu", "wd", "w_x", "w_gate",
                          "w_conv", "w_r", "w_i", "b_r", "b_i", "lam",
                          "w_out"} | ATTN,
    "llava-next-mistral-7b": {"embed", "head", "wg", "wu", "wd"} | ATTN,
    "seamless-m4t-medium": {"embed", "head", "wu", "wd", "bu", "bq", "bk",
                            "bv", "x_wq", "x_wk", "x_wv", "x_wo", "x_bq",
                            "x_bk", "x_bv"} | ATTN,
}


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_rank_draw_holds_every_model_leaf_as_its_block(ranks, layout, arch):
    """``init_train_state(..., mesh=)`` equals ``convert.rank_state`` of
    the whole draw leaf for leaf (parameters, int8 m and v blocks, error
    feedback); every leaf whose spec names ``model`` (the column-, row-
    and vocab-parallel ones, the experts) is held as the rank's block at
    that entry, and a rank's parameter bytes are the whole tree's with
    each such leaf divided by the model ranks (a data-sharded one also
    by the data ranks)."""
    from repro_torch import tree as pt
    whole = pt.leaves(ranks["params"][arch])
    dims = _dims(ranks, layout, arch)
    assert [d.get("model") for d in dims] == _spec_models(arch)
    split = {k[-1] for k, d in zip(_paths(ranks["params"][arch]), dims)
             if "model" in d}
    assert SPLIT[arch] <= split
    want = sum(p.numel() * p.element_size()
               // np.prod([N_RANKS[layout][a] for a in d] or [1])
               for p, d in zip(whole, dims))
    for r in range(4):
        got = _of(ranks, r, f"draw_{layout}_{arch}")
        assert bool(got["same_tree"]) and got["equal"].all()
        assert int(got["param_bytes"]) == want


# --------------------------------------------------------- the gradients

def _one_process_grads(params, arch, remat, b=W.MODEL["b"], policy=None):
    from repro_torch import tree as pt
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.train.step import value_and_grad
    cfg = W.model_config(arch)
    ctx = make_ctx(_mesh(), cfg, policy)
    loss, grads, missing = value_and_grad(
        lambda p, bt: lm.train_loss(p, bt, cfg, ctx, remat=remat,
                                    loss_chunk=W.MODEL["loss_chunk"]),
        params, W.model_batch(cfg, b))
    assert missing == 0
    return float(loss), [g.numpy() for g in pt.leaves(grads)]


@pytest.fixture(scope="module")
def one_grads(ranks):
    return {(arch, remat): _one_process_grads(ranks["params"][arch], arch,
                                              remat)
            for arch in W.ARCHS for remat in (False, True)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_grads_over_model_ranks_match_one_process(ranks, one_grads, layout,
                                                  arch, remat):
    """The loss within 1e-6 relative of the one-process mesh's; every
    gradient leaf, by this rank's block, within 1e-5 x its largest
    magnitude of the one-process gradient (``check_leaf``: a leaf whose
    exact gradient is zero, zero within 1e-5 x the largest gradient);
    no leaf missed."""
    loss, want = one_grads[(arch, remat)]
    dims = _dims(ranks, layout, arch)
    paths = list(_paths(ranks["params"][arch]))
    key = f"remat{int(remat)}"
    for r in range(4):
        got = _of(ranks, r, f"grads_{layout}_{arch}")
        c = _coords(ranks, layout, r)
        assert int(got[f"{key}/missing"]) == 0
        assert float(got[f"{key}/loss"]) == pytest.approx(loss,
                                                          rel=LOSS_TOL)
        assert sum(k.startswith(f"{key}/grad") for k in got) == len(want)
        for i, wl in enumerate(want):
            check_leaf(got[f"{key}/grad{i}"], _block(wl, dims[i], layout, c),
                       wl, paths[i], GRAD_TOL, want)


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_grads_over_model_ranks_match_the_reference(ranks, layout, arch):
    """Every gradient block within 2e-4 of the leaf's largest magnitude
    + 1e-6 of the reference's ``jax.value_and_grad`` under its
    ``build_train_step`` context on an ``Auto`` (2, 4) mesh, the state
    placed by ``state_specs`` (GSPMD's tensor parallelism); the loss
    within 1e-5 relative; the leaf counts equal."""
    jax = ranks["jax"]
    assert isinstance(jax, dict), jax
    ref = jax[arch]
    cfg = W.model_config(arch)
    np.testing.assert_array_equal(
        ref["toks"][:, :-1], W.model_batch(cfg)["tokens"].numpy())
    dims = _dims(ranks, layout, arch)
    assert sum(k.startswith("grad") and k != "grad_norm"
               for k in ref) == len(dims)
    for r in range(4):
        got = _of(ranks, r, f"grads_{layout}_{arch}")
        c = _coords(ranks, layout, r)
        assert float(got["remat0/loss"]) == pytest.approx(
            float(ref["loss"]), rel=1e-5)
        for i, d in enumerate(dims):
            wl = ref[f"grad{i}"]
            err = float(np.abs(got[f"remat0/grad{i}"]
                               - _block(wl, d, layout, c)).max())
            assert err <= REF_TOL * float(np.abs(wl).max()) + 1e-6, (i, err)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_replicated_grads_and_router_inputs_are_the_same_bits(
        ranks, layout, arch, remat):
    """The gradients of the leaves every rank holds whole are bit-equal
    on every rank (the norms included: their partial gradients summed
    over the model ranks); every moe router input, forward and remat's
    rerun, is bit-equal across the model ranks of a data block (the
    row-parallel sums add in fp32 in rank order, the same bits on every
    rank)."""
    key = f"remat{int(remat)}"
    got = [_of(ranks, r, f"grads_{layout}_{arch}") for r in range(4)]
    dig = [g[f"{key}/digest_replicated"].tolist() for g in got]
    assert dig[0] and all(d == dig[0] for d in dig)
    routers = [g[f"{key}/router_in"].tolist() for g in got]
    if arch != "deepseek-moe-16b":
        assert routers == [[]] * 4
        return
    cfg = W.model_config(arch)
    assert len(routers[0]) == cfg.n_layers * (2 if remat else 1)
    for r in range(4):
        peers = [q for q in range(4) if _coords(ranks, layout, q)[0]
                 == _coords(ranks, layout, r)[0]]
        assert len(peers) == N_RANKS[layout]["model"]
        assert all(routers[q] == routers[r] for q in peers)


def collectives_per_step(cfg, remat, layout, chunks=1):
    """The collectives one ``grads_of`` issues on a rank, by axis:
    ``test_torch_ranks_data.collectives_per_step``'s (the tensor-parallel
    calls over model; over 2 x 2 also the data axis's, the top-level
    leaves data-sharded)."""
    return _data_collectives(cfg, True, remat, layout, chunks)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_collectives_a_step_follow_the_formula(ranks, layout, arch, remat):
    """Every rank counts :func:`collectives_per_step`'s calls, and no
    other collective."""
    want = collectives_per_step(W.model_config(arch), remat, layout)
    tag = f"remat{int(remat)}"
    for r in range(4):
        got = _of(ranks, r, f"grads_{layout}_{arch}")
        calls = {k[len(tag) + 6:]: int(v) for k, v in got.items()
                 if k.startswith(f"{tag}/coll/") and "." in k
                 and k.endswith("_calls")}
        assert calls == want, (r, calls, want)


# ------------------------------------------------------------- the steps

@pytest.mark.parametrize("tier", ["float32", "int8"])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_train_step_over_model_ranks_matches_one_process(ranks, layout,
                                                         arch, tier):
    """One step of AdamW with the global-norm clip, fp32 or int8 m and v
    (an int8 state whole along the model axis where a rank's width is
    not whole blocks): the grad norm within 1e-5 relative of the
    one-process step's, every parameter block within 1e-5, no gradient
    missing."""
    from repro_torch import tree as pt
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.train.step import init_train_state
    cfg = W.model_config(arch)
    tcfg = TrainConfig(remat=True, loss_chunk=W.MODEL["loss_chunk"],
                       opt=AdamWConfig(m_dtype=tier, v_mode=tier))
    step_fn, _, _ = build_train_step(cfg, _mesh(), tcfg)
    state = init_train_state(cfg, tcfg,
                             torch.Generator().manual_seed(W.STEP_SEED),
                             "cpu")
    state, m = step_fn(state, W.model_batch(cfg))
    assert float(m["grad_norm"]) > tcfg.opt.grad_clip   # the clip acts
    want = [p.numpy() for p in pt.leaves(state["params"])]
    dims = _dims(ranks, layout, arch)
    for r in range(4):
        got = _of(ranks, r, f"step_{layout}_{arch}")
        c = _coords(ranks, layout, r)
        assert int(got[f"{tier}/missing"]) == 0
        assert float(got[f"{tier}/grad_norm"]) == pytest.approx(
            float(m["grad_norm"]), rel=STEP_TOL)
        for i, (wl, d) in enumerate(zip(want, dims)):
            np.testing.assert_allclose(got[f"{tier}/param{i}"],
                                       _block(wl, d, layout, c), rtol=0,
                                       atol=STEP_TOL, err_msg=str(i))


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_sharding_policy_without_tp_keeps_dense_leaves_whole(
        ranks, layout):
    """``ShardingPolicy(tp_enable=False)``: no leaf is held as a model
    block (the model axis is a data axis: the batch's 8 rows split over
    every rank), the context has no tensor parallelism, and the loss and
    every gradient match the one-process mesh's under the same policy
    (1e-6 relative; 1e-6 x the leaf's largest magnitude)."""
    from repro_torch.parallel.sharding import ShardingPolicy
    policy = ShardingPolicy(tp_enable=False)
    loss, want = _one_process_grads(ranks["params"]["qwen3-1.7b"],
                                    "qwen3-1.7b", False, W.POLICY_B, policy)
    for r in range(4):
        got = _of(ranks, r, f"policy_{layout}")
        c = _coords(ranks, layout, r)
        dims = [eval(s) for s in got["dims"]]
        assert not bool(got["tp"]) and int(got["missing"]) == 0
        assert all("model" not in d for d in dims)
        assert float(got["loss"]) == pytest.approx(loss, rel=1e-6)
        for i, wl in enumerate(want):
            err = float(np.abs(got[f"grad{i}"]
                               - _block(wl, dims[i], layout, c)).max())
            assert err <= 1e-6 * float(np.abs(wl).max()), (i, err)


# ------------------------------------------------------------- the serve

def _serve_one(arch):
    """The serve case in one process: every row's logits and the cache's
    leaf shapes."""
    return W.serve_run(_mesh(), W.model_config(arch))


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_serve_over_model_ranks_matches_one_process(ranks, layout, arch):
    """A prefill and teacher-forced decode steps on the (2, 4) mesh: each
    rank's logits (its rows) within the serve tolerances of one
    process's, every argmax equal; each rank's cache holds its share
    (:func:`_rank_cache`: Hq 4 over 4 model shards, so a rank's 4 / n
    heads read one KV head over 4 ranks, 2 of deepseek's 4 over 2; the
    recurrentgemma smoke model's 2 q heads are every rank's, with its
    one KV head)."""
    want, shapes = _serve_one(arch)
    cfg = W.model_config(arch)
    n = N_RANKS[layout]["model"]
    for r in range(4):
        got = _of(ranks, r, f"serve_{layout}_{arch}")
        cache = {k[len("cache/"):]: tuple(int(i) for i in v)
                 for k, v in got.items() if k.startswith("cache/")}
        assert cache == _rank_cache(cfg, shapes, n, len(got["rows"])), r
        _close(got["logits"], want[:, got["rows"]])


def _witness_serve(arch, rows, n):
    cs = _import_chip_smoke()
    with cs.tp_witness(n, heads=True):     # Hq 4 on 4 model shards
        return W.serve_run(_mesh(), W.model_config(arch), rows=rows)


@pytest.mark.parametrize("layout,arch", [("m4", "qwen3-1.7b"),
                                         ("m4", "deepseek-moe-16b"),
                                         ("d2m2", "qwen3-1.7b")])
def test_split_row_sums_in_one_process_give_rank0s_bits(ranks, layout,
                                                        arch):
    """The witness: one process through the tensor-parallel path with
    each row-parallel product split into the model ranks' blocks and
    the partial products summed in fp32 in rank order gives model rank
    0's logits bit for bit (its rows alone; the moe case where rank 0
    serves every row), so what separates the ranks from one process is
    the sums' rounding, not a wrong block; its cache holds every KV
    head."""
    got = _of(ranks, 0, f"serve_{layout}_{arch}")
    logits, shapes = _witness_serve(arch, got["rows"],
                                    N_RANKS[layout]["model"])
    assert shapes["k"][3] == W.model_config(arch).n_kv_heads
    np.testing.assert_array_equal(logits, got["logits"])


def test_production_mesh_serve_over_model_ranks(ranks, tmp_path):
    """``launch.serve --production-mesh`` over 4 ranks (qwen3 at smoke
    width: Hq 4 on 16 model shards, so q is gathered whole and every rank
    reads both KV heads): every rank returns the one-process run's ids;
    the gathered logits within the serve tolerances of one process's; a
    rank's parameter bytes are the replicated leaves plus a quarter of
    the split ones; the witness gives its logits bit for bit."""
    from repro_torch import tree as pt
    from repro_torch.launch import serve
    one = ranks["served"]
    for r in range(4):
        got = _of(ranks, r, "pserve")
        assert str(got["layout"]) == "{'model': 4}"
        assert int(got["kv_heads"]) == 2
        np.testing.assert_array_equal(got["generated"], one["generated"])
    a = np.load(ranks["tmp"] / "pserve_ranks.npz")
    b = np.load(ranks["tmp"] / "pserve_one.npz")
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    _close(a["logits"], b["logits"])
    from repro_torch.launch.mesh import make_production_mesh
    dims = _spec_models("qwen3-1.7b", make_production_mesh(device="cpu"))
    want = sum(p.numel() * p.element_size() // (1 if d is None else 4)
               for p, d in zip(pt.leaves(ranks["params"]["qwen3-1.7b"]),
                               dims))
    assert sum(d is not None for d in dims) == 8
    for r in range(4):
        assert int(_of(ranks, r, "pserve")["param_bytes"]) == want
    cs = _import_chip_smoke()
    with cs.tp_witness(4):
        _driver(serve, W.PSERVE_ARGV + [
            "--teacher", str(ranks["tmp"] / "pserve_ranks.npz"),
            "--logits-out", str(tmp_path / "witness.npz")], _fp32)
    np.testing.assert_array_equal(np.load(tmp_path / "witness.npz")[
        "logits"], a["logits"])


# ------------------------------------------------- the reshaped bodies

BODY_TOL = 1e-5    # x the whole tensor's largest magnitude (9e's bound)
# where the bodies ran: the (2, 4) mesh's layouts, and 4 model ranks of
# the production mesh (16 model shards: Mamba2's 8 heads and seamless's
# 4 q heads stay whole on a rank, and so do Mamba2's w_in, a_log,
# dt_bias and d_skip)
BODY_CASES = {"m4": 4, "d2m2": 4, "prod": 16}


@pytest.fixture(scope="module")
def one_bodies():
    from repro_torch.launch.mesh import make_production_mesh
    return {"mesh": W.body_case(_mesh()),
            "prod": W.body_case(make_production_mesh(device="cpu"))}


def _bodies(ranks, case, r, tag) -> dict:
    got = _of(ranks, r, f"bodies_{case}")
    return {k[len(tag) + 1:]: v for k, v in got.items()
            if k.startswith(tag + "/")}


def _body_want(one_bodies, case, tag) -> dict:
    want = one_bodies["prod" if case == "prod" else "mesh"]
    return {k[len(tag) + 1:]: v for k, v in want.items()
            if k.startswith(tag + "/")}


def _rank_of(ranks, case, r):
    """(model ranks, this rank's model coordinate) of a body case."""
    if case == "prod":
        return 4, r
    return N_RANKS[case]["model"], _coords(ranks, case, r)[1]


def _heads(h, case, n, c):
    """(first, count): the heads a rank computes, its block where the
    case's model shards divide ``h``, else every head."""
    if h % BODY_CASES[case]:
        return 0, h
    return c * (h // n), h // n


def _near(got, want, what):
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= BODY_TOL * float(np.abs(want).max()), (what, err)


def _take(x, dim, first, count):
    return np.take(x, np.arange(first, first + count), axis=dim)


def _param_grads(got, want, n, c):
    """Each parameter's gradient: the rank's block of the whole one along
    its model dim (whole where it is -1), by ``check_leaf`` (a leaf whose
    exact gradient is zero held to zero)."""
    keys = [k[2:] for k in want if k.startswith("g/")]
    for key in keys:
        d = int(got[f"dim/{key}"])
        w = block = want[f"g/{key}"]
        if d >= 0:
            k = w.shape[d] // n
            block = _take(w, d, c * k, k)
        check_leaf(got[f"g/{key}"], block, w, (key,), BODY_TOL,
                   [want[f"g/{k}"] for k in keys])


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_mamba2_gated_norm_sums_squares_over_model_ranks(ranks, one_bodies,
                                                         case):
    """``ssm._gated_norm`` on a rank's heads' features (its sum of squares
    the model ranks' summed in rank order, its gradient summed back over
    them; every feature where the rank computes every head): the rank's
    block of the whole norm's output and of the gradients of y, z and
    the scale, within 1e-5 of their scale."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("mamba2-2.7b")
    want = _body_want(one_bodies, case, "norm")
    for r in range(4):
        got = _bodies(ranks, case, r, "norm")
        n, c = _rank_of(ranks, case, r)
        first, count = _heads(cfg.n_ssm_heads, case, n, c)
        lo, k = first * cfg.ssm_head_dim, count * cfg.ssm_head_dim
        for key in ("y", "g_y", "g_z", "g/scale"):
            _near(got[key], _take(want[key], -1, lo, k), key)


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_mamba2_block_runs_its_heads_of_the_gathered_projection(
        ranks, one_bodies, case):
    """Mamba2's block on a rank: its output and input gradient within
    1e-5 of the whole block's; its state the whole one's at its heads,
    its conv tail the whole one's at its heads' x channels and every B
    and C channel (the gathered ``w_in`` output cut to its heads; on the
    production mesh every head, ``w_in`` whole, its features cut at the
    norm); every parameter gradient its block of the whole one's."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("mamba2-2.7b")
    p = cfg.ssm_head_dim
    want = _body_want(one_bodies, case, "ssm")
    for r in range(4):
        got = _bodies(ranks, case, r, "ssm")
        n, c = _rank_of(ranks, case, r)
        first, h = _heads(cfg.n_ssm_heads, case, n, c)
        _near(got["y"], want["y"], "y")
        _near(got["g_x"], want["g_x"], "g_x")
        _near(got["state"], _take(want["state"], 1, first, h), "state")
        tail = want["tail"]
        _near(got["tail"], np.concatenate([
            _take(tail, -1, first * p, h * p),
            tail[..., cfg.d_inner:]], -1), "tail")
        _param_grads(got, want, n, c)


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_rglru_block_gathers_its_conv_output(ranks, one_bodies, case):
    """RG-LRU's block on a rank (its block of the width, the conv output
    gathered for the dense ``w_r`` and ``w_i``): its output and input
    gradient within 1e-5 of the whole block's; its last state and conv
    tail the whole ones' blocks; every parameter gradient its block."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("recurrentgemma-2b")
    want = _body_want(one_bodies, case, "rec")
    for r in range(4):
        got = _bodies(ranks, case, r, "rec")
        n, c = _rank_of(ranks, case, r)
        w = cfg.lru_width // n
        _near(got["y"], want["y"], "y")
        _near(got["g_x"], want["g_x"], "g_x")
        for key in ("h_last", "tail"):
            _near(got[key], _take(want[key], -1, c * w, w), key)
        _param_grads(got, want, n, c)


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_cross_attention_keeps_the_kv_heads_its_q_heads_read(
        ranks, one_bodies, case):
    """The decoder's cross-attention on a rank: ``lm._cross_kv`` gives
    every layer's cross K and V at the KV heads its q heads read
    (``lm._kv_select``; every head on the production mesh) within 1e-5
    of the whole ones'; the attention's output and the gradients of its
    input and the encoder output within 1e-5 of the whole layer's;
    every ``x_`` parameter gradient its block."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = get_smoke_config("seamless-m4t-medium")
    want = _body_want(one_bodies, case, "xattn")
    for r in range(4):
        got = _bodies(ranks, case, r, "xattn")
        n, c = _rank_of(ranks, case, r)
        sel = lm._kv_select(cfg, *_heads(cfg.n_heads, case, n, c))
        idx = (np.arange(sel[0], sel[0] + sel[1]) if isinstance(sel, tuple)
               else np.asarray(sel))
        for key in ("k", "v"):
            _near(got[key], np.take(want[key], idx, axis=3), key)
        for key in ("y", "g_x", "g_enc"):
            _near(got[key], want[key], key)
        _param_grads(got, want, n, c)


# ----------------------------------------------- the driver, checkpoints

@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_train_driver_over_model_ranks_matches_one_process(ranks, layout):
    """``launch.train --production-mesh`` (deepseek at smoke width, 16
    experts; EP and tensor parallelism over the model ranks): every rank
    reports the same losses and grad norms, each within 1e-5 relative of
    the one-process run's; no gradient missing."""
    one = ranks["one"]
    want = {"m4": "{'model': 4}", "d2m2": "{'data': 2, 'model': 2}"}[layout]
    for r in range(4):
        got = _of(ranks, r, f"train_{layout}")
        assert str(got["layout"]) == want and int(got["missing"]) == 0
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(
            got["losses"], _of(ranks, 0, f"train_{layout}")["losses"])
        assert int(got["param_bytes"]) < one["param_bytes"] // 2


@pytest.mark.parametrize("arch", W.ARCHS)
def test_checkpoint_of_every_family_crosses_model_ranks(ranks, arch):
    """The fp32 step's state over 4 model ranks, checkpointed, holds every
    rank's tensor-parallel blocks; it restores in one process and over
    2 x 2 ranks (``test_torch_ranks_data.check_checkpoint``)."""
    check_checkpoint(ranks, arch, list(W.LAYOUTS), _of, _coords, _dims,
                     _block)


def test_checkpoints_cross_model_ranks_2x2_and_one_process(ranks, tmp_path):
    """The one-process checkpoint after step 2 resumes over 4 model ranks;
    theirs after step 2 (written whole by rank 0) resumes over 2 x 2
    ranks and in one process; each continues within 1e-5 of the
    uninterrupted run."""
    from repro_torch.launch import train
    want = ranks["one"]["losses"][3:]
    for layout in W.LAYOUTS:
        for r in range(4):
            got = _of(ranks, r, f"train_{layout}")
            assert int(got["resumed/start"]) == 3
            np.testing.assert_allclose(got["resumed/losses"], want,
                                       rtol=1e-5)
    src = ranks["tmp"] / "ckpt_m4"
    assert sorted(p.name for p in src.iterdir()) == ["step_000002",
                                                     "step_000004"]
    shutil.copytree(src, tmp_path / "ckpt")
    shutil.rmtree(tmp_path / "ckpt" / "step_000004")
    res = _driver(train, W.TRAIN_ARGV + ["--resume", "--ckpt",
                                         str(tmp_path / "ckpt")])
    assert res["start"] == 3
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)


# ------------------------------------------------ the layout, no ranks

class _RankedMesh:
    """What ``rank_dims`` reads of a mesh whose model axis 4 ranks split."""
    ranked = True
    ranks = {"model": 4}


@pytest.mark.parametrize("tp_enable", [True, False])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "recurrentgemma-2b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
def test_rank_dims_rank_every_model_leaf(arch, tp_enable):
    """Along a ranked model axis ``rank_dims`` names, at its entry, every
    leaf whose spec names ``model`` (tensor parallelism, every family:
    the column-, row- and vocab-parallel leaves, Mamba2's and RG-LRU's,
    the routed experts) and no other; with ``tp_enable=False`` no spec
    names ``model`` and no leaf is ranked along it."""
    from repro_torch import tree as pt
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import (ShardingPolicy, _map,
                                               param_specs, rank_dims)
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import state_shapes
    cfg = get_config(arch)
    shapes = state_shapes(cfg, TrainConfig())["params"]
    specs = param_specs(make_production_mesh(device="cpu"), shapes,
                        ShardingPolicy(tp_enable=tp_enable))
    got = pt.leaves(_map(lambda _, d: d.get("model", -1),
                         rank_dims(_RankedMesh(), specs)))
    names = pt.leaves(_map(lambda _, s: next(
        (i for i, a in enumerate(s) if a == "model"), -1), specs))
    assert len(got) == len(names) == len(pt.leaves(shapes))
    assert got == names
    assert (sum(d >= 0 for d in got) > 4) == tp_enable


@pytest.mark.parametrize("hq,hkv,n,want", [
    (16, 8, 4, [(0, 2), (2, 2), (4, 2), (6, 2)]),    # qwen3 over 4 ranks
    (4, 2, 4, [(0, 1), (0, 1), (1, 1), (1, 1)]),     # a group over 2 ranks
    (4, 4, 2, [(0, 2), (2, 2)]),
    (6, 2, 2, [(0, 1), (1, 1)]),
    (6, 3, 4, None)])                                 # Hq not split: all
def test_each_rank_keeps_the_kv_heads_its_q_heads_read(hq, hkv, n, want):
    """``lm._kv_select`` of a rank's q heads: the contiguous KV heads they
    read in equal groups, or one KV head a q head where they do not fall
    into equal groups (6 q over 4 KV-head groups of 2: every q head, the
    MHA form)."""
    from repro_torch.models import lm
    from repro_torch.models.config import LMConfig
    cfg = LMConfig(name="t", family="dense", n_layers=1, d_model=hq * 8,
                   n_heads=hq, n_kv_heads=hkv, d_ff=8, vocab=8)
    if want is None:
        assert lm._kv_select(cfg, 1, 3) == [0, 1, 1]
        return
    per = hq // n
    assert [lm._kv_select(cfg, c * per, per) for c in range(n)] == want


# ---------------------------------------------------- chip_smoke's phase

SMALL = {"train": dict(steps=2, batch=8, seq=32),
         "serve": dict(requests=4, batch=4, prompt=16, gen=3)}


def test_chip_smoke_tp_ranks_phase_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 7f rehearsed on the CPU at smoke sizes
    (bf16): the one-process references, 4 ranks of ``rank_tp_main`` (one
    model of every family trained over 4 model ranks and over 2 x 2,
    served over 4 model ranks teacher-forced), the witness and the
    parent's checks all pass, the witness giving the ranks' Qwen3 serve
    logits bit for bit; the same records with one rank's step-0 loss
    moved past its tolerance (Qwen3, Mamba2), its parameter bytes off by
    one (Qwen3, recurrentgemma), a serve's logits off their tolerance
    (Qwen3 with the witness bit-equal or not, llava), a cache's KV heads
    off (seamless), or the witness not bit-equal, fail the checks."""
    import copy

    from repro_torch import kernels as K
    cs = _import_chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    ref_counts, launches, got = cs.tp_ranks_phase(torch.device("cpu"), K,
                                                  small=SMALL)
    ref, recs, witness = got["ref"], got["recs"], got["witness"]
    assert witness["bit_equal"], witness
    assert recs[0]["qwen3-1.7b/serve"]["result"]["kv_heads"] == 2
    assert recs[0]["mamba2-2.7b/serve"]["result"]["kv_heads"] is None
    cs.tp_ranks_checks(K, ref, recs, witness, SMALL)

    def fails(bad, wit=witness):
        with pytest.raises(AssertionError):
            cs.tp_ranks_checks(K, ref, bad, wit, SMALL)
    for arch in ("qwen3-1.7b", "mamba2-2.7b"):
        bad = copy.deepcopy(recs)
        for rec in bad:
            rec[f"{arch}/train_m4"]["result"]["losses"][0] *= \
                1 + 2 * cs.TP_LOSS0_TOL
        fails(bad)
    for arch in ("qwen3-1.7b", "recurrentgemma-2b"):
        bad = copy.deepcopy(recs)
        bad[1][f"{arch}/train_d2m2"]["result"]["param_bytes"] += 1
        fails(bad)
    for arch in ("qwen3-1.7b", "llava-next-mistral-7b"):
        bad = copy.deepcopy(recs)
        bad[0]["serve_logits"][arch]["rel_err"] = 2 * cs.REPLAY_TOL
        for wit in (witness, dict(witness, bit_equal=False)):
            fails(bad, wit)
    bad = copy.deepcopy(recs)
    bad[3]["seamless-m4t-medium/serve"]["result"]["kv_heads"] += 1
    fails(bad)
    fails(recs, dict(witness, bit_equal=False))
