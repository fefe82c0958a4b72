"""Training over ``torch.distributed`` ranks: the collectives' backward,
the clip over sharded gradients and checkpoints over ranks.

One module fixture spawns 4 gloo ranks on the CPU once
(``parallel.dist.spawn``: a ``file://`` rendezvous in the test's own
directory, a limit on the join; a rank that fails or outlasts it ends
them all, and every case then fails) running
``tests/_torch_rank_train_worker.py``, which imports no JAX, over 4 ranks
x 1 model shard and 2 ranks x 2 model shards of a (data 2, model 4)
mesh; beside the ranks, one subprocess runs the reference's fp32
deepseek smoke model on an ``Auto`` (2, 4) mesh of 8 CPU devices
(``tests/_torch_moe_reference.py``) on the port's parameters.  Held:

* each autograd move's backward (``parallel.collectives``): a replicated
  gradient comes back the same on every rank and never scaled by the
  world, which ``torch.distributed.nn``'s all-gather does;
* a rank's train state drawn with its experts and its model blocks
  (tensor parallelism: every leaf whose spec names ``model``) equals the
  cut of the whole draw, and places by the whole leaf's specs;
* the model's ``value_and_grad``, with and without remat: the loss
  within 1e-6 relative of the one-process mesh's (the row-parallel sums
  reorder a reduction), every gradient leaf (a ranked leaf by the rank's
  block) within 1e-5 of its largest magnitude of the one-process value
  and within 2e-4 x max + 1e-6 of the reference's ``shard_map``
  gradient; no leaf missed; the replicated gradients bit for bit equal
  on every rank; the collectives a call equal the formula of
  :func:`collectives_per_step`;
* one train step (AdamW, the clip over every rank's gradient) against
  the one-process step: the grad norm within 1e-6 relative, every
  parameter within 1e-6;
* ``launch.train --production-mesh`` at smoke width (16 experts, EP 16:
  4 model shards a rank) over the 4 ranks: losses and grad norms within
  1e-5 relative of the one-process run; a checkpoint written over the 4
  ranks resumes in one process, and one written in one process resumes
  over the 4 ranks, both continuing within 1e-5 of the uninterrupted
  run.
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

import _torch_rank_train_worker as W  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 240
# a gradient against one process, x the leaf's largest magnitude: the
# tensor-parallel sums reorder reductions (ln1's, 1.03e-6 over 2 ranks)
GRAD_TOL = 1e-5


def _write_params(tmp):
    """The port's draw of the model (seed 0) as ``params/...`` arrays,
    the reference's parameter layout."""
    from repro_torch import tree as pt
    from repro_torch.models import lm
    cfg = W.model_config()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    arrays = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            arrays["params/" + "/".join(path)] = node.numpy()
    walk(params, [])
    np.savez(tmp / "model_in.npz", **arrays)
    assert len(arrays) == len(pt.leaves(params))
    return params


def _one_process_train(argv):
    """``launch.train.main`` in this process with the driver case's
    config."""
    from repro_torch.launch import train
    real = train.get_smoke_config
    train.get_smoke_config = lambda arch: W.train_config(real(arch))
    try:
        return train.main(argv)
    finally:
        train.get_smoke_config = real


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.parallel import dist as pd
    tmp = tmp_path_factory.mktemp("ranks_train")
    params = _write_params(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_moe_reference.py"),
         str(tmp / "jax.npz"), str(tmp / "model_in.npz")],
        cwd=str(ROOT), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    # the uninterrupted one-process run; its checkpoint after step 2 is
    # the one the ranks resume from
    one = _one_process_train(W.TRAIN_ARGV + ["--ckpt",
                                             str(tmp / "ckpt_one")])
    shutil.rmtree(tmp / "ckpt_one" / "step_000004")
    got = {"tmp": tmp, "error": None, "params": params, "one": one}
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
    got["jax"] = (dict(np.load(tmp / "jax.npz"))
                  if "MOE_REFERENCE_OK" in out else err[-3000:])
    return got


def _of(ranks, rank: int, prefix: str) -> dict:
    assert ranks["error"] is None, ranks["error"]
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ranks["ranks"][rank].items()
            if k.startswith(prefix + "/")}


def _groups(layout):
    """The ranks that computed together, by group."""
    return [[0, 1, 2, 3]] if layout == "4x1" else [[0, 1], [2, 3]]


def _mesh():
    from repro_torch.core.rounds import Mesh
    return Mesh({"data": 2, "model": 4}, "cpu")


def _block(x, pos, world, dims):
    """Rank ``pos``'s block of a whole leaf ``x`` over ``world`` ranks
    along its model dim (``dims``: the leaf's ``{axis: dim}``; ``x``
    itself for a leaf every rank holds whole)."""
    if "model" not in dims:
        return x
    d = dims["model"]
    n = x.shape[d] // world
    return np.take(x, np.arange(pos * n, (pos + 1) * n), axis=d)


def _dims(ranks, layout) -> list:
    """Each parameter leaf's ``{axis: dim}`` as the ranks held it."""
    return [eval(s) for s in _of(ranks, 0, f"grads_{layout}")["dims"]]


def _map_experts(specs):
    """A tree matching ``specs`` of whether each leaf lies under a routed
    expert's key."""
    from repro_torch.convert import EXPERT_LEAVES

    def walk(node, under):
        if isinstance(node, dict):
            return {k: walk(v, under or k in EXPERT_LEAVES)
                    for k, v in node.items()}
        return under
    return walk(specs, False)


def _model_entries(specs) -> list:
    """Each spec's entry that names ``model`` (-1 for none), in JAX's
    leaf order."""
    from repro_torch import tree as pt
    from repro_torch.parallel.sharding import _map
    return pt.leaves(_map(lambda _, s: next(
        (i for i, a in enumerate(s) if a == "model"), -1), specs))


# ------------------------------------------------------------- the moves

@pytest.mark.parametrize("layout", W.LAYOUTS)
def test_each_move_carries_its_gradient(ranks, layout):
    """The round trip replicated -> block -> replicated is the identity
    with the replicated gradient unscaled; the block slice's backward
    gathers every rank's block gradient in rank order; the gather's
    backward keeps this rank's rows of the replicated gradient (where
    ``torch.distributed.nn``'s all-gather returns them times the world);
    ``all_to_all``'s backward sends each row's gradient back to the rank
    it came from; ``all_reduce``'s passes through."""
    for group in _groups(layout):
        w = len(group)
        gen = torch.Generator().manual_seed(7)
        x_rep = torch.randn(8, 3, generator=gen).numpy()
        c_rep = torch.randn(8, 3, generator=gen).numpy()
        c_blk = torch.randn(8 // w, 3, generator=gen).numpy()
        got = [_of(ranks, r, f"moves_{layout}") for r in group]
        owns = [torch.randn(8, 3, generator=torch.Generator().manual_seed(
            30 + p)).numpy() for p in range(w)]
        for pos, g in enumerate(got):
            np.testing.assert_array_equal(g["round_trip/y"], x_rep)
            np.testing.assert_array_equal(g["round_trip/g"], c_rep)
            rows = slice(pos * 8 // w, (pos + 1) * 8 // w)
            np.testing.assert_array_equal(g["block/y"],
                                          x_rep[rows] * (1 + pos))
            np.testing.assert_array_equal(g["block/g"], np.concatenate(
                [c_blk * (1 + q) for q in range(w)]))
            np.testing.assert_array_equal(g["gather/y"], np.concatenate(
                [o[:8 // w] for o in owns]))
            np.testing.assert_array_equal(g["gather/g"], c_rep[rows])
            if layout == "4x1":
                # the check above fails for a gradient scaled by the world
                np.testing.assert_allclose(g["dnn_gather/g"],
                                           w * c_rep[rows], rtol=1e-6)
                assert not np.allclose(g["dnn_gather/g"], g["gather/g"])
            # rank q sent p + 1 rows to rank p, after the rows for ranks
            # before p
            def sent(q, p):
                lo = sum(range(1, p + 1))
                return slice(lo, lo + p + 1)
            np.testing.assert_array_equal(g["a2a/y"], np.concatenate(
                [got[q]["a2a/x"][sent(q, pos)] for q in range(w)]))
            np.testing.assert_array_equal(g["a2a/g"], np.concatenate(
                [got[p]["a2a/c"][q * (p + 1):(q + 1) * (p + 1)]
                 for p in range(w) for q in (pos,)]))
            np.testing.assert_allclose(g["reduce/y"], sum(
                h["reduce/x"] for h in got), rtol=1e-6)
            np.testing.assert_array_equal(g["reduce/g"], c_rep[0])


# ----------------------------------------------------- the state and draw

@pytest.mark.parametrize("layout", W.LAYOUTS)
def test_rank_draw_equals_the_cut_of_the_whole_draw(ranks, layout):
    """``init_train_state(..., experts=, mesh=)`` equals
    ``convert.rank_state`` of the whole state leaf for leaf (parameters,
    int8 m and v blocks, error feedback); ``state_specs`` of the rank's
    state are the whole state's, and ``device_put`` places it by them;
    every leaf whose spec names ``model`` is ranked at that entry (the
    experts' on dim 1: parameter, m and v blocks, error feedback)."""
    from repro_torch import tree as pt
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import init_train_state, state_specs
    cfg = W.model_config()
    tcfg = TrainConfig(compress_grads=True, opt=AdamWConfig(
        m_dtype="int8", v_mode="int8"))
    whole = init_train_state(cfg, tcfg, torch.Generator().manual_seed(5),
                             "cpu")
    specs = state_specs(_mesh(), whole, tcfg)
    want = [repr(s) for s in pt.leaves(specs)]
    entries = _model_entries(specs)
    for group in _groups(layout):
        w = len(group)
        for pos, r in enumerate(group):
            got = _of(ranks, r, f"draw_{layout}")
            per = cfg.n_experts // w
            assert got["block"].tolist() == [pos * per, (pos + 1) * per]
            assert bool(got["same_tree"]) and got["equal"].all()
            assert int(got["expert_rows"]) == per
            assert bool(got["placed"])
            assert got["specs"].tolist() == want
            # every leaf whose spec names model ranked at that entry
            dims = got["rank_dims"]
            assert dims.tolist() == entries
            experts = pt.leaves(_map_experts(specs))
            assert sum(experts) == 3 * (1 + 2 + 2 + 1)
            assert {int(d) for d, e in zip(dims, experts) if e} == {1}


# --------------------------------------------------------- the gradients

def _one_process_grads(params, remat):
    from repro_torch import tree as pt
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.train.step import value_and_grad
    cfg = W.model_config()
    ctx = make_ctx(_mesh(), cfg)
    loss, grads, missing = value_and_grad(
        lambda p, b: lm.train_loss(p, b, cfg, ctx, remat=remat,
                                   loss_chunk=W.MODEL["loss_chunk"]),
        params, W.model_batch(cfg.vocab))
    assert missing == 0
    return loss, pt.leaves(grads)


@pytest.fixture(scope="module")
def one_grads(ranks):
    return {remat: _one_process_grads(ranks["params"], remat)
            for remat in (False, True)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("layout", W.LAYOUTS)
def test_grads_over_ranks_match_one_process(ranks, one_grads, layout,
                                            remat):
    """The loss within 1e-6 relative of the one-process mesh's (the
    row-parallel sums reorder a reduction); every gradient leaf is
    within 1e-5 of its largest magnitude of the one-process gradient (a
    ranked leaf by the rank's block: the routed experts and every
    tensor-parallel leaf); no leaf misses its gradient; the replicated
    leaves' gradients are bit for bit equal on every rank."""
    loss, want = one_grads[remat]
    tag = f"remat{int(remat)}"
    digests = []
    dims = _dims(ranks, layout)
    for group in _groups(layout):
        w = len(group)
        for pos, r in enumerate(group):
            got = _of(ranks, r, f"grads_{layout}")
            assert int(got[f"{tag}/missing"]) == 0
            assert float(got[f"{tag}/loss"]) == pytest.approx(float(loss),
                                                              rel=1e-6)
            ranked = got["ranked"]
            # embed, head, wq, wk, wv, wo, the experts and the shared ones
            assert ranked.sum() == 12
            for i, wl in enumerate(want):
                wl = wl.numpy()
                g = got[f"{tag}/grad{i}"]
                ref = _block(wl, pos, w, dims[i])
                assert g.shape == ref.shape, i
                err = float(np.abs(g - ref).max())
                assert err <= GRAD_TOL * float(np.abs(wl).max()), (i, err)
            digests.append(got[f"{tag}/digest_replicated"].tolist())
    assert len(digests[0]) == len(want) - 12
    assert all(d == digests[0] for d in digests), digests


@pytest.mark.parametrize("layout", W.LAYOUTS)
def test_grads_over_ranks_match_the_reference(ranks, layout):
    """Every gradient leaf over ranks is within 2e-4 of the leaf's
    largest magnitude + 1e-6 of the reference's ``jax.value_and_grad``
    through its ``shard_map`` on an ``Auto`` (2, 4) mesh, on the same
    parameters and tokens; the losses within 1e-5 relative."""
    jax = ranks["jax"]
    assert isinstance(jax, dict), jax
    np.testing.assert_array_equal(
        jax["model/toks"][:, :-1], W.model_batch(
            W.model_config().vocab)["tokens"].numpy())
    dims = _dims(ranks, layout)
    for group in _groups(layout):
        w = len(group)
        for pos, r in enumerate(group):
            got = _of(ranks, r, f"grads_{layout}")
            assert float(got["remat0/loss"]) == pytest.approx(
                float(jax["model/loss"]), rel=1e-5)
            n = sum(k.startswith("model/grad") for k in jax)
            assert n == len(got["ranked"])
            for i in range(n):
                wl = jax[f"model/grad{i}"]
                ref = _block(wl, pos, w, dims[i])
                err = float(np.abs(got[f"remat0/grad{i}"] - ref).max())
                assert err <= 2e-4 * float(np.abs(wl).max()) + 1e-6, (i, err)


def collectives_per_step(n_moe_layers, remat, chunks=1):
    """The collectives one ``value_and_grad`` of ``lm.train_loss`` issues
    on a rank, where the model axis is ranked and the sequence splits
    over the ranks: each expert-parallel moe layer's forward makes two
    ``all_to_all``s (the exchanges), one all-gather of the token blocks
    and one ``all_reduce`` of ``aux``; its backward one ``all_to_all``
    for each exchange and one all-gather for each of the two block
    slices (the tokens and the router logits), and nothing for the
    gather (a slice) and the ``all_reduce`` (the identity).  Tensor
    parallelism adds, a layer, three in the forward (k and v gathered in
    one, the sums of ``wo``'s and the shared experts' ``s_wd``'s partial
    products) and three in the backward (the sums of the normed input's
    partial gradients before the attention and the shared experts, the
    reduce-scatter of k's and v's), and once a step the embedding's sum,
    two a loss chunk (the ranks' maxima, the ``exp`` sums and target
    logits in one) again when its checkpoint recomputes it, and the sum
    of the final hidden state's partial gradients.  Remat runs each
    layer's forward once more inside the backward, up to its last saved
    tensor (the checkpoint's recompute stops there): all but the shared
    experts' sum, the layer's last collective.  Every all-gather is an
    ``all_to_all``."""
    fwd_a2a, fwd_ar = 3 + 3, 1
    bwd_a2a = 2 + 2 + 3
    runs = 2 if remat else 1
    rerun = 1 if remat else 0
    return {"all_to_all_calls": n_moe_layers * (runs * fwd_a2a - rerun
                                                + bwd_a2a)
            + 1 + 4 * chunks + 1,
            "all_reduce_calls": n_moe_layers * runs * fwd_ar}


@pytest.mark.parametrize("remat", [False, True])
def test_collectives_a_step_follow_the_formula(ranks, remat):
    """Every rank counts the same calls, :func:`collectives_per_step`'s,
    and the step's optimizer update adds one ``all_reduce`` (the clip's
    partial sums); the driver counts the same a step."""
    cfg = W.model_config()
    want = collectives_per_step(cfg.n_layers, remat)
    tag = f"remat{int(remat)}"
    for layout in W.LAYOUTS:
        for r in range(4):
            got = _of(ranks, r, f"grads_{layout}")
            calls = {k: int(got[f"{tag}/coll/{k}"]) for k in want}
            assert calls == want, (layout, r, calls)
    drv = _of(ranks, 0, "train")
    smoke = W.train_config(W.model_config())
    step = collectives_per_step(smoke.n_layers, remat=False)
    step["all_reduce_calls"] += 1
    for k, n in step.items():
        assert drv[f"coll/{k}"].tolist() == [n] * len(drv["losses"]), k


# ------------------------------------------------------------- the steps

@pytest.mark.parametrize("layout", W.LAYOUTS)
def test_train_step_over_ranks_matches_one_process(ranks, layout):
    """One step of AdamW with the global-norm clip: the grad norm (over
    every rank's expert block) within 1e-6 relative of the one-process
    step's, every updated parameter within 1e-6, no gradient missing."""
    from repro_torch import tree as pt
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.train.step import init_train_state
    cfg = W.model_config()
    tcfg = TrainConfig(remat=True, loss_chunk=W.MODEL["loss_chunk"])
    step_fn, _, _ = build_train_step(cfg, _mesh(), tcfg)
    state = init_train_state(cfg, tcfg,
                             torch.Generator().manual_seed(W.STEP_SEED),
                             "cpu")
    state, m = step_fn(state, W.model_batch(cfg.vocab))
    assert float(m["grad_norm"]) > tcfg.opt.grad_clip   # the clip acts
    want = [p.numpy() for p in pt.leaves(state["params"])]
    dims = _dims(ranks, layout)
    for group in _groups(layout):
        w = len(group)
        for pos, r in enumerate(group):
            got = _of(ranks, r, f"step_{layout}")
            assert int(got["missing"]) == 0
            assert float(got["grad_norm"]) == pytest.approx(
                float(m["grad_norm"]), rel=1e-6)
            for i, wl in enumerate(want):
                ref = _block(wl, pos, w, dims[i])
                np.testing.assert_allclose(got[f"param{i}"], ref, rtol=0,
                                           atol=1e-6, err_msg=str(i))


def test_train_driver_over_ranks_matches_one_process(ranks):
    """``launch.train --production-mesh`` over 4 ranks (EP 16, 4 of the
    16 experts a rank): every loss and grad norm within 1e-5 relative of
    the one-process run; no gradient missing; the first step's
    replicated gradients equal on every rank."""
    one = ranks["one"]
    assert one["ep"] == 16 and one["world"] == 1
    digests = []
    for r in range(4):
        got = _of(ranks, r, "train")
        assert got["rank_world"].tolist() == [r, 4]
        assert int(got["ep"]) == 16 and int(got["missing"]) == 0
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=1e-5)
        digests.append(got["digest_replicated"].tolist())
    assert digests[0] and all(d == digests[0] for d in digests)


def test_checkpoint_from_ranks_resumes_in_one_process(ranks, tmp_path):
    """The 4 ranks' checkpoint (written whole by rank 0) after step 2
    resumes in one process, whose steps 3 and 4 are within 1e-5 of the
    uninterrupted run's."""
    assert ranks["error"] is None, ranks["error"]
    src = ranks["tmp"] / "ckpt_ranks"
    assert sorted(p.name for p in src.iterdir()) == ["step_000002",
                                                     "step_000004"]
    shutil.copytree(src, tmp_path / "ckpt")
    shutil.rmtree(tmp_path / "ckpt" / "step_000004")
    res = _one_process_train(W.TRAIN_ARGV + ["--resume", "--ckpt",
                                             str(tmp_path / "ckpt")])
    assert res["start"] == 3
    np.testing.assert_allclose(res["losses"], ranks["one"]["losses"][3:],
                               rtol=1e-5)


def test_checkpoint_from_one_process_resumes_over_ranks(ranks):
    """The one-process checkpoint after step 2 resumes over the 4 ranks
    (each cutting its experts), whose steps 3 and 4 are within 1e-5 of
    the uninterrupted run's."""
    for r in range(4):
        got = _of(ranks, r, "train")
        assert int(got["resumed/start"]) == 3
        np.testing.assert_allclose(got["resumed/losses"],
                                   ranks["one"]["losses"][3:], rtol=1e-5)
