"""The data axis over ``torch.distributed`` ranks: the batch split over
data ranks, the train state sharded over them as the reference's
``state_specs`` place it (FSDP), and the serve's rows a data rank.

One module fixture spawns 4 gloo ranks on the CPU once
(``parallel.dist.spawn``: a ``file://`` rendezvous in the test's own
directory, a limit on the join; a rank that fails or outlasts it ends
them all, and every case then fails) running
``tests/_torch_rank_data_worker.py``, which imports no JAX, in two
layouts of a (data 4, model 2) mesh: 4 data ranks (``d4``) and 2 data x
2 model ranks (``d2m2``), over the fp32 smoke configs of one model of
every family (qwen3-1.7b, deepseek-moe-16b, mamba2-2.7b,
recurrentgemma-2b, llava-next-mistral-7b, seamless-m4t-medium; llava's
and seamless's batches carry the training driver's seeded patch and
frame stand-ins); beside the ranks one subprocess runs the reference's
``build_train_step`` on an ``Auto`` (4, 2) mesh of 8 CPU devices with
the state placed by its ``state_specs``
(``tests/_torch_data_reference.py``) on the port's parameters.  Held:

* a rank's coordinates are row-major over the ranked axes (data-major);
* ``gather_block``'s backward gives this rank's block of the summed
  gradient, ``reduce_scatter`` its block of the sum, and a leaf held
  whole along data comes out the same on every rank after its sum;
* a rank's draw equals ``convert.rank_state`` of the whole draw, and its
  parameter bytes are the whole tree's with each data-sharded leaf
  divided by the data ranks (and each leaf held as a model block, the
  experts' and, over 2 x 2, the tensor-parallel ones, by the model
  ranks);
* ``value_and_grad`` (the step's ``grads_of``), with and without remat:
  the data ranks' loss shares sum to the one-process loss within 1e-6
  relative, every gradient leaf by its block within 1e-6 x its largest
  magnitude of the one-process mesh (1e-5 over 2 x 2, whose model ranks
  are tensor parallel) and within 2e-4 x max + 1e-6 of the reference's,
  no leaf missed (a leaf whose exact gradient is zero held to zero,
  :func:`check_leaf`); a batch the data axis does not divide (rows
  replicated along data) gives the one-process gradients;
* the collectives of one ``grads_of`` equal :func:`collectives_per_step`;
* one train step with fp32 and with int8 m and v matches the
  one-process step (grad norm within 1e-6 relative, every parameter
  within 1e-6); every model's fp32 state checkpointed over 4 data ranks
  holds the ranks' blocks bit for bit and restores in one process and
  over 2 x 2;
* every model's serve of a rank's rows (a prefill and teacher-forced
  decode steps) within 1e-5 (prefill) and 1e-4 (decode) of the scale of
  one process's rows, argmaxes equal, its cache the rank's share;
* ``launch.train --data-ranks`` over both layouts matches one process
  within 1e-5; checkpoints cross layouts (4 data ranks -> 2 x 2 and one
  process, one process -> 4 data ranks) and continue within 1e-5;
* ``launch.serve --data-ranks 4`` gives the one-process run's ids, its
  logits within 1e-5.
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

import _torch_rank_data_worker as W  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 240
N_RANKS = {"d4": {"data": 4, "model": 1}, "d2m2": {"data": 2, "model": 2}}
# a gradient block against one process, x the leaf's largest magnitude:
# over model ranks the tensor-parallel sums reorder reductions
GRAD_TOL = {"d4": 1e-6, "d2m2": 1e-5}
PREFILL_TOL = 1e-5       # a serve's prefill logits, x their scale
DECODE_TOL = 1e-4        # its decode's logits over the bf16 cache


def _write_params(tmp):
    """The port's draw of each model (seed 0) as ``params/...`` arrays,
    the reference's parameter layout, and the model case's frontend
    embeddings as ``batch/...`` arrays."""
    from repro_torch.models import lm
    out = {}
    for arch in W.ARCHS:
        cfg = W.model_config(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
        embeds = {k: v for k, v in W.model_batch(cfg).items()
                  if k not in ("tokens", "labels")}
        np.savez(tmp / f"{arch}_in.npz", **W.arrays_of(params, "params/"),
                 **W.arrays_of(embeds, "batch/"))
        out[arch] = params
    return out


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
    from repro_torch.launch import serve
    from repro_torch.parallel import dist as pd
    tmp = tmp_path_factory.mktemp("ranks_data")
    params = _write_params(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_data_reference.py"),
         str(tmp)], cwd=str(ROOT), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    # the uninterrupted one-process run; its checkpoint after step 2 is
    # the one the 4 data ranks resume from
    one = _one_process_train(W.TRAIN_ARGV + ["--ckpt",
                                             str(tmp / "ckpt_one")])
    shutil.rmtree(tmp / "ckpt_one" / "step_000004")
    served = serve.main(W.SERVE_ARGV + ["--logits-out",
                                        str(tmp / "serve_one.npz")])
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


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_coordinates_are_row_major_data_first(ranks, layout):
    """Rank r of {"data": 2, "model": 2} sits at (r // 2, r % 2); of 4
    data ranks at (r, 0)."""
    for r in range(4):
        want = (r // 2, r % 2) if layout == "d2m2" else (r, 0)
        assert _coords(ranks, layout, r) == want


# ------------------------------------------------------------- the moves

@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_gather_block_carries_the_summed_gradient(ranks, layout):
    """``gather_block`` gives the data ranks' blocks in rank order; its
    backward under each data rank's own share ``c_d`` of the loss gives
    this rank's block of ``sum_d c_d``; ``reduce_scatter`` gives its
    block of the sum over the data ranks."""
    n = N_RANKS[layout]["data"]
    own = [torch.randn(2, 3, generator=torch.Generator().manual_seed(
        30 + c)).numpy() for c in range(n)]
    for r in range(4):
        got = _of(ranks, r, f"moves_{layout}")
        c = _coords(ranks, layout, r)[0]
        peers = [q for q in range(4)
                 if _coords(ranks, layout, q)[1]
                 == _coords(ranks, layout, r)[1]]
        for dim in (0, 1):
            np.testing.assert_array_equal(got[f"gather{dim}/y"],
                                          np.concatenate(own, dim))
            shares = [torch.randn(
                (2 * n, 3) if dim == 0 else (2, 3 * n),
                generator=torch.Generator().manual_seed(60 + q)).numpy()
                for q in range(n)]
            total = sum(shares)
            want = (total[2 * c:2 * c + 2] if dim == 0
                    else total[:, 3 * c:3 * c + 3])
            np.testing.assert_allclose(got[f"gather{dim}/g"], want,
                                       rtol=1e-6, atol=1e-6)
        total = sum(_of(ranks, q, f"moves_{layout}")["rs/x"] for q in peers)
        np.testing.assert_allclose(got["rs/y"], total[4 * c:4 * c + 4],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_replicated_leaves_sum_over_the_data_ranks(ranks, layout):
    """The step's sum of a leaf held whole along data: the same on every
    rank of a data sub-group, the sum of their shares; a data block's
    gradient untouched."""
    for r in range(4):
        got = _of(ranks, r, f"moves_{layout}")
        peers = [q for q in range(4)
                 if _coords(ranks, layout, q)[1]
                 == _coords(ranks, layout, r)[1]]
        want = sum(_of(ranks, q, f"moves_{layout}")["sum/b_in"]
                   for q in peers)
        np.testing.assert_allclose(got["sum/b"], want, rtol=1e-6)
        np.testing.assert_array_equal(got["sum/a"], got["sum/a_in"])
        np.testing.assert_array_equal(
            got["sum/b"], _of(ranks, peers[0], f"moves_{layout}")["sum/b"])


# ----------------------------------------------------- the state and draw

@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_rank_draw_equals_rank_state_of_the_whole_draw(ranks, layout,
                                                       arch):
    """``init_train_state(..., mesh=)`` equals ``convert.rank_state`` of
    the whole draw leaf for leaf (parameters, int8 m and v blocks, error
    feedback); a rank's parameter bytes are the whole tree's with each
    data-sharded leaf divided by the data ranks (an expert leaf also by
    the model ranks)."""
    from repro_torch import tree as pt
    whole = pt.leaves(ranks["params"][arch])
    dims = _dims(ranks, layout, arch)
    want = sum(p.numel() * p.element_size()
               // np.prod([N_RANKS[layout][a] for a in d] or [1])
               for p, d in zip(whole, dims))
    assert any("data" in d for d in dims)
    for r in range(4):
        got = _of(ranks, r, f"draw_{layout}_{arch}")
        assert bool(got["same_tree"]) and got["equal"].all()
        assert int(got["param_bytes"]) == want


# --------------------------------------------------------- the gradients

def _one_process_grads(params, arch, remat, b=W.MODEL["b"]):
    from repro_torch import tree as pt
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.train.step import value_and_grad
    cfg = W.model_config(arch)
    ctx = make_ctx(_mesh(), cfg)
    loss, grads, missing = value_and_grad(
        lambda p, bt: lm.train_loss(p, bt, cfg, ctx, remat=remat,
                                    loss_chunk=W.MODEL["loss_chunk"]),
        params, W.model_batch(cfg, b))
    assert missing == 0
    return float(loss), [g.numpy() for g in pt.leaves(grads)]


@pytest.fixture(scope="module")
def one_grads(ranks):
    return {(arch, remat, b): _one_process_grads(ranks["params"][arch],
                                                 arch, remat, b)
            for arch in W.ARCHS for remat, b in ((False, W.MODEL["b"]),
                                                 (True, W.MODEL["b"]),
                                                 (False, W.ODD_B))}


# leaves whose exact gradient is zero: the cross-attention's key bias (a
# query's softmax does not see one shift of every key's logit; no rope
# there), so both sides give rounding noise, held to zero
ZERO_GRAD = ("x_bk",)


def check_leaf(g, ref, wl, path, tol, want):
    """A gradient block ``g`` against the one-process block ``ref`` of
    the whole leaf ``wl`` (at key ``path``): within ``tol`` x ``wl``'s
    largest magnitude, or, for a :data:`ZERO_GRAD` leaf, both zero
    within ``tol`` x the largest magnitude of every leaf of ``want``."""
    assert g.shape == ref.shape, path
    if path[-1] in ZERO_GRAD:
        bound = tol * max(float(np.abs(w).max()) for w in want)
        assert float(np.abs(g).max()) <= bound, (path, g)
        assert float(np.abs(wl).max()) <= bound, (path, wl)
        return
    err = float(np.abs(g - ref).max())
    assert err <= tol * float(np.abs(wl).max()), (path, err)


def _check_grads(ranks, layout, arch, key, want, loss, rtol_share):
    dims = _dims(ranks, layout, arch)
    paths = list(_paths(ranks["params"][arch]))
    shares = {}
    for r in range(4):
        got = _of(ranks, r, f"grads_{layout}_{arch}")
        c = _coords(ranks, layout, r)
        assert int(got[f"{key}/missing"]) == 0
        # the global loss: the data ranks' shares all-reduced
        assert float(got[f"{key}/loss"]) == pytest.approx(loss, rel=1e-6)
        shares.setdefault(c[0], float(got[f"{key}/share"]))
        n = sum(k.startswith(f"{key}/grad") for k in got)
        assert n == len(want) == len(dims)
        for i, wl in enumerate(want):
            check_leaf(got[f"{key}/grad{i}"], _block(wl, dims[i], layout, c),
                       wl, paths[i], GRAD_TOL[layout], want)
    assert sum(shares.values()) == pytest.approx(loss, rel=rtol_share)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_grads_over_data_ranks_match_one_process(ranks, one_grads, layout,
                                                 arch, remat):
    """The data ranks' loss shares sum to the one-process loss within
    1e-6 relative; every gradient leaf, by this rank's block, is within
    1e-6 x its largest magnitude of the one-process mesh's (1e-5 over
    2 x 2: :data:`GRAD_TOL`); no leaf missed."""
    loss, want = one_grads[(arch, remat, W.MODEL["b"])]
    _check_grads(ranks, layout, arch, f"remat{int(remat)}", want, loss,
                 1e-6)


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_batch_the_data_axis_does_not_divide(ranks, one_grads, layout,
                                             arch):
    """2 rows on a data axis of 4: every data rank takes both rows (its
    share a quarter of their loss) and the summed gradients are the
    one-process ones."""
    loss, want = one_grads[(arch, False, W.ODD_B)]
    _check_grads(ranks, layout, arch, "remat0_odd", want, loss, 1e-6)


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_grads_over_data_ranks_match_the_reference(ranks, layout, arch):
    """Every gradient block over data ranks is within 2e-4 of the leaf's
    largest magnitude + 1e-6 of the reference's ``jax.value_and_grad``
    under its ``build_train_step`` context on an ``Auto`` (4, 2) mesh
    with the state placed by ``state_specs``; the loss within 1e-5
    relative; no leaf missed (the leaf counts equal)."""
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
            assert err <= 2e-4 * float(np.abs(wl).max()) + 1e-6, (i, err)


STACKS = ("blocks", "enc_blocks", "dec_blocks")


def collectives_per_step(cfg, top, remat, layout, chunks=1):
    """The collectives one ``grads_of`` issues on a rank of ``cfg``, by
    axis.  A forward run of a layer is its forward and, under remat,
    its rerun in the backward (the hybrid family's layers are never
    checkpointed: one run); a rerun stops at the layer's last saved
    tensor, before its last sum.  Along data: each run packs a layer's
    data-sharded leaves (one dtype) into one all-gather and the backward
    reduce-scatters them once (each an ``all_to_all``); the encdec
    decoder's cross-attention K/V leaves are gathered once more a layer
    outside its checkpoint (``lm._cross_kv``) and reduce-scattered; the
    top-level ones (``top``: embed, head) are gathered and
    reduce-scattered once; one ``all_reduce`` of the loss's mask count,
    one of the gradients held whole along data, one of the reported
    loss.  A moe layer adds its ``aux`` all-reduce in every run (over
    data, or the world where the model axis is ranked too) and the sum
    of its gradient over data in the backward; with model ranks its
    exchanges (2 ``all_to_all``s and the token blocks' all-gather a run,
    2 ``all_to_all``s and the two block slices' all-gathers in the
    backward) run over model.  With model ranks (``d2m2``) tensor
    parallelism adds over model, a layer, three calls a run
    (self-attention: q, k and v gathered in one, the sums of ``wo``'s
    and of the FFN's partial products; Mamba2: its ``w_in`` output and
    ``w_conv`` gathered in one, the sums of the gated norm's squares and
    of ``w_out``'s products; RG-LRU: its conv output gathered, the sums
    of ``w_out``'s and of the FFN's products; an encdec decoder layer
    four, with the cross-attention's ``x_wo`` sum) and three in the
    backward (four for a decoder layer: the sums of each entered input's
    partial gradients, the gathers' reduce-scatter); a decoder layer's
    cross K/V gathered and reduce-scattered, and the encoder output's
    gradient summed once; once a step the embedding's sum, two a loss
    chunk (the ranks' maxima, the ``exp`` sums and target logits) again
    where its checkpoint recomputes it, the sum of the final hidden
    state's partial gradients and, with qk norms, the sum of their
    gradients."""
    n, moe = cfg.n_layers, cfg.family == "moe"
    runs = 2 if remat and cfg.family != "hybrid" else 1
    encdec = cfg.family == "encdec"
    stack = n + (cfg.n_enc_layers if encdec else 0)
    out = {"all_to_all.data_calls": stack * (runs + 1)
           + (2 * n if encdec else 0) + (2 if top else 0),
           "all_reduce.data_calls": 3 + (n if moe else 0)}
    if moe and layout == "d4":
        out["all_reduce.data_calls"] += n * runs
    if layout in ("d2m2", "m4"):
        out["all_to_all.model_calls"] = stack * (3 * runs - (runs - 1) + 3) \
            + 1 + 4 * chunks + 1 + (1 if cfg.qk_norm else 0)
        if encdec:          # the cross-attention's sum each way, its K/V
            out["all_to_all.model_calls"] += n * (runs + 1 + 2) + 1
    if moe and layout == "d2m2":
        out["all_reduce.world_calls"] = n * runs
    if moe and layout in ("d2m2", "m4"):
        out["all_to_all.model_calls"] += n * (3 * runs + 4)
    if layout == "m4":
        del out["all_to_all.data_calls"], out["all_reduce.data_calls"]
        if moe:
            out["all_reduce.model_calls"] = n * runs
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_collectives_a_step_follow_the_formula(ranks, layout, arch, remat):
    """Every rank counts :func:`collectives_per_step`'s calls, and no
    other collective."""
    from repro_torch import tree as pt
    cfg = W.model_config(arch)
    dims = _dims(ranks, layout, arch)
    keys = list(_paths(ranks["params"][arch]))
    assert len(keys) == len(pt.leaves(ranks["params"][arch]))
    assert any("data" in d for d, k in zip(dims, keys) if k[0] in STACKS)
    top = any("data" in d for d, k in zip(dims, keys)
              if k[0] not in STACKS)
    want = collectives_per_step(cfg, top, remat, layout)
    tag = f"remat{int(remat)}"
    for r in range(4):
        got = _of(ranks, r, f"grads_{layout}_{arch}")
        calls = {k[len(tag) + 6:]: int(v) for k, v in got.items()
                 if k.startswith(f"{tag}/coll/") and "." in k
                 and k.endswith("_calls")}
        assert calls == want, (r, calls, want)


def _paths(tree, path=()):
    """Each leaf's key path (a list's index an int), in JAX's leaf
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path


# ------------------------------------------------------------- the steps

@pytest.mark.parametrize("tier", ["float32", "int8"])
@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_train_step_over_data_ranks_matches_one_process(ranks, layout, arch,
                                                        tier):
    """One step of AdamW with the global-norm clip, fp32 or int8 m and v
    (an int8 state whole along data where a rank's width is not whole
    blocks): the grad norm within 1e-6 relative of the one-process
    step's, every parameter block within 1e-6, no gradient missing."""
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
            float(m["grad_norm"]), rel=1e-6)
        for i, (wl, d) in enumerate(zip(want, dims)):
            np.testing.assert_allclose(got[f"{tier}/param{i}"],
                                       _block(wl, d, layout, c), rtol=0,
                                       atol=1e-6, err_msg=str(i))


@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_train_driver_over_data_ranks_matches_one_process(ranks, layout):
    """``launch.train --production-mesh --data-ranks`` (deepseek at smoke
    width, 16 experts): every rank reports the same losses and grad
    norms, each within 1e-5 relative of the one-process run's; no
    gradient missing; the record names the layout."""
    one = ranks["one"]
    want = {"d4": "{'data': 4}", "d2m2": "{'data': 2, 'model': 2}"}[layout]
    for r in range(4):
        got = _of(ranks, r, f"train_{layout}")
        assert got["rank_world"].tolist() == [r, 4]
        assert str(got["layout"]) == want
        assert int(got["missing"]) == 0
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(
            got["losses"], _of(ranks, 0, f"train_{layout}")["losses"])


def test_checkpoint_from_data_ranks_resumes_over_2x2_and_in_one_process(
        ranks, tmp_path):
    """The 4 data ranks' checkpoint after step 2 (written whole by rank 0)
    resumes over 2 data x 2 model ranks and in one process; both
    continue within 1e-5 of the uninterrupted run."""
    assert ranks["error"] is None, ranks["error"]
    want = ranks["one"]["losses"][3:]
    for r in range(4):
        got = _of(ranks, r, "train_d2m2")
        assert int(got["resumed/start"]) == 3
        np.testing.assert_allclose(got["resumed/losses"], want, rtol=1e-5)
    src = ranks["tmp"] / "ckpt_d4"
    assert sorted(p.name for p in src.iterdir()) == ["step_000002",
                                                     "step_000004"]
    shutil.copytree(src, tmp_path / "ckpt")
    shutil.rmtree(tmp_path / "ckpt" / "step_000004")
    res = _one_process_train(W.TRAIN_ARGV + ["--resume", "--ckpt",
                                             str(tmp_path / "ckpt")])
    assert res["start"] == 3
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)


def test_checkpoint_from_one_process_resumes_over_data_ranks(ranks):
    """The one-process checkpoint after step 2 resumes over the 4 data
    ranks (each cutting its blocks), whose steps 3 and 4 are within 1e-5
    of the uninterrupted run's."""
    for r in range(4):
        got = _of(ranks, r, "train_d4")
        assert int(got["resumed/start"]) == 3
        np.testing.assert_allclose(got["resumed/losses"],
                                   ranks["one"]["losses"][3:], rtol=1e-5)


def check_checkpoint(ranks, arch, layouts, of, coords, dims, block):
    """The fp32 step's state in the first of ``layouts``, checkpointed
    (rank 0 writes the whole state), holds every rank's parameter blocks
    bit for bit; it restores in one process and in the second layout,
    each rank of which gets its blocks of it bit for bit (``of``,
    ``coords``, ``dims`` and ``block``: the test module's readers of the
    ranks' records)."""
    from repro_torch import tree as pt
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import init_train_state
    cfg = W.model_config(arch)
    first, second = layouts
    like = init_train_state(cfg, TrainConfig(), torch.Generator(), "cpu")
    got, _ = CheckpointManager(ranks["tmp"] / f"ckpt_{arch}_{first}"
                               ).restore(like)
    whole = [p.numpy() for p in pt.leaves(got["params"])]
    for layout, key in ((first, "float32/param"), (second,
                                                   "restored/param")):
        for r in range(4):
            rec = of(ranks, r, f"step_{layout}_{arch}")
            c = coords(ranks, layout, r)
            for i, (w, d) in enumerate(zip(whole, dims(ranks, layout,
                                                       arch))):
                np.testing.assert_array_equal(rec[f"{key}{i}"],
                                              block(w, d, layout, c),
                                              err_msg=f"{layout} {r} {i}")


@pytest.mark.parametrize("arch", W.ARCHS)
def test_checkpoint_of_every_family_crosses_layouts(ranks, arch):
    """The fp32 step's state over 4 data ranks, checkpointed, holds every
    rank's blocks; it restores in one process and over 2 x 2 ranks
    (:func:`check_checkpoint`)."""
    check_checkpoint(ranks, arch, list(W.LAYOUTS), _of, _coords, _dims,
                     _block)


def _rank_cache(cfg, shapes, n, rows):
    """A model rank's decode cache shapes among ``n`` model ranks, serving
    ``rows`` rows, from one process's ``shapes``: the KV heads its q
    heads read (``k``, ``v``, ``cross_k``, ``cross_v``), its Mamba2 heads
    (``state``) and the channels its conv reads (its heads' x and every
    B and C), its block of RG-LRU's width (``hrec``, ``conv``), as the
    model axis's 4 shards split them."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    out = {}
    for key, shape in shapes.items():
        shape = list(shape)
        shape[1] = rows
        if key in ("k", "v", "cross_k", "cross_v"):
            shape[3] = max(1, hkv * (hq // n) // hq) if hq % 4 == 0 \
                else hkv
        elif key == "state":
            shape[2] //= n
        elif key == "conv" and cfg.family == "ssm":
            shape[3] = cfg.d_inner // n + 2 * cfg.ssm_state
        elif key in ("hrec", "conv"):
            shape[-1] //= n
        out[key] = tuple(shape)
    return out


def _close(got, want):
    """The prefill's logits within :data:`PREFILL_TOL` of their scale, the
    decode's within :data:`DECODE_TOL`; the argmax of every row equal."""
    scale = float(np.abs(want).max())
    assert float(np.abs(got[0] - want[0]).max()) <= PREFILL_TOL * scale
    assert float(np.abs(got - want).max()) <= DECODE_TOL * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _close(got, want):
    """The prefill's logits within :data:`PREFILL_TOL` of their scale, the
    decode's within :data:`DECODE_TOL`; the argmax of every row equal."""
    scale = float(np.abs(want).max())
    assert float(np.abs(got[0] - want[0]).max()) <= PREFILL_TOL * scale
    assert float(np.abs(got - want).max()) <= DECODE_TOL * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def one_serves():
    return {arch: W.serve_run(_mesh(), W.model_config(arch))
            for arch in W.ARCHS}


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("layout", list(W.LAYOUTS))
def test_serve_of_every_family_over_data_ranks_matches_one_process(
        ranks, one_serves, layout, arch):
    """A prefill and teacher-forced decode steps of each data rank's rows
    of 4 (one a rank over 4 data ranks, 2 over 2 x 2, whose 2 model
    ranks are tensor parallel) within the serve tolerances of one
    process's rows, every argmax equal; each rank's cache holds its
    rows and, over model ranks, its share (:func:`_rank_cache`)."""
    want, shapes = one_serves[arch]
    cfg = W.model_config(arch)
    n = N_RANKS[layout]["model"]
    for r in range(4):
        got = _of(ranks, r, f"mserve_{layout}_{arch}")
        assert len(got["rows"]) == 4 // N_RANKS[layout]["data"]
        cache = {k[len("cache/"):]: tuple(int(i) for i in v)
                 for k, v in got.items() if k.startswith("cache/")}
        assert cache == _rank_cache(cfg, shapes, n, len(got["rows"])), r
        _close(got["logits"], want[:, got["rows"]])


# ------------------------------------------------------------- the serve

def test_serve_over_data_ranks_matches_one_process(ranks):
    """``launch.serve --data-ranks 4`` (qwen3 at smoke width, batches of
    16 over data 16: 4 rows a rank): every rank returns the one-process
    run's generated ids; the gathered prefill and decode logits are
    within 1e-5 of the one-process run's."""
    one = ranks["served"]
    want = np.load(ranks["tmp"] / "serve_one.npz")
    got_logits = np.load(ranks["tmp"] / "serve_d4.npz")
    for r in range(4):
        got = _of(ranks, r, "serve")
        assert str(got["layout"]) == "{'data': 4}" and bool(got["finite"])
        np.testing.assert_array_equal(got["generated"], one["generated"])
    np.testing.assert_array_equal(got_logits["inputs"], want["inputs"])
    scale = float(np.abs(want["logits"]).max())
    assert float(np.abs(got_logits["logits"] - want["logits"]).max()) \
        <= 1e-5 * scale



# ---------------------------------------------------- chip_smoke's phase

SMALL = {"train": dict(steps=2, batch=16, seq=32),
         "serve": dict(requests=16, batch=16, prompt=16, gen=3),
         "moe_rows": (16, 32)}


def test_chip_smoke_data_ranks_phase_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 7e rehearsed on the CPU at smoke sizes:
    the one-process references, 4 ranks of ``rank_data_main`` (Qwen3 over
    4 data ranks, its serve teacher-forced, deepseek and the ``moe_ffn``
    check over 2 x 2) and the parent's checks all pass; the same records
    with one rank's loss moved past its tolerance, its parameter bytes
    off by one, or rank 0's serve logits off the witness (its rows served
    alone), or every deepseek route of a rank flipped, fail the checks;
    and so do Mamba2's records over 4 data ranks with a rank's parameter
    bytes off by one or its step-0 loss moved.
    Deepseek's routes flip against one process over 2 x 2 (tensor
    parallel, bf16): counted, a few of a rank's."""
    import copy

    from repro_torch import kernels as K
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    ref_counts, launches, got = cs.data_ranks_phase(torch.device("cpu"), K,
                                                    small=SMALL)
    ref, recs = got["ref"], got["recs"]
    assert all(r["moe_check"]["result"]["bit_equal"] for r in recs)
    assert recs[0]["serve_logits"]["rel_err"] < 1e-5
    assert recs[0]["serve_logits"]["witness_rows"] == 4
    assert recs[0]["serve_logits"]["witness_bit_equal"]
    # deepseek's 2 model ranks are tensor parallel: their row-parallel
    # bf16 sums move a gate across a route's margin here and there (2-6
    # of 256 routes a rank); the flips are counted and printed, and a
    # rank whose router input went wrong would flip most of them
    assert all(r["deepseek"]["result"]["routes"] == 256
               and r["deepseek"]["result"]["flipped_routes"] <= 16
               for r in recs)
    cs.data_ranks_checks(K, ref, recs, SMALL)
    bad = copy.deepcopy(recs)
    for rec in bad:
        rec["train"]["result"]["losses"][0] *= 1 + 2 * cs.DATA_LOSS0_TOL
    with pytest.raises(AssertionError):
        cs.data_ranks_checks(K, ref, bad, SMALL)
    for path in ("train", "mamba2"):
        bad = copy.deepcopy(recs)
        bad[2][path]["result"]["param_bytes"] += 1
        with pytest.raises(AssertionError):
            cs.data_ranks_checks(K, ref, bad, SMALL)
    bad = copy.deepcopy(recs)
    for rec in bad:
        rec["mamba2"]["result"]["losses"][0] *= 1 + 2 * cs.DATA_LOSS0_TOL
    with pytest.raises(AssertionError):
        cs.data_ranks_checks(K, ref, bad, SMALL)
    bad = copy.deepcopy(recs)
    bad[0]["serve_logits"]["witness_bit_equal"] = False
    with pytest.raises(AssertionError):
        cs.data_ranks_checks(K, ref, bad, SMALL)
    bad = copy.deepcopy(recs)
    ds = bad[3]["deepseek"]["result"]
    ds["flipped_routes"] = ds["routes"]
    with pytest.raises(AssertionError):
        cs.data_ranks_checks(K, ref, bad, SMALL)
