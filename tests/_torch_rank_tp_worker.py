"""What each ``torch.distributed`` rank of ``tests/test_torch_ranks_tp.py``
runs, importing no JAX.

:func:`main` joins a gloo group on the CPU through a ``file://``
rendezvous and runs every case once in each layout of :data:`LAYOUTS`
over the (data 2, model 4) mesh :data:`MESH`: 4 model ranks (``m4``:
tensor parallelism, each rank one model shard) and 2 data x 2 model
ranks (``d2m2``: each rank a data block and two model shards):

* ``draw``: a rank's train state drawn with ``mesh=`` (int8 m and v and
  the error feedback) against ``convert.rank_state`` of the whole draw,
  and the rank's parameter and state bytes;
* ``grads``: the fp32 smoke models' (qwen3-1.7b and deepseek-moe-16b)
  ``grads_of`` on the parameters the test wrote, cut to the rank's
  blocks, with and without remat: the loss, every gradient block, the
  leaves missed, the replicated gradients' digests, the digests of
  every moe router input, the collectives by axis;
* ``step``: one train step with fp32 and with int8 m and v from a state
  drawn with ``mesh=``: the grad norm and the parameter blocks;
* ``serve``: ``build_serve_step`` on :data:`MESH` (Hq 4 on model 4: each
  rank its heads), a prefill and teacher-forced decode steps of the
  rank's rows: the logits and the KV heads of the rank's cache;
* ``policy`` (qwen3): ``ShardingPolicy(tp_enable=False)``: the leaves'
  rank dims, the loss and every gradient;
* ``train``: ``launch.train --production-mesh`` at smoke width
  (deepseek, 16 experts, fp32), writing checkpoints, and resuming from
  the checkpoint the test or the other layout wrote;
* ``pserve`` (``m4`` only): ``launch.serve --production-mesh`` of the
  qwen3 smoke model (Hq 4 on 16 model shards: q gathered whole), its
  logits kept.

Each rank writes what it saw to ``rank<r>.npz`` in the test's directory.
"""

import hashlib
import pathlib
import shutil

import numpy as np
import torch

from _torch_rank_data_worker import load_params

ARCHS = ("qwen3-1.7b", "deepseek-moe-16b")
MESH = {"data": 2, "model": 4}
LAYOUTS = {"m4": {"model": 4}, "d2m2": {"data": 2, "model": 2}}
MODEL = dict(b=4, s=16, loss_chunk=16, seed=11)
POLICY_B = 8                       # rows of the policy case: 8 shards
STEP_SEED = 21
SERVE = dict(b=4, prompt=8, gen=3, seed=13)
TRAIN_ARCH = "deepseek-moe-16b"
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--smoke", "--device", "cpu",
              "--production-mesh", "--steps", "5", "--batch", "4",
              "--seq", "32", "--lr", "3e-3", "--log-every", "1",
              "--ckpt-every", "3"]
PSERVE_ARGV = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
               "--production-mesh", "--requests", "4", "--batch", "4",
               "--prompt-len", "16", "--gen", "3"]


def model_config(arch):
    """The model cases' config: the smoke one in fp32."""
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(dtype="float32")


def driver_config(cfg):
    """The drivers' config from the smoke one: enough experts for 16
    model shards, in fp32."""
    return cfg.replace(n_experts=16, dtype="float32")


def model_batch(vocab, b=MODEL["b"]):
    rng = np.random.default_rng(MODEL["seed"])
    toks = rng.integers(0, vocab, (b, MODEL["s"] + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]).long(),
            "labels": torch.from_numpy(toks[:, 1:]).long()}


def serve_tokens(vocab):
    """The serve case's prompts [b, prompt] and teacher inputs [b, gen]."""
    rng = np.random.default_rng(SERVE["seed"])
    toks = rng.integers(0, vocab, (SERVE["b"], SERVE["prompt"]
                                   + SERVE["gen"]))
    toks = torch.from_numpy(toks.astype(np.int32))
    return toks[:, :SERVE["prompt"]], toks[:, SERVE["prompt"]:]


def serve_run(mesh, cfg, rows=None):
    """``build_serve_step`` on ``mesh``: this rank's rows (or ``rows``) of
    the prompts prefilled, then a decode step for each teacher input.
    Returns the logits [gen + 1, rows, V] and the cache's KV heads."""
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import data_rows, expert_block
    from repro_torch.train.step import build_serve_step, rank_cut
    step, prefill, ctx = build_serve_step(cfg, mesh)
    block = expert_block(cfg, ctx)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            **({"experts": block} if block else {}),
                            cut=rank_cut(cfg, mesh, (ctx.tp_axis,)))
    prompts, feed = serve_tokens(cfg.vocab)
    b = prompts.shape[0]
    if rows is None:
        rows = data_rows(mesh, b)
    split = len(rows) < b and mesh.ranked
    rows = torch.from_numpy(np.asarray(rows))
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": prompts[rows]},
                                data_block=split)
        cache = grow_cache(cfg, cache, SERVE["prompt"] + SERVE["gen"])
        out = [logits]
        for i in range(SERVE["gen"]):
            logits, cache = step(params, cache, feed[rows, i:i + 1],
                                 data_block=split)
            out.append(logits)
    return torch.stack(out).numpy(), int(cache["k"].shape[-2])


def _digest(t) -> str:
    t = t.detach().contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def _draw(mesh, arch):
    """A rank's train state drawn with ``mesh=`` against ``rank_state``
    of the whole draw, leaf for leaf, and its parameter and state
    bytes."""
    from repro_torch import convert
    from repro_torch import tree as pt
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.sharding import expert_block, make_ctx
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import (init_train_state, state_shapes,
                                        state_specs)
    cfg = model_config(arch)
    tcfg = TrainConfig(compress_grads=True, opt=AdamWConfig(
        m_dtype="int8", v_mode="int8"))
    block = expert_block(cfg, make_ctx(mesh, cfg))
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    mine = init_train_state(cfg, tcfg, gen(), "cpu", experts=block,
                            mesh=mesh)
    whole = init_train_state(cfg, tcfg, gen(), "cpu")
    specs = state_specs(mesh, state_shapes(cfg, tcfg), tcfg)
    cut = convert.rank_state(whole, mesh, specs, family=cfg.family)
    a, spec_a = pt.flatten(mine)
    b, spec_b = pt.flatten(cut)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in pt.leaves(tree))
    return {"same_tree": np.asarray(spec_a == spec_b),
            "equal": np.asarray([x.shape == y.shape and torch.equal(x, y)
                                 for x, y in zip(a, b)]),
            "param_bytes": np.asarray(nbytes(mine["params"])),
            "state_bytes": np.asarray(nbytes(mine))}


def _grads(mesh, arch, tmp):
    from repro_torch import convert
    from repro_torch import tree as pt
    from repro_torch.core.rounds.mesh import (collective_counts,
                                              reset_collective_counts)
    from repro_torch.models import moe
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.train.step import (grad_digest, state_shapes,
                                        state_specs)
    cfg = model_config(arch)
    specs = state_specs(mesh, state_shapes(cfg, TrainConfig()),
                        TrainConfig())["params"]
    params = convert.rank_state(load_params(tmp / f"{arch}_in.npz"), mesh,
                                specs, family=cfg.family)
    routed = []
    real = moe.moe_ffn

    def seen(x, *a, **k):
        routed.append(_digest(x))
        return real(x, *a, **k)
    out = {}
    moe.moe_ffn = seen
    try:
        for remat in (False, True):
            tcfg = TrainConfig(remat=remat, loss_chunk=MODEL["loss_chunk"])
            step_fn, ctx, _ = build_train_step(cfg, mesh, tcfg)
            dims = step_fn.leaf_dims()["params"]
            tag = f"remat{int(remat)}"
            reset_collective_counts()
            del routed[:]
            loss, grads, missing = step_fn.grads_of({"params": params},
                                                    model_batch(cfg.vocab))
            for k, v in collective_counts().items():
                out[f"{tag}/coll/{k}"] = np.asarray(v)
            out[f"{tag}/loss"] = loss.numpy()
            out[f"{tag}/missing"] = np.asarray(missing)
            for i, g in enumerate(pt.leaves(grads)):
                out[f"{tag}/grad{i}"] = g.numpy()
            out[f"{tag}/digest_replicated"] = np.asarray(
                grad_digest(grads, dims)["replicated"])
            out[f"{tag}/router_in"] = np.asarray(routed)
    finally:
        moe.moe_ffn = real
    out["dims"] = np.asarray([repr(dict(d)) for d in dims])
    return out


def _step(mesh, arch):
    from repro_torch import tree as pt
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.sharding import expert_block, make_ctx
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.train.step import init_train_state
    cfg = model_config(arch)
    out = {}
    for tier in ("float32", "int8"):
        tcfg = TrainConfig(remat=True, loss_chunk=MODEL["loss_chunk"],
                           opt=AdamWConfig(m_dtype=tier, v_mode=tier))
        step_fn, _, _ = build_train_step(cfg, mesh, tcfg)
        state = init_train_state(
            cfg, tcfg, torch.Generator().manual_seed(STEP_SEED), "cpu",
            experts=expert_block(cfg, make_ctx(mesh, cfg)), mesh=mesh)
        state, m = step_fn(state, model_batch(cfg.vocab))
        out[f"{tier}/grad_norm"] = m["grad_norm"].numpy()
        out[f"{tier}/missing"] = np.asarray(m["grads_missing"])
        for i, p in enumerate(pt.leaves(state["params"])):
            out[f"{tier}/param{i}"] = p.numpy()
    return out


def _serve(mesh, arch):
    from repro_torch.parallel.sharding import data_rows
    logits, heads = serve_run(mesh, model_config(arch))
    return {"logits": logits, "kv_heads": np.asarray(heads),
            "rows": np.asarray(data_rows(mesh, SERVE["b"]))}


def _policy(mesh, tmp):
    """``ShardingPolicy(tp_enable=False)``: the model axis becomes a
    data axis (the batch's rows split over every rank), every dense leaf
    whole along it."""
    from repro_torch import convert
    from repro_torch import tree as pt
    from repro_torch.parallel.sharding import ShardingPolicy
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.train.step import state_shapes, state_specs
    arch = "qwen3-1.7b"
    cfg = model_config(arch)
    policy = ShardingPolicy(tp_enable=False)
    tcfg = TrainConfig(remat=False, loss_chunk=MODEL["loss_chunk"])
    step_fn, ctx, _ = build_train_step(cfg, mesh, tcfg, policy)
    specs = state_specs(mesh, state_shapes(cfg, tcfg), tcfg,
                        policy)["params"]
    params = convert.rank_state(load_params(tmp / f"{arch}_in.npz"), mesh,
                                specs, family=cfg.family)
    loss, grads, missing = step_fn.grads_of({"params": params}, model_batch(
        cfg.vocab, POLICY_B))
    out = {"loss": loss.numpy(), "missing": np.asarray(missing),
           "tp": np.asarray(ctx.tp is not None),
           "dims": np.asarray([repr(dict(d)) for d in
                               step_fn.leaf_dims()["params"]])}
    for i, g in enumerate(pt.leaves(grads)):
        out[f"grad{i}"] = g.numpy()
    return out


def _train(tmp, name, mesh):
    """The driver over ``name``'s layout: 4 model ranks write their
    checkpoints and resume from the one-process one; 2 x 2 ranks resume
    from the 4 model ranks' step 2."""
    from repro_torch.launch import train
    real = train.get_smoke_config
    train.get_smoke_config = lambda arch: driver_config(real(arch))
    argv = TRAIN_ARGV + ["--data-ranks", str(LAYOUTS[name].get("data", 1))]
    try:
        rec = train.main(argv + ["--ckpt", str(tmp / f"ckpt_{name}")])
        if name == "m4":
            src = tmp / "ckpt_one"
        else:
            src = tmp / "ckpt_m4_at2"
            if mesh.rank == 0:
                shutil.copytree(tmp / "ckpt_m4", src)
                shutil.rmtree(src / "step_000004")
            mesh.barrier()
        res = train.main(argv + ["--resume", "--ckpt", str(src)])
    finally:
        train.get_smoke_config = real
    return {"losses": np.asarray(rec["losses"]),
            "grad_norms": np.asarray(rec["grad_norms"]),
            "missing": np.asarray(rec["grads_missing"]),
            "layout": np.asarray(repr(rec["ranks"])),
            "param_bytes": np.asarray(rec["param_bytes"]),
            "resumed/start": np.asarray(res["start"]),
            "resumed/losses": np.asarray(res["losses"])}


def _pserve(tmp):
    from repro_torch.launch import serve
    real = serve.get_smoke_config
    serve.get_smoke_config = lambda arch: real(arch).replace(
        dtype="float32")
    try:
        res = serve.main(PSERVE_ARGV + ["--logits-out",
                                        str(tmp / "pserve_ranks.npz")])
    finally:
        serve.get_smoke_config = real
    return {"generated": res["generated"], "kv_heads": np.asarray(
        res["kv_heads"]), "param_bytes": np.asarray(res["param_bytes"]),
        "layout": np.asarray(repr(res["layout"]))}


def main(rank, world, tmp):
    import time

    from repro_torch.core.rounds import Mesh
    from repro_torch.parallel import dist as pd
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    group, dev = pd.init(init_method=f"file://{tmp / 'rendezvous'}",
                         device="cpu")
    assert world == 4 and dev.type == "cpu"
    out, secs = {}, {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        got = fn(*a)
        secs[name] = time.perf_counter() - t0
        out.update({f"{name}/{k}": v for k, v in got.items()})

    for name, ranks in LAYOUTS.items():
        mesh = Mesh(MESH, "cpu", group=group, ranks=ranks)
        out[f"coords_{name}"] = np.asarray([mesh.coord("data"),
                                            mesh.coord("model")])
        for arch in ARCHS:
            timed(f"draw_{name}_{arch}", _draw, mesh, arch)
            timed(f"grads_{name}_{arch}", _grads, mesh, arch, tmp)
            timed(f"step_{name}_{arch}", _step, mesh, arch)
            timed(f"serve_{name}_{arch}", _serve, mesh, arch)
        timed(f"policy_{name}", _policy, mesh, tmp)
        timed(f"train_{name}", _train, tmp, name, mesh)
    timed("pserve", _pserve, tmp)
    out.update({f"seconds/{k}": np.asarray(v) for k, v in secs.items()})
    np.savez(tmp / f"rank{rank}.npz", **out)
    pd.finish()
