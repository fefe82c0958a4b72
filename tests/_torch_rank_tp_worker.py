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
* ``grads``: the fp32 smoke models' (:data:`ARCHS`, one of every
  family) ``grads_of`` on the parameters the test wrote, cut to the rank's
  blocks, with and without remat: the loss, every gradient block, the
  leaves missed, the replicated gradients' digests, the digests of
  every moe router input, the collectives by axis;
* ``step``: one train step with fp32 and with int8 m and v from a state
  drawn with ``mesh=``: the grad norm and the parameter blocks; the fp32
  step's state checkpointed, and over 2 x 2 the 4 model ranks'
  checkpoint restored (``_torch_rank_data_worker.step_case``);
* ``serve``: ``build_serve_step`` on :data:`MESH` (Hq 4 on model 4: each
  rank its heads), a prefill and teacher-forced decode steps of the
  rank's rows: the logits and the shapes of the rank's cache (its KV
  heads, Mamba2 heads and conv channels, RG-LRU width block);
* ``policy`` (qwen3): ``ShardingPolicy(tp_enable=False)``: the leaves'
  rank dims, the loss and every gradient;
* ``bodies``: :func:`body_case`, one layer of each body that tensor
  parallelism reshaped, on the rank's blocks; once more over 4 model
  ranks of the production mesh (``bodies_prod``: 16 model shards, so
  Mamba2's and the cross-attention's heads stay whole on a rank and
  some of their leaves too);
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

from _torch_rank_data_worker import (ARCHS, MODEL, STEP_SEED,  # noqa
                                     load_params, model_batch, serve_case,
                                     serve_run, step_case)

MESH = {"data": 2, "model": 4}
LAYOUTS = {"m4": {"model": 4}, "d2m2": {"data": 2, "model": 2}}
POLICY_B = 8                       # rows of the policy case: 8 shards
BODY = dict(b=2, s=16, se=4, seed=17)
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
    cut = convert.rank_state(whole, mesh, specs)
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
                                specs)
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
                                                    model_batch(cfg))
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


def _layer(tree, dims, index):
    """``tree``'s leaves (requiring grad) and their model dims at
    ``index`` of a stack (an int: one layer of the stacked leaves, whose
    dims lose the layer axis) or whole (None)."""
    leaves = {k: (v if index is None else v[index]).clone()
              .requires_grad_(True) for k, v in tree.items()}
    return leaves, {k: -1 if dims is None or dims.get(k) is None
                    else dims[k] - (index is not None) for k in tree}


def body_case(mesh):
    """One layer of each body that tensor parallelism reshaped, on this
    rank's model blocks of the fp32 smoke models' parameters (seed 0),
    or whole on a mesh without ranks; each under the loss ``(y *
    c).sum()`` with a seeded ``c`` (its block where ``y`` is a rank's
    block): Mamba2's gated norm alone (the rank's heads' features:
    ``ssm._gated_norm``, its sum of squares over the ranks) and its whole
    block (``w_in``'s output gathered and cut to the rank's heads, its
    state and conv tail), RG-LRU's block (its conv output gathered), and
    the decoder's cross-attention (``lm._cross_kv``'s KV heads, the
    attention's output).  Returns the outputs, the input gradients, the
    parameter gradients and each parameter's model dim (``dim/<key>``,
    -1 where the rank holds it whole).  A leaf the rank holds whole but
    uses in part is entered as ``lm.train_loss`` enters it
    (``lm._enter_shared``), so every gradient is the whole one's block."""
    from repro_torch import convert
    from repro_torch.models import lm, rglru, ssm
    from repro_torch.parallel.sharding import make_ctx, param_specs

    def draw(*shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            BODY["seed"] + seed))

    def mine(cfg):
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if not mesh.ranked:
            return params
        return convert.rank_state(params, mesh, param_specs(mesh, params),
                                  axes=("model",))

    def record(tag, outs, ins, p, dims):
        out.update({f"{tag}/{k}": v.detach().numpy() for k, v in outs.items()})
        out.update({f"{tag}/g_{k}": v.grad.numpy() for k, v in ins.items()})
        out.update({f"{tag}/g/{k}": v.grad.numpy() for k, v in p.items()})
        out.update({f"{tag}/dim/{k}": np.asarray(d) for k, d in dims.items()})

    b, s = BODY["b"], BODY["s"]
    out = {}
    # Mamba2's gated norm, on the rank's heads' features
    cfg = model_config("mamba2-2.7b")
    lctx = make_ctx(mesh, cfg).at("blocks")
    tp = lctx.split("w_out")
    first, count = ssm._heads(cfg, lctx, tp)
    lo, k = first * cfg.ssm_head_dim, count * cfg.ssm_head_dim
    ins = {n: draw(b, s, cfg.d_inner, seed=i).narrow(-1, lo, k).clone()
           .requires_grad_(True) for i, n in enumerate(("y", "z"))}
    scale = draw(cfg.d_inner, seed=2).narrow(-1, lo, k).clone() \
        .requires_grad_(True)
    y = ssm._gated_norm(ins["y"], ins["z"], scale, cfg, lctx, tp,
                        count < cfg.n_ssm_heads)
    (y * draw(b, s, cfg.d_inner, seed=3).narrow(-1, lo, k)).sum().backward()
    record("norm", {"y": y}, ins, {"scale": scale}, {"scale": -1})
    # Mamba2's block
    p, dims = _layer({k: v for k, v in mine(cfg)["blocks"].items()
                      if k != "ln1"}, lctx.tp, 0)
    ins = {"x": draw(b, s, cfg.d_model, seed=4).requires_grad_(True)}
    y, (state, tail) = ssm.mamba2_block(ins["x"], lm._enter_shared(
        p, lctx), cfg, ctx=lctx)
    (y * draw(b, s, cfg.d_model, seed=5)).sum().backward()
    record("ssm", {"y": y, "state": state, "tail": tail}, ins, p, dims)
    # RG-LRU's block (layer 0 of the pattern r, r, a)
    cfg = model_config("recurrentgemma-2b")
    rctx = make_ctx(mesh, cfg).at("blocks", 0, "rec")
    p, dims = _layer(mine(cfg)["blocks"][0]["rec"], rctx.tp, None)
    ins = {"x": draw(b, s, cfg.d_model, seed=6).requires_grad_(True)}
    y, (h_last, tail) = rglru.recurrent_block(
        ins["x"], lm._enter_shared(p, rctx), cfg, ctx=rctx)
    (y * draw(b, s, cfg.d_model, seed=7)).sum().backward()
    record("rec", {"y": y, "h_last": h_last, "tail": tail}, ins, p, dims)
    # the decoder's cross-attention: every layer's cross K/V, then layer
    # 0's attention over them
    cfg = model_config("seamless-m4t-medium")
    ctx = make_ctx(mesh, cfg)
    dctx = ctx.at("dec_blocks")
    dec = mine(cfg)["dec_blocks"]
    p, dims = _layer({k: v for k, v in dec.items() if k.startswith("x_")},
                     dctx.tp, None)
    ins = {"x": draw(b, s, cfg.d_model, seed=8).requires_grad_(True),
           "enc": draw(b, BODY["se"], cfg.d_model, seed=9)
           .requires_grad_(True)}
    entered = lm._enter_shared(p, dctx)
    ck, cv = lm._cross_kv({"dec_blocks": entered}, ins["enc"], cfg, ctx)
    y, _ = lm._attn_sub(ins["x"], lm._xattn_params(
        {k: v[0] for k, v in entered.items()}), cfg, lm._xattn_ctx(dctx),
        cross_kv=(ck[0], cv[0]))
    (y * draw(b, s, cfg.d_model, seed=10)).sum().backward()
    record("xattn", {"y": y, "k": ck, "v": cv}, ins, p, dims)
    return out


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
                                specs)
    loss, grads, missing = step_fn.grads_of({"params": params}, model_batch(
        cfg, POLICY_B))
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
    from repro_torch.launch.mesh import make_production_mesh
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

    first = next(iter(LAYOUTS))
    for name, ranks in LAYOUTS.items():
        mesh = Mesh(MESH, "cpu", group=group, ranks=ranks)
        out[f"coords_{name}"] = np.asarray([mesh.coord("data"),
                                            mesh.coord("model")])
        for arch in ARCHS:
            timed(f"draw_{name}_{arch}", _draw, mesh, arch)
            timed(f"grads_{name}_{arch}", _grads, mesh, arch, tmp)
            timed(f"step_{name}_{arch}", step_case, mesh, arch, tmp, name,
                  None if name == first else first)
            timed(f"serve_{name}_{arch}", serve_case, mesh, arch)
        timed(f"policy_{name}", _policy, mesh, tmp)
        timed(f"bodies_{name}", body_case, mesh)
        timed(f"train_{name}", _train, tmp, name, mesh)
    timed("bodies_prod", body_case, make_production_mesh(
        device="cpu", group=group, ranks={"model": 4}))
    timed("pserve", _pserve, tmp)
    out.update({f"seconds/{k}": np.asarray(v) for k, v in secs.items()})
    np.savez(tmp / f"rank{rank}.npz", **out)
    pd.finish()
