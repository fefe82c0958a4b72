"""What each ``torch.distributed`` rank of ``tests/test_torch_ranks_data.py``
runs, importing no JAX.

:func:`main` joins a gloo group on the CPU through a ``file://``
rendezvous and runs every case once in each layout of :data:`LAYOUTS`
over the (data 4, model 2) mesh :data:`MESH`: 4 data ranks (``d4``:
each rank a block of the data axis, both model shards) and 2 data x 2
model ranks (``d2m2``, its model ranks tensor parallel):

* ``moves``: ``collectives.gather_block`` along two dims, its gradient
  under each data rank's own share of a loss, ``Mesh.reduce_scatter``,
  and the step's sum of the gradients of a leaf held whole along data;
* ``draw``: a rank's train state drawn with ``mesh=`` (int8 m and v and
  the error feedback) against ``convert.rank_state`` of the whole draw,
  and the rank's parameter bytes;
* ``grads``: the fp32 smoke models' (:data:`ARCHS`: one of every
  family) ``grads_of`` on the parameters the test wrote, cut to the rank's
  blocks, with and without remat: the global loss, this rank's share,
  every gradient block, the leaves missed, the collectives by axis; and
  a 2-row batch the data axis does not divide;
* ``step``: one train step with fp32 and with int8 m and v from a state
  drawn with ``mesh=``: the grad norm and the parameter blocks; the fp32
  step's state checkpointed (``CheckpointManager(shardings=)``), and in
  the second layout the first layout's checkpoint restored, its
  parameter blocks kept;
* ``mserve``: :func:`serve_run` of every model (a prefill and
  teacher-forced decode steps of the rank's rows);
* ``train``: ``launch.train --production-mesh --data-ranks`` at smoke
  width (deepseek, 16 experts, fp32), writing checkpoints, and resuming
  from the checkpoints the test or the other layout wrote;
* ``serve`` (``d4`` only): ``launch.serve --production-mesh --data-ranks
  4`` of the qwen3 smoke model, its logits kept.

Each rank writes what it saw to ``rank<r>.npz`` in the test's directory.
"""

import dataclasses
import pathlib
import shutil

import numpy as np
import torch

ARCHS = ("qwen3-1.7b", "deepseek-moe-16b", "mamba2-2.7b",
         "recurrentgemma-2b", "llava-next-mistral-7b",
         "seamless-m4t-medium")
MESH = {"data": 4, "model": 2}
LAYOUTS = {"d4": {"data": 4}, "d2m2": {"data": 2, "model": 2}}
# the model case: batch, sequence and the xent chunk; ODD_B rows are
# more than one but fewer than the data axis's 4 shards
MODEL = dict(b=4, s=16, loss_chunk=16, seed=11)
ODD_B = 2
STEP_SEED = 21
SERVE = dict(b=4, prompt=8, gen=3, seed=13)
# the driver case: a few steps at smoke width, a checkpoint after step 2
TRAIN_ARCH = "deepseek-moe-16b"
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--smoke", "--device", "cpu",
              "--production-mesh", "--steps", "5", "--batch", "16",
              "--seq", "32", "--lr", "3e-3", "--log-every", "1",
              "--ckpt-every", "3"]
SERVE_ARGV = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
              "--production-mesh", "--requests", "16", "--batch", "16",
              "--prompt-len", "16", "--gen", "4"]


def model_config(arch):
    """The model cases' config: the smoke one in fp32."""
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(dtype="float32")


def train_config(cfg):
    """The driver case's config from the smoke one: enough experts for
    16 model shards, in fp32."""
    return cfg.replace(n_experts=16, dtype="float32")


def model_batch(cfg, b=MODEL["b"]):
    """The model cases' batch of ``b`` rows: tokens and labels from numpy
    seed ``MODEL["seed"]``, and the vlm's patch or the encdec's frame
    embeddings, the training driver's seeded stand-ins
    (``launch.train.frontend_stand_ins``) in fp32."""
    from repro_torch.launch.train import frontend_stand_ins
    rng = np.random.default_rng(MODEL["seed"])
    toks = rng.integers(0, cfg.vocab, (b, MODEL["s"] + 1)).astype(np.int32)
    out = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
           "labels": torch.from_numpy(toks[:, 1:]).long()}
    out.update({k: v.float() for k, v in frontend_stand_ins(
        cfg, MODEL["s"], b, torch.device("cpu")).items()})
    return out


def serve_inputs(cfg):
    """The serve case's prompts [b, prompt], teacher inputs [b, gen] and
    the vlm's patch or the encdec's frame embeddings (the training
    driver's seeded stand-ins, in the config's dtype)."""
    from repro_torch.launch.train import frontend_stand_ins
    rng = np.random.default_rng(SERVE["seed"])
    toks = rng.integers(0, cfg.vocab, (SERVE["b"], SERVE["prompt"]
                                       + SERVE["gen"]))
    toks = torch.from_numpy(toks.astype(np.int32))
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    embeds = {k: v.to(dt) for k, v in frontend_stand_ins(
        cfg, SERVE["prompt"], SERVE["b"], torch.device("cpu")).items()}
    return toks[:, :SERVE["prompt"]], toks[:, SERVE["prompt"]:], embeds


def serve_run(mesh, cfg, rows=None):
    """``build_serve_step`` on ``mesh``: this rank's rows (or ``rows``) of
    the prompts prefilled, then a decode step for each teacher input.
    Returns the logits [gen + 1, rows, V] and the decode cache's leaf
    shapes ({name: shape}, ``pos`` left out)."""
    from repro_torch.launch.serve import grow_cache, prefix_len
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import data_rows, expert_block
    from repro_torch.train.step import build_serve_step, rank_cut
    step, prefill, ctx = build_serve_step(cfg, mesh)
    block = expert_block(cfg, ctx)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            **({"experts": block} if block else {}),
                            cut=rank_cut(cfg, mesh, (ctx.tp_axis,)))
    prompts, feed, embeds = serve_inputs(cfg)
    b = prompts.shape[0]
    if rows is None:
        rows = data_rows(mesh, b)
    split = len(rows) < b and mesh.ranked
    rows = torch.from_numpy(np.asarray(rows))
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": prompts[rows], **{
            k: v[rows] for k, v in embeds.items()}}, data_block=split)
        cache = grow_cache(cfg, cache, prefix_len(cfg) + SERVE["prompt"]
                           + SERVE["gen"])
        out = [logits]
        for i in range(SERVE["gen"]):
            logits, cache = step(params, cache, feed[rows, i:i + 1],
                                 data_block=split)
            out.append(logits)
    return torch.stack(out).numpy(), {k: tuple(v.shape)
                                      for k, v in cache.items()
                                      if k != "pos"}


def tree_of(arrays, prefix, leaf=lambda a: a):
    """The tree of ``arrays``' ``prefix/a/b`` entries (a ``#i`` segment
    an index of a list, the hybrid family's per-layer blocks), each
    array through ``leaf``."""
    tree = {}
    for k, v in arrays.items():
        if not k.startswith(prefix):
            continue
        *keys, name = k[len(prefix):].split("/")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[name] = leaf(v)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [lists(node[f"#{i}"]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def arrays_of(tree, prefix):
    """:func:`tree_of`'s inverse for a tree of tensors: ``prefix/a/b``
    numpy arrays."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [f"#{i}"])
        else:
            out[prefix + "/".join(path)] = node.numpy()
    walk(tree, [])
    return out


def load_params(path):
    """A parameter tree from ``path``'s ``params/a/b`` arrays."""
    with np.load(path) as z:
        return tree_of({k: z[k] for k in z.files}, "params/",
                       lambda a: torch.from_numpy(a.copy()))


def param_specs(mesh, cfg):
    """The whole parameter tree's specs on ``mesh``."""
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import state_shapes, state_specs
    tcfg = TrainConfig()
    return state_specs(mesh, state_shapes(cfg, tcfg), tcfg)["params"]


def _moves(mesh):
    """gather_block's forward and its gradient under the loss ``(y *
    c_d).sum()``, ``c_d`` this data rank's own (its share); the block
    sum of the reduce-scatter; the data sum of a replicated leaf's
    gradient."""
    from repro_torch.parallel import collectives as cl
    from repro_torch.parallel.sharding import RankDims
    from repro_torch.train.step import _sum_data_replicated
    n, c = mesh.n_ranks("data"), mesh.coord("data")
    out = {}
    for dim in (0, 1):
        own = torch.randn(2, 3, generator=torch.Generator().manual_seed(
            30 + c))
        share = torch.randn((2 * n, 3) if dim == 0 else (2, 3 * n),
                            generator=torch.Generator().manual_seed(60 + c))
        x = own.clone().requires_grad_(True)
        y = cl.gather_block(x, mesh, dim)
        (y * share).sum().backward()
        out[f"gather{dim}/y"] = y.detach().numpy()
        out[f"gather{dim}/g"] = x.grad.numpy()
    part = torch.randn(4 * n, 2, generator=torch.Generator().manual_seed(
        70 + mesh.rank))
    out["rs/x"] = part.numpy()
    out["rs/y"] = mesh.reduce_scatter(part, 0, axis="data").numpy()
    g_blk = torch.randn(2, 2, generator=torch.Generator().manual_seed(
        80 + mesh.rank))
    g_rep = torch.randn(3, generator=torch.Generator().manual_seed(
        90 + mesh.rank))
    summed = _sum_data_replicated({"a": g_blk, "b": g_rep},
                                  [RankDims({"data": 0}), RankDims()], mesh,
                                  "data")
    out["sum/a_in"], out["sum/b_in"] = g_blk.numpy(), g_rep.numpy()
    out["sum/a"], out["sum/b"] = summed["a"].numpy(), summed["b"].numpy()
    return out


def _draw(mesh, arch):
    """A rank's train state drawn with ``mesh=`` against
    ``rank_state`` of the whole draw, leaf for leaf (int8 m and v and
    the error feedback included), and its parameter bytes."""
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
    return {"same_tree": np.asarray(spec_a == spec_b),
            "equal": np.asarray([x.shape == y.shape and torch.equal(x, y)
                                 for x, y in zip(a, b)]),
            "param_bytes": np.asarray(sum(
                p.numel() * p.element_size()
                for p in pt.leaves(mine["params"])))}


def _grads(mesh, arch, tmp):
    from repro_torch import convert
    from repro_torch import tree as pt
    from repro_torch.core.rounds.mesh import (collective_counts,
                                              reset_collective_counts)
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import data_rows
    from repro_torch.train import TrainConfig, build_train_step
    cfg = model_config(arch)
    params = convert.rank_state(load_params(tmp / f"{arch}_in.npz"), mesh,
                                param_specs(mesh, cfg))
    out = {}
    for remat in (False, True):
        tcfg = TrainConfig(remat=remat, loss_chunk=MODEL["loss_chunk"])
        step_fn, ctx, _ = build_train_step(cfg, mesh, tcfg)
        dims = step_fn.leaf_dims()["params"]
        tag = f"remat{int(remat)}"
        for b in ((MODEL["b"], ODD_B) if not remat else (MODEL["b"],)):
            batch = model_batch(cfg, b)
            key = tag if b == MODEL["b"] else f"{tag}_odd"
            reset_collective_counts()
            loss, grads, missing = step_fn.grads_of({"params": params},
                                                    batch)
            counts = collective_counts()
            rows = data_rows(mesh, b)
            c = dataclasses.replace(ctx, data_block=len(rows) < b)
            with torch.no_grad():
                share = lm.train_loss(
                    params, {k: v[rows] for k, v in batch.items()}, cfg, c,
                    remat=False, loss_chunk=MODEL["loss_chunk"])
            out[f"{key}/loss"] = loss.numpy()
            out[f"{key}/share"] = share.numpy()
            out[f"{key}/missing"] = np.asarray(missing)
            for i, g in enumerate(pt.leaves(grads)):
                out[f"{key}/grad{i}"] = g.numpy()
            for k, v in counts.items():
                out[f"{key}/coll/{k}"] = np.asarray(v)
    out["dims"] = np.asarray([repr(dict(d)) for d in dims])
    return out


def step_case(mesh, arch, tmp, name, restore_from=None):
    """One train step with fp32 and with int8 m and v; the fp32 step's
    state checkpointed under ``ckpt_<arch>_<name>``; with
    ``restore_from`` (a layout's name) that layout's checkpoint restored
    into this one, its parameter blocks kept."""
    from repro_torch import tree as pt
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.sharding import expert_block, make_ctx, to_named
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.train.step import (init_train_state, state_shapes,
                                        state_specs)
    cfg = model_config(arch)
    out = {}
    for tier in ("float32", "int8"):
        tcfg = TrainConfig(remat=True, loss_chunk=MODEL["loss_chunk"],
                           opt=AdamWConfig(m_dtype=tier, v_mode=tier))
        step_fn, _, _ = build_train_step(cfg, mesh, tcfg)
        state = init_train_state(
            cfg, tcfg, torch.Generator().manual_seed(STEP_SEED), "cpu",
            experts=expert_block(cfg, make_ctx(mesh, cfg)), mesh=mesh)
        state, m = step_fn(state, model_batch(cfg))
        out[f"{tier}/grad_norm"] = m["grad_norm"].numpy()
        out[f"{tier}/loss"] = m["loss"].numpy()
        out[f"{tier}/missing"] = np.asarray(m["grads_missing"])
        for i, p in enumerate(pt.leaves(state["params"])):
            out[f"{tier}/param{i}"] = p.numpy()
        if tier != "float32":
            continue
        named = to_named(mesh, state_specs(mesh, state_shapes(cfg, tcfg),
                                           tcfg))
        mgr = CheckpointManager(tmp / f"ckpt_{arch}_{name}", async_=False,
                                shardings=named)
        mgr.save(state, 0)
        if restore_from is not None:
            got, _ = CheckpointManager(
                tmp / f"ckpt_{arch}_{restore_from}",
                shardings=named).restore(state)
            for i, p in enumerate(pt.leaves(got["params"])):
                out[f"restored/param{i}"] = p.numpy()
    return out


def serve_case(mesh, arch):
    """:func:`serve_run` of ``arch`` on this rank: its logits, rows and
    cache shapes."""
    from repro_torch.parallel.sharding import data_rows
    logits, shapes = serve_run(mesh, model_config(arch))
    return {"logits": logits, "rows": np.asarray(data_rows(mesh, SERVE["b"])),
            **{f"cache/{k}": np.asarray(v) for k, v in shapes.items()}}


def _train(tmp, name, mesh):
    """The driver over ``name``'s layout: 4 data ranks write their
    checkpoints and resume from the one-process one; 2 x 2 ranks resume
    from the 4 data ranks' step 2."""
    from repro_torch.launch import train
    n_data = LAYOUTS[name]["data"]
    real = train.get_smoke_config
    train.get_smoke_config = lambda arch: train_config(real(arch))
    argv = TRAIN_ARGV + ["--data-ranks", str(n_data)]
    try:
        rec = train.main(argv + ["--ckpt", str(tmp / f"ckpt_{name}")])
        if name == "d4":
            src = tmp / "ckpt_one"
        else:
            src = tmp / "ckpt_d4_at2"
            if mesh.rank == 0:
                shutil.copytree(tmp / "ckpt_d4", src)
                shutil.rmtree(src / "step_000004")
            mesh.barrier()
        res = train.main(argv + ["--resume", "--ckpt", str(src)])
    finally:
        train.get_smoke_config = real
    out = {"losses": np.asarray(rec["losses"]),
           "grad_norms": np.asarray(rec["grad_norms"]),
           "missing": np.asarray(rec["grads_missing"]),
           "rank_world": np.asarray([rec["rank"], rec["world"]]),
           "layout": np.asarray(repr(rec["ranks"])),
           "param_bytes": np.asarray(rec["param_bytes"]),
           "resumed/start": np.asarray(res["start"]),
           "resumed/losses": np.asarray(res["losses"])}
    for k in rec["collectives"][0]:
        out[f"coll/{k}"] = np.asarray([c.get(k, 0)
                                       for c in rec["collectives"]])
    return out


def _serve(tmp):
    from repro_torch.launch import serve
    res = serve.main(SERVE_ARGV + ["--data-ranks", "4", "--logits-out",
                                   str(tmp / "serve_d4.npz")])
    return {"generated": res["generated"], "finite": np.asarray(
        res["finite"]), "layout": np.asarray(repr(res["layout"]))}


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

    first = next(iter(LAYOUTS))
    for name, ranks in LAYOUTS.items():
        mesh = Mesh(MESH, "cpu", group=group, ranks=ranks)
        out[f"coords_{name}"] = np.asarray([mesh.coord("data"),
                                            mesh.coord("model")])
        timed(f"moves_{name}", _moves, mesh)
        for arch in ARCHS:
            timed(f"draw_{name}_{arch}", _draw, mesh, arch)
            timed(f"grads_{name}_{arch}", _grads, mesh, arch, tmp)
            timed(f"step_{name}_{arch}", step_case, mesh, arch, tmp, name,
                  None if name == first else first)
            timed(f"mserve_{name}_{arch}", serve_case, mesh, arch)
        timed(f"train_{name}", _train, tmp, name, mesh)
    timed("serve", _serve, tmp)
    out.update({f"seconds/{k}": np.asarray(v) for k, v in secs.items()})
    np.savez(tmp / f"rank{rank}.npz", **out)
    pd.finish()
