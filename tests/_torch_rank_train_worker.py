"""What each ``torch.distributed`` rank of ``tests/test_torch_ranks_train.py``
runs, importing no JAX.

:func:`main` joins a gloo group on the CPU through a ``file://``
rendezvous and runs every case once, over 4 ranks x 1 model shard and
over 2 ranks x 2 model shards (ranks 0-1 one group, ranks 2-3 another)
of a (data 2, model 4) mesh:

* ``moves``: each autograd move of ``parallel.collectives`` on a small
  tensor, its output and its input's gradient under a replicated loss
  (and, beside it, ``torch.distributed.nn``'s all-gather, whose backward
  scales a replicated gradient by the world);
* ``draw``: a rank's train state drawn with its experts and its model
  blocks (tensor parallelism) against the cut of the whole draw, and
  its placement by the state's specs;
* ``grads``: the fp32 deepseek smoke model's ``value_and_grad`` on the
  parameters the test wrote, cut to the rank's blocks, with and without
  remat: the loss, every gradient leaf (a rank's block of a ranked
  leaf), the leaves missed, the gradient digests and the collectives
  the call issued;
* ``step``: one train step (AdamW with the clip) from a state drawn with
  the rank's blocks: the grad norm and the updated parameters;
* ``train``: ``launch.train --production-mesh`` at smoke width (16
  experts, fp32) over the 4 ranks, writing checkpoints, and the same
  driver resuming from the one-process checkpoint the test wrote.

Each rank writes what it saw to ``rank<r>.npz`` in the test's directory.
"""

import pathlib

import numpy as np
import torch

ARCH = "deepseek-moe-16b"
LAYOUTS = ("4x1", "2x2")
# the model case: batch, sequence and the xent chunk, as the reference's
MODEL = dict(b=4, s=16, loss_chunk=16, seed=11)
STEP_SEED = 21
# the driver case: a few steps at smoke width, a checkpoint after step 2
TRAIN_ARGV = ["--arch", ARCH, "--smoke", "--device", "cpu",
              "--production-mesh", "--steps", "5", "--batch", "4",
              "--seq", "32", "--lr", "3e-3", "--log-every", "1",
              "--ckpt-every", "3"]


def model_config():
    """The model cases' config: the smoke one in fp32."""
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(ARCH).replace(dtype="float32")


def train_config(cfg):
    """The driver case's config from the smoke one: enough experts for
    16 model shards, in fp32."""
    return cfg.replace(n_experts=16, dtype="float32")


def model_batch(vocab):
    rng = np.random.default_rng(MODEL["seed"])
    toks = rng.integers(0, vocab, (MODEL["b"], MODEL["s"] + 1)).astype(
        np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]).long(),
            "labels": torch.from_numpy(toks[:, 1:]).long()}


def load_params(path):
    """A parameter tree from ``path``'s ``params/a/b`` arrays."""
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            if not k.startswith("params/"):
                continue
            *keys, leaf = k[len("params/"):].split("/")
            node = tree
            for key in keys:
                node = node.setdefault(key, {})
            node[leaf] = torch.from_numpy(z[k].copy())
    return tree


def _moves(mesh):
    """Each move's forward and its input's gradient under the
    replicated loss ``(out * c).sum()``, ``c`` the same on every rank."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn

    from repro_torch.parallel import collectives as cl
    w, r = mesh.world, mesh.rank
    gen = torch.Generator().manual_seed(7)
    x_rep = torch.randn(8, 3, generator=gen)            # replicated
    c_rep = torch.randn(8, 3, generator=gen)
    c_blk = torch.randn(8 // w, 3, generator=gen)
    out = {}

    def grad(fn, x, c):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * c).sum().backward()
        return y.detach().numpy(), x.grad.numpy()

    # replicated -> block -> replicated: the identity, gradient c
    out["round_trip/y"], out["round_trip/g"] = grad(
        lambda x: cl.all_gather(cl.block(x, mesh, 0), mesh, 0), x_rep, c_rep)
    # the block slice alone: this rank's rows of x, every rank's rows
    # of the gradient gathered
    own = torch.randn(8, 3, generator=torch.Generator().manual_seed(30 + r))
    out["block/y"], out["block/g"] = grad(
        lambda x: cl.block(x, mesh, 0) * (1 + r), x_rep, c_blk)
    # the gather alone: a rank-owned block, this rank's rows of c back
    out["gather/y"], out["gather/g"] = grad(
        lambda x: cl.all_gather(x, mesh, 0), own[:8 // w], c_rep)
    # all_to_all with unequal splits: rank r sends q + 1 rows to rank q
    ins = [q + 1 for q in range(w)]
    outs = [r + 1] * w
    src = torch.randn(sum(ins), 2,
                      generator=torch.Generator().manual_seed(40 + r))
    c_a2a = torch.randn(sum(outs), 2,
                        generator=torch.Generator().manual_seed(50 + r))
    out["a2a/x"], out["a2a/c"] = src.numpy(), c_a2a.numpy()
    out["a2a/y"], out["a2a/g"] = grad(
        lambda x: cl.all_to_all(x, mesh, outs, ins), src, c_a2a)
    # all_reduce of partial sums: the gradient passes unchanged
    part = own[:2].sum(0)
    out["reduce/x"] = part.numpy()
    out["reduce/y"], out["reduce/g"] = grad(
        lambda x: cl.all_reduce(x, mesh), part, c_rep[0])
    # torch.distributed.nn's all_gather of the same block (over the
    # default group: it refuses a subgroup here): its backward sums
    # every rank's copy of the replicated gradient
    if w == dist.get_world_size():
        x = own[:8 // w].clone().requires_grad_(True)
        (torch.cat(dnn.all_gather(x)) * c_rep).sum().backward()
        out["dnn_gather/g"] = x.grad.numpy()
    return out


def _grads(mesh, tmp):
    from repro_torch import convert
    from repro_torch import tree as pt
    from repro_torch.core.rounds.mesh import (collective_counts,
                                              reset_collective_counts)
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import make_ctx
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import (build_train_step, grad_digest,
                                        state_shapes, state_specs,
                                        value_and_grad)
    cfg = model_config()
    tcfg = TrainConfig()
    specs = state_specs(mesh, state_shapes(cfg, tcfg), tcfg)["params"]
    params = convert.rank_state(load_params(tmp / "model_in.npz"), mesh,
                                specs)
    ctx = make_ctx(mesh, cfg)
    batch = model_batch(cfg.vocab)
    ranked = build_train_step(cfg, mesh)[0].leaf_dims()["params"]
    out = {"ranked": np.asarray([bool(d) for d in ranked]),
           "dims": np.asarray([repr(dict(d)) for d in ranked])}
    for remat in (False, True):
        reset_collective_counts()
        loss, grads, missing = value_and_grad(
            lambda p, b: lm.train_loss(p, b, cfg, ctx, remat=remat,
                                       loss_chunk=MODEL["loss_chunk"]),
            params, batch)
        tag = f"remat{int(remat)}"
        out[f"{tag}/loss"] = loss.numpy()
        out[f"{tag}/missing"] = np.asarray(missing)
        for i, g in enumerate(pt.leaves(grads)):
            out[f"{tag}/grad{i}"] = g.numpy()
        dig = grad_digest(grads, ranked)
        out[f"{tag}/digest_replicated"] = np.asarray(dig["replicated"])
        for k, v in collective_counts().items():
            out[f"{tag}/coll/{k}"] = np.asarray(v)
    return out


def _draw(mesh):
    """A rank's train state drawn with its experts and its model blocks
    against the cut of the whole draw (int8 m and v and the error
    feedback included), and its placement by the state's specs (a
    rank's 2 of 8 experts do not divide the model axis of 4; the whole
    leaf does)."""
    from repro_torch import convert
    from repro_torch import tree as pt
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.sharding import (device_put, expert_block,
                                               make_ctx, rank_dims, to_named)
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import init_train_state, state_specs
    cfg = model_config()
    tcfg = TrainConfig(compress_grads=True, opt=AdamWConfig(
        m_dtype="int8", v_mode="int8"))
    block = expert_block(cfg, make_ctx(mesh, cfg))

    def draw(experts=None, mesh=None):
        return init_train_state(cfg, tcfg, torch.Generator().manual_seed(5),
                                "cpu", experts=experts, mesh=mesh)
    mine, whole = draw(block, mesh), draw()
    specs = state_specs(mesh, whole, tcfg)
    cut = convert.rank_state(whole, mesh, specs)
    a, spec_a = pt.flatten(mine)
    b, spec_b = pt.flatten(cut)
    placed = device_put(mine, to_named(mesh, specs))
    return {"block": np.asarray(block),
            "same_tree": np.asarray(spec_a == spec_b),
            "equal": np.asarray([torch.equal(x, y) for x, y in zip(a, b)]),
            "expert_rows": np.asarray(mine["params"]["blocks"]["we_d"]
                                      .shape[1]),
            "placed": np.asarray(placed["params"]["blocks"]["we_d"]
                                 is mine["params"]["blocks"]["we_d"]),
            "specs": np.asarray([repr(x) for x in pt.leaves(specs)]),
            "rank_dims": np.asarray([d.get("model", -1) for d in
                                     pt.leaves(rank_dims(mesh, specs))])}


def _step(mesh):
    from repro_torch import tree as pt
    from repro_torch.parallel.sharding import expert_block, make_ctx
    from repro_torch.train import TrainConfig, build_train_step
    from repro_torch.train.step import init_train_state
    cfg = model_config()
    tcfg = TrainConfig(remat=True, loss_chunk=MODEL["loss_chunk"])
    step_fn, ctx, _ = build_train_step(cfg, mesh, tcfg)
    state = init_train_state(cfg, tcfg,
                             torch.Generator().manual_seed(STEP_SEED), "cpu",
                             experts=expert_block(cfg, make_ctx(mesh, cfg)),
                             mesh=mesh)
    state, m = step_fn(state, model_batch(cfg.vocab))
    out = {"grad_norm": m["grad_norm"].numpy(), "loss": m["loss"].numpy(),
           "missing": np.asarray(m["grads_missing"])}
    for i, p in enumerate(pt.leaves(state["params"])):
        out[f"param{i}"] = p.numpy()
    return out


def _train(tmp):
    from repro_torch.launch import train
    real = train.get_smoke_config
    train.get_smoke_config = lambda arch: train_config(real(arch))
    try:
        rec = train.main(TRAIN_ARGV + ["--grad-digest", "--ckpt",
                                       str(tmp / "ckpt_ranks")])
        res = train.main(TRAIN_ARGV + ["--resume", "--ckpt",
                                       str(tmp / "ckpt_one")])
    finally:
        train.get_smoke_config = real
    out = {"losses": np.asarray(rec["losses"]),
           "grad_norms": np.asarray(rec["grad_norms"]),
           "missing": np.asarray(rec["grads_missing"]),
           "rank_world": np.asarray([rec["rank"], rec["world"]]),
           "ep": np.asarray(rec["ep"]),
           "digest_replicated": np.asarray(
               rec["grad_digest"]["replicated"]),
           "resumed/start": np.asarray(res["start"]),
           "resumed/losses": np.asarray(res["losses"])}
    for k in rec["collectives"][0]:
        out[f"coll/{k}"] = np.asarray([c.get(k, 0)
                                       for c in rec["collectives"]])
    return out


def main(rank, world, tmp):
    import time

    import torch.distributed as dist

    from repro_torch.core.rounds import Mesh
    from repro_torch.parallel import dist as pd
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    group, dev = pd.init(init_method=f"file://{tmp / 'rendezvous'}",
                         device="cpu")
    assert world == 4 and dev.type == "cpu"
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {"4x1": group, "2x2": pairs[rank // 2]}
    out, secs = {}, {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        got = fn(*a)
        secs[name] = time.perf_counter() - t0
        out.update({f"{name}/{k}": v for k, v in got.items()})

    for layout in LAYOUTS:
        mesh = Mesh({"data": 2, "model": 4}, "cpu", group=groups[layout])
        timed(f"moves_{layout}", _moves, mesh)
        timed(f"draw_{layout}", _draw, mesh)
        timed(f"grads_{layout}", _grads, mesh, tmp)
        timed(f"step_{layout}", _step, mesh)
    timed("train", _train, tmp)
    out.update({f"seconds/{k}": np.asarray(v) for k, v in secs.items()})
    np.savez(tmp / f"rank{rank}.npz", **out)
    pd.finish()
