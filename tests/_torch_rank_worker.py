"""What each ``torch.distributed`` rank of ``tests/test_torch_ranks.py``
runs, importing no JAX.

:func:`main` joins a gloo group on the CPU through a ``file://``
rendezvous and runs every scenario once: the sharded plane's scenarios
(``tests/test_torch_sharded.py``) on ``Mesh(4)`` over 4 ranks x 1 shard,
over 2 ranks x 2 shards (ranks 0-1 the first group of scenarios, ranks
2-3 the second) and over a world-1 group; expert-parallel ``moe_ffn``
over the model axis of a (data 2, model 4) mesh, on inputs the test
wrote; the GPipe pipeline with one stage a rank; and ``launch.serve
--production-mesh`` at smoke size.  Each rank writes what it saw to
``rank<r>.npz`` in the test's directory.
"""

import pathlib
import sys

import numpy as np
import torch

TESTS = pathlib.Path(__file__).resolve().parent

# the serve case: deepseek-moe-16b's smoke config with enough experts
# for 16 model shards, in fp32
SERVE_ARGV = ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
              "--production-mesh", "--requests", "4", "--batch", "4",
              "--prompt-len", "16", "--gen", "3"]
# world-1 groups: rank r replays these scenarios on a group of its own
WORLD1 = (("ops_wb1_w3", "overflow_wb0"), ("rmw_wb1", "descent"),
          ("evict_wb1", "rehome_wb1"), ("txn_to", "serve"))
PIPE = dict(stages=4, micro=8, width=16, layers=8, rows=4, seed=15)


def serve_config(cfg):
    """The serve case's config from the smoke one."""
    return cfg.replace(n_experts=16, dtype="float32")


def pipeline_inputs():
    """The pipeline case's layer stack [L, w, w] and micro-batches."""
    gen = torch.Generator().manual_seed(PIPE["seed"])
    w = torch.randn((PIPE["layers"], PIPE["width"], PIPE["width"]),
                    generator=gen) * PIPE["width"] ** -0.5
    x = torch.randn((PIPE["micro"], PIPE["rows"], PIPE["width"]),
                    generator=gen)
    return w, x


def pipeline_stage(params, h):
    for wi in params["w"]:
        h = torch.tanh(h @ wi)
    return h


def _scenarios(mesh, names):
    if str(TESTS) not in sys.path:
        sys.path.insert(0, str(TESTS))
    import test_torch_sharded as T
    everything = T.scenarios("all")
    out = {}
    for name in names:
        fn, kw = everything[name]
        res = {}
        fn(T.Pkg("torch", 4, mesh), res, **kw)
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


def latch_inputs():
    """The latch plane's case: 32 words striped over 4 shards, 24
    requests."""
    from repro_torch.kernels.latch_ops import OP_CAS, OP_FAA
    rng = np.random.default_rng(8)
    flat = torch.from_numpy(rng.integers(0, 3, (32, 2)).astype(np.int32))
    req = {"line": rng.integers(-1, 32, 24),
           "op": rng.choice([OP_CAS, OP_FAA], 24),
           "arg_hi": rng.integers(0, 3, 24), "arg_lo": rng.integers(0, 3, 24),
           "cmp_hi": rng.integers(0, 3, 24), "cmp_lo": rng.integers(0, 3, 24)}
    return flat, {k: torch.from_numpy(v.astype(np.int32))
                  for k, v in req.items()}


def _pieces(mesh):
    """``distributed_latch_round`` on this rank's slabs, and a JAX-layout
    sharded state carried onto the ranks by ``convert`` and back."""
    from repro_torch import convert
    from repro_torch.core import distributed_rounds as tdr
    from repro_torch.core.rounds import gather_state, make_state
    flat, req = latch_inputs()
    words = tdr.stripe(flat, 4)
    rows = words.shape[0] // 4
    first, stop = mesh.block()
    new, hi, lo, ok, dropped = tdr.distributed_latch_round(
        words[first * rows:stop * rows].clone(), req, mesh=mesh)
    out = {"latch/new": mesh.all_gather(new).numpy(),
           "latch/hi": hi.numpy(), "latch/lo": lo.numpy(),
           "latch/ok": ok.numpy(), "latch/dropped": dropped.numpy(),
           "latch/local_rows": np.asarray(new.shape[0])}
    arrays = convert.to_numpy(make_state(2, 8, payload_width=2,
                                         home_directory=True,
                                         replicas=True, device="cpu"))
    arrays["mem_data"] = np.arange(16, dtype=np.int32).reshape(8, 2)
    st = convert.sharded_state_from_arrays(arrays, mesh)
    out["convert/local_rows"] = np.asarray(st["mem_data"].shape[0])
    out.update({f"convert/{k}": v.numpy()
                for k, v in gather_state(st, mesh).items()})
    return out


def _ep(mesh, tmp):
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import make_ctx
    cfg = get_smoke_config("deepseek-moe-16b").replace(dtype="float32")
    with np.load(tmp / "ep_in.npz") as z:
        inp = {k: torch.from_numpy(z[k]) for k in z.files}
    p = {k[2:]: v for k, v in inp.items() if k.startswith("p/")}
    mine = convert.rank_experts(p, mesh)
    ctx = make_ctx(mesh, cfg)
    out = {}
    for tag in ("prefill", "decode"):
        y, aux = moe.moe_ffn(inp[f"x/{tag}"], mine, cfg, ctx)
        out[f"{tag}/y"] = y.numpy()
        out[f"{tag}/aux"] = np.asarray(float(aux))
    out["experts_here"] = np.asarray(mine["we_d"].shape[0])
    return out


def _pipeline(mesh):
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages
    w, x = pipeline_inputs()
    y = pipeline_forward(pipeline_stage,
                         split_stages({"w": w}, PIPE["stages"]), x,
                         mesh=mesh)
    return {"y": y.numpy()}


def _serve(tmp, rank):
    from repro_torch.launch import serve
    real = serve.get_smoke_config
    serve.get_smoke_config = lambda arch: serve_config(real(arch))
    try:
        res = serve.main(SERVE_ARGV + ["--logits-out",
                                       str(tmp / "serve_ranks.npz")])
    finally:
        serve.get_smoke_config = real
    return {"generated": res["generated"],
            "ranks": np.asarray(res["ranks"]), "ep": np.asarray(res["ep"])}


def main(rank, world, tmp):
    import time

    import torch.distributed as dist
    from repro_torch.core.rounds import Mesh
    from repro_torch.core.rounds.mesh import collective_counts
    from repro_torch.parallel import dist as pd
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    group, dev = pd.init(init_method=f"file://{tmp / 'rendezvous'}",
                         device="cpu")
    assert world == 4 and dev.type == "cpu"
    assert dist.get_backend(group) == "gloo"
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    singles = [dist.new_group([r]) for r in range(world)]
    import test_torch_sharded as T
    out, secs = {}, {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        got = fn(*a)
        secs[name] = time.perf_counter() - t0
        out.update({f"{name}/{k}": v for k, v in got.items()})

    timed("plane4", _scenarios, Mesh(4, "cpu", group=group),
          tuple(T.scenarios("all")))
    timed("pieces", _pieces, Mesh(4, "cpu", group=group))
    timed("plane2x2", _scenarios, Mesh(4, "cpu", group=pairs[rank // 2]),
          tuple(T.scenarios("1" if rank < 2 else "2")))
    timed("world1", _scenarios, Mesh(4, "cpu", group=singles[rank]),
          WORLD1[rank])
    timed("ep", _ep, Mesh({"data": 2, "model": 4}, "cpu", group=group),
          tmp)
    timed("pipe", _pipeline, Mesh({"pipe": 4}, "cpu", group=group))
    timed("serve", _serve, tmp, rank)
    out.update({f"seconds/{k}": np.asarray(v) for k, v in secs.items()})
    out.update({f"collectives/{k}": np.asarray(v)
                for k, v in collective_counts().items()})
    np.savez(tmp / f"rank{rank}.npz", **out)
    pd.finish()


def failing_rank(rank, world, tmp):
    """Rank 2 fails after the rendezvous while the others wait for it in
    an ``all_reduce``."""
    from repro_torch.parallel import dist as pd
    pd.init(init_method=f"file://{pathlib.Path(tmp) / 'rendezvous'}",
            device="cpu")
    if rank == 2:
        raise RuntimeError("rank 2 fails on purpose")
    import torch.distributed as dist
    dist.all_reduce(torch.ones(1))


def one_rank(tmp):
    """World 1 in this process (``RANK`` 0, ``WORLD_SIZE`` 1): a ranked
    plane, expert-parallel ``moe_ffn`` and the pipeline over a group of
    one, each against the same mesh without a group."""
    import os

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.rounds import DevicePlane, Mesh, make_sharded_state
    from repro_torch.models import moe
    from repro_torch.parallel import dist as pd
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages
    from repro_torch.parallel.sharding import make_ctx
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    group, _ = pd.init(init_method=f"file://{pathlib.Path(tmp) / 'one'}",
                       device="cpu")
    res = []
    for g in (group, None):
        mesh = Mesh(2, "cpu", group=g)
        plane = DevicePlane.open(make_sharded_state(2, 8, mesh,
                                                    payload_width=2), mesh)
        r = plane.ops([0, 1, 1], [3, 3, 6], [1, 0, 1],
                      [[5, 6], [0, 0], [7, 8]])
        cfg = get_smoke_config("dbrx-132b").replace(dtype="float32")
        lm_mesh = Mesh({"data": 1, "model": 4}, "cpu", group=g)
        p = moe.init_moe(torch.Generator().manual_seed(1), cfg,
                         torch.float32)
        y, _ = moe.moe_ffn(torch.ones(2, 8, cfg.d_model), p, cfg,
                           make_ctx(lm_mesh, cfg))
        w, x = pipeline_inputs()
        z = pipeline_forward(pipeline_stage, split_stages({"w": w}, 4), x,
                             mesh=Mesh({"pipe": 4}, "cpu", group=g))
        res.append((r.version, r.data, plane.flat_state()["words"], y, z))
    pd.finish()
    for a, b in zip(*res):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    return True
