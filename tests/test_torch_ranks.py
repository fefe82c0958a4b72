"""The port's ``shard_map`` bodies over ``torch.distributed`` ranks.

One module fixture spawns 4 gloo ranks on the CPU once
(``parallel.dist.spawn``: a ``file://`` rendezvous in the test's own
directory, a 180-s limit on the join; a rank that fails or outlasts it
ends them all, and every case then fails) and runs every scenario of
``tests/_torch_rank_worker.py``, which imports no JAX.  Held:

* the sharded plane's scenarios (``tests/test_torch_sharded.py``: ops,
  a ``bucket_cap`` overflow, rmw, descent, evict, rehome + replicate,
  2PL and TO, the serve trace over a mesh-backed pool) on ``Mesh(4)``
  over 4 ranks x 1 shard, over 2 ranks x 2 shards and over world-1
  groups, bit for bit against the one-process ``Mesh(4)`` (itself held
  against the JAX package's ``Auto`` 4-shard plane in
  ``tests/test_torch_sharded_apps.py``): versions, payloads, rounds,
  every telemetry field, the final sharded and unsharded states; every
  rank sees the same results;
* expert-parallel ``moe_ffn`` in fp32 over the model axis of a (data 2,
  model 4) mesh, one model shard and its experts a rank, within 1e-5 of
  the one-process mesh and of the reference's ``shard_map`` on an
  ``Auto`` mesh of 8 CPU devices (a subprocess, beside the ranks);
* the GPipe pipeline with one stage a rank, within rtol 1e-5 of the
  one-process pipeline and of the layer loop;
* ``launch.serve --production-mesh`` at smoke size over the 4 ranks
  (EP 16: 4 model shards a rank): its tokens equal the one-process
  run's, its logits within fp32 rounding;
* a failing rank fails the spawn within its limit, and the backend
  follows from the layout.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_rank_worker as W  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401
from test_torch_sharded import (ROOT, Pkg, assert_same,  # noqa: E402
                                run_scenarios, scenarios)

JOIN_S = 180

JAX_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.models import moe
    from repro.parallel.sharding import make_ctx
    d = sys.argv[1]
    z = dict(np.load(d + "/ep_in.npz"))
    cfg = get_smoke_config("deepseek-moe-16b").replace(dtype="float32")
    p = {k[2:]: jnp.asarray(v) for k, v in z.items() if k.startswith("p/")}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    ctx = make_ctx(mesh, cfg)
    f = jax.jit(lambda x, p: moe.moe_ffn(x, p, cfg, ctx))
    out = {}
    for tag in ("prefill", "decode"):
        y, aux = f(jnp.asarray(z["x/" + tag]), p)
        out[tag + "/y"], out[tag + "/aux"] = np.asarray(y), np.asarray(aux)
    np.savez(d + "/ep_jax.npz", **out)
    print("JAX_EP_OK")
""")


def _ep_inputs(tmp):
    """deepseek-moe-16b's smoke moe layer in fp32 (8 experts, 2 a model
    shard) and tokens sharing a common direction, so some assignments
    drop: a prefill (4 x 32, split over both axes) and a decode step (4
    x 1, replicated along the model axis)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config("deepseek-moe-16b").replace(dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg, torch.float32)
    rng = np.random.default_rng(5)
    common = 3.0 * rng.normal(size=(cfg.d_model,))
    arrays = {f"p/{k}": v.numpy() for k, v in p.items()}
    for tag, (b, s) in (("prefill", (4, 32)), ("decode", (4, 1))):
        arrays[f"x/{tag}"] = (rng.normal(size=(b, s, cfg.d_model))
                              + common).astype(np.float32)
    np.savez(tmp / "ep_in.npz", **arrays)
    return cfg, p, arrays


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.parallel import dist as pd
    tmp = tmp_path_factory.mktemp("ranks")
    cfg, p, arrays = _ep_inputs(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_ep = subprocess.Popen([sys.executable, "-c", JAX_EP, str(tmp)],
                              cwd=str(ROOT), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    got = {"tmp": tmp, "error": None, "cfg": cfg, "p": p,
           "inputs": arrays}
    t0 = time.monotonic()
    try:
        got["seconds"] = pd.spawn(W.main, 4, args=(str(tmp),),
                                  timeout=JOIN_S)
        got["ranks"] = [dict(np.load(tmp / f"rank{r}.npz"))
                        for r in range(4)]
    except RuntimeError as e:
        got["error"] = f"{e} after {time.monotonic() - t0:.1f} s"
    try:
        out, err = jax_ep.communicate(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        jax_ep.kill()
        out, err = jax_ep.communicate()
    got["jax"] = (dict(np.load(tmp / "ep_jax.npz")) if "JAX_EP_OK" in out
                  else err[-3000:])
    return got


def _of(ranks, rank: int, prefix: str) -> dict:
    assert ranks["error"] is None, ranks["error"]
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ranks["ranks"][rank].items()
            if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def one_process():
    """The scenarios on the one-process ``Mesh(4)``."""
    return run_scenarios(Pkg("torch", 4), "all")


def _subset(want: dict, names) -> dict:
    return {k: v for k, v in want.items() if k.split("/")[0] in names}


@pytest.mark.parametrize("layout", ["4x1", "2x2-first", "2x2-second",
                                    "world1"])
def test_plane_over_ranks_matches_one_process_mesh(ranks, one_process,
                                                   layout):
    """The scenarios over ranks equal the one-process ``Mesh(4)`` bit
    for bit (the serve's attend within 1e-4), the comparisons not
    vacuous: buckets overflowed, lines moved, replicas served, and the
    collectives crossed."""
    if layout == "4x1":
        got, names = _of(ranks, 0, "plane4"), tuple(scenarios("all"))
    elif layout.startswith("2x2"):
        first = layout == "2x2-first"
        got = _of(ranks, 0 if first else 2, "plane2x2")
        names = tuple(scenarios("1" if first else "2"))
    else:
        got = {}
        for r, names_r in enumerate(W.WORLD1):
            got.update(_of(ranks, r, "world1"))
        names = sum(W.WORLD1, ())
    assert_same(got, _subset(one_process, names))
    if layout == "4x1":
        assert any(v.sum() > 0 for k, v in got.items()
                   if "overflow" in k and k.endswith("tele/deferred"))
        assert (got["rehome_wb0/b13/state/home"] != np.arange(8)).any()
        assert any(v.sum() > 0 for k, v in got.items()
                   if "rehome" in k and k.endswith("tele/replica_served"))
        coll = _of(ranks, 0, "collectives")
        assert coll["all_to_all_calls"] > 0 and coll["all_reduce_calls"] > 0
        assert coll["all_to_all_bytes"] > 0


def test_latch_round_and_convert_over_ranks(ranks):
    """``distributed_latch_round`` with each rank's slab of the words
    equals K1's plain version on the flat words (the replies
    all-gathered); a JAX-layout sharded state carried onto the ranks
    keeps a quarter of the rows a rank and gathers back whole."""
    from repro_torch.core import distributed_rounds as tdr
    from repro_torch.kernels.latch_ops import apply_batch
    got = _of(ranks, 0, "pieces")
    flat, req = W.latch_inputs()
    want = apply_batch(flat, req)
    assert int(got["latch/local_rows"]) == 8
    assert int(got["latch/dropped"]) == 0
    np.testing.assert_array_equal(
        tdr.unstripe(torch.from_numpy(got["latch/new"]), 4).numpy(),
        want[0].numpy())
    for k, w in zip(("hi", "lo", "ok"), want[1:]):
        np.testing.assert_array_equal(got[f"latch/{k}"], w.numpy())
    assert int(got["convert/local_rows"]) == 2
    np.testing.assert_array_equal(got["convert/mem_data"],
                                  np.arange(16).reshape(8, 2))
    assert got["convert/home"].shape == (8,)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_every_rank_sees_the_same_results(ranks, rank):
    """The results are all-gathered: each rank's copy equals rank 0's,
    and so do its serve tokens."""
    for prefix in ("plane4", "ep", "pipe", "serve"):
        a, b = _of(ranks, 0, prefix), _of(ranks, rank, prefix)
        b = {k: v for k, v in b.items() if k != "experts_here"}
        a = {k: v for k, v in a.items() if k != "experts_here"}
        assert_same(b, a)


@pytest.mark.parametrize("tag", ["prefill", "decode"])
def test_expert_parallel_moe_ffn_over_ranks(ranks, tag):
    """Each rank holds 2 of the 8 experts; the output is within 1e-5 of
    the one-process (data 2, model 4) mesh and of the reference's
    ``shard_map``, ``aux`` within 1e-5 relative; the prefill drops."""
    from repro_torch.core.rounds import Mesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import make_ctx
    got = _of(ranks, 0, "ep")
    assert int(got["experts_here"]) == 2
    cfg, p = ranks["cfg"], ranks["p"]
    x = torch.from_numpy(ranks["inputs"][f"x/{tag}"])
    ctx = make_ctx(Mesh({"data": 2, "model": 4}, "cpu"), cfg)
    y, aux = moe.moe_ffn(x, p, cfg, ctx)
    np.testing.assert_allclose(got[f"{tag}/y"], y.numpy(), rtol=0,
                               atol=1e-5)
    assert float(got[f"{tag}/aux"]) == pytest.approx(float(aux), rel=1e-5)
    jax = ranks["jax"]
    assert isinstance(jax, dict), jax
    np.testing.assert_allclose(got[f"{tag}/y"], jax[f"{tag}/y"], rtol=0,
                               atol=1e-5)
    assert float(got[f"{tag}/aux"]) == pytest.approx(
        float(jax[f"{tag}/aux"]), rel=1e-5)
    if tag == "prefill":
        routed = {k: v for k, v in p.items() if not k.startswith("s_")}
        assert not moe._moe_ep(x, routed, cfg, ctx)[2][4].all()


def test_pipeline_over_ranks(ranks):
    """One stage a rank: the ring hop crosses ranks and the last stage's
    outputs are all-reduced; within rtol 1e-5 of the one-process
    pipeline and of the layer loop."""
    from repro_torch.core.rounds import Mesh
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages
    got = torch.from_numpy(_of(ranks, 0, "pipe")["y"])
    w, x = W.pipeline_inputs()
    one = pipeline_forward(W.pipeline_stage, split_stages({"w": w}, 4), x,
                           mesh=Mesh({"pipe": 4}, "cpu"))
    loop = torch.stack([W.pipeline_stage({"w": w}, xm) for xm in x])
    torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, loop, rtol=1e-5, atol=1e-6)


def test_serve_production_mesh_over_ranks(ranks, monkeypatch, tmp_path):
    """``launch.serve --production-mesh`` over 4 ranks (EP 16, 4 model
    shards and 4 of the 16 experts a rank) against the one-process run:
    the same tokens, the first batch's prefill and decode logits within
    1e-5 of their scale."""
    from repro_torch.launch import serve
    got = _of(ranks, 0, "serve")
    assert int(got["ranks"]) == 4 and int(got["ep"]) == 16
    real = serve.get_smoke_config
    monkeypatch.setattr(serve, "get_smoke_config",
                        lambda arch: W.serve_config(real(arch)))
    one = serve.main(W.SERVE_ARGV + ["--logits-out",
                                     str(tmp_path / "one.npz")])
    assert one["ranks"] == 1 and one["ep"] == 16
    np.testing.assert_array_equal(got["generated"], one["generated"])
    a = np.load(ranks["tmp"] / "serve_ranks.npz")
    b = np.load(tmp_path / "one.npz")
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    scale = float(np.abs(b["logits"]).max())
    np.testing.assert_allclose(a["logits"], b["logits"], rtol=0,
                               atol=1e-5 * scale)


def test_mixed_trace_copy_matches_the_reference():
    """The ranks replay ``tests/test_serve.py``'s trace from a copy."""
    from _torch_serve_side import mixed_trace
    from test_serve import _mixed_trace
    for args in (((3, 4), 9, 7), ((), 5, 3)):
        assert mixed_trace(*args) == _mixed_trace(*args)


def test_a_failing_rank_fails_the_spawn_in_time(tmp_path):
    """A rank that raises ends every rank (the others wait in an
    ``all_reduce``; gloo may abort them first) and the spawn raises,
    naming it, well inside its limit."""
    from repro_torch.parallel import dist as pd
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 of 4 exited with code 1"):
        pd.spawn(W.failing_rank, 4, args=(str(tmp_path),), timeout=60)
    assert time.monotonic() - t0 < 60


def test_backend_follows_the_layout():
    """nccl when each rank of a host has a card, gloo when they share
    one or run on the CPU; the layout comes from the environment."""
    from repro_torch.parallel import dist as pd
    four = pd.env_layout({"RANK": "2", "WORLD_SIZE": "4",
                          "LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"})
    assert pd.choose(four, "cuda", 4) == ("nccl", torch.device("cuda", 2))
    assert pd.choose(four, "cuda", 1) == ("gloo", torch.device("cuda", 0))
    assert pd.choose(four, "cpu", 0) == ("gloo", torch.device("cpu"))
    assert pd.env_layout({}) == pd.Layout(0, 1, 0, 1)
    assert not pd.in_ranks({}) and pd.in_ranks({"WORLD_SIZE": "1"})
    with pytest.raises(ValueError, match="outside"):
        pd.env_layout({"RANK": "4", "WORLD_SIZE": "4"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pd.choose(four, "cuda", 0)


def test_mesh_over_a_group_checks_its_layout():
    """The last axis is the ranked one; without a group the mesh is
    world 1 and its collectives return their input; a state with a leaf
    on another device than the mesh's is refused."""
    from repro_torch.core.rounds import Mesh
    mesh = Mesh({"data": 2, "model": 4}, "cpu")
    assert (mesh.rank, mesh.world, mesh.ranked) == (0, 1, False)
    assert mesh.ranked_axis == "model" and mesh.block() == (0, 4)
    x = torch.arange(6)
    for y in (mesh.all_to_all(x), mesh.all_reduce(x), mesh.all_gather(x),
              mesh.ppermute(x)):
        assert y is x
    from repro_torch.core.rounds import make_state
    from repro_torch.core.rounds.mesh import check_on_mesh
    state = make_state(2, 8, device="cpu")
    check_on_mesh(state, Mesh(4, "cpu"))
    state["mem_version"] = state["mem_version"].to("meta")
    with pytest.raises(ValueError, match="'mem_version' lives on meta"):
        check_on_mesh(state, Mesh(4, "cpu"))


SMALL = {"kv": dict(n_pages=256, n_kv_heads=2, head_dim=8), "n_q_heads": 4,
         "requests": 12,
         "tree": dict(n_keys=3000, n_lines=512, slots=64, c_batches=2,
                      a_batches=1),
         "prompt": 16,
         "pipe": dict(micro=8, width=16, n_layers=8, rows=4),
         "train": dict(steps=3, seq=32)}


def test_chip_smoke_ranks_phase_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s phase 7d rehearsed on the CPU: 4 ranks of
    ``rank_main`` at small sizes against one-process references made
    here (the serve's hashes, the 4-shard tree's state hash, the first
    batch's logits of the production-mesh serve, the production-mesh
    train's losses and grad norms), each rank's record written: the
    train path's losses within ``RANK_TRAIN_LOSS_TOL`` of the
    one-process run's (the model ranks are tensor parallel: their sums
    reorder the bf16 reductions), every rank's replicated gradients
    equal, and the deepseek serve's logits the witness's bits (one
    process with the ranks' blocks, ``chip_smoke.deepseek_witness``);
    ``chip_smoke.ranks_serve_check`` fails a record past its bounds."""
    import json

    from repro_torch.core.rounds import Mesh
    from repro_torch.dsm.kvpool import KVPoolConfig
    from repro_torch.launch import serve as serve_mod
    from repro_torch.parallel import dist as pd
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    real = serve_mod.get_smoke_config
    monkeypatch.setattr(serve_mod, "get_smoke_config",
                        lambda a: real(a).replace(n_experts=16))
    cpu = torch.device("cpu")
    flat = cs.serve(cpu, KVPoolConfig(**SMALL["kv"]), SMALL["n_q_heads"],
                    requests=SMALL["requests"])
    tree = cs.sharded_tree(cpu, Mesh(4, "cpu"), __import__(
        "collections").Counter(), **SMALL["tree"])
    logits = str(tmp_path / "one.npz")
    serve_mod.main(["--arch", cs.SHARDED_ARCH, "--smoke", "--device", "cpu",
                    "--production-mesh", "--requests", "4", "--batch", "4",
                    "--prompt-len", str(SMALL["prompt"]), "--gen",
                    str(cs.RANK_GEN), "--logits-out", logits])
    from repro_torch.launch import train as train_mod
    real_train = train_mod.get_smoke_config
    monkeypatch.setattr(train_mod, "get_smoke_config",
                        lambda a: real_train(a).replace(n_experts=16))
    one = train_mod.main([
        "--arch", cs.SHARDED_ARCH, "--smoke", "--device", "cpu",
        "--production-mesh", "--steps", str(SMALL["train"]["steps"]),
        "--batch", "4", "--seq", str(SMALL["train"]["seq"]), "--micro", "1",
        "--lr", "3e-4", "--log-every", "1"])
    (tmp_path / "spec.json").write_text(json.dumps({
        "flat_serve": flat, "tree_sha256": tree["state_sha256"],
        "logits": logits, "small": SMALL,
        "train": {"losses": one["losses"],
                  "grad_norms": one["grad_norms"]}}))
    pd.spawn(cs.rank_main, 4, args=(str(tmp_path),), timeout=JOIN_S)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]
    for rec in recs:
        assert rec["backend"] == "gloo"
        assert rec["serve"]["result"]["shards"] == 4
        assert rec["serve"]["collectives"]["all_to_all_calls"] > 0
        assert rec["tree"]["result"]["upserted_keys_checked"] > 0
        assert rec["deepseek"]["result"]["ep"] == 16
        assert rec["pipeline"]["result"]["max_rel_err"] < 1e-5
        tr = rec["train"]["result"]
        assert tr["grads_missing"] == 0
        assert tr["losses"] == pytest.approx(one["losses"],
                                             rel=cs.RANK_TRAIN_LOSS_TOL)
        assert tr["collectives_steps_equal"]
        assert tr["collectives_per_step"]["all_to_all_calls"] > 0
        assert tr["grad_digest_replicated"] == recs[0]["train"]["result"][
            "grad_digest_replicated"]
    # the model ranks are tensor parallel, in bf16 here: the witness (one
    # process with the ranks' blocks and their fp32 rank-order sums)
    # gives the ranks' logits bit for bit, what the phase's serve check
    # takes beyond its tolerance
    witness = cs.deepseek_witness(logits, str(tmp_path / "deepseek_ranks.npz"),
                                  str(tmp_path / "witness.npz"), SMALL)
    assert witness["bit_equal"], witness
    rec = recs[0]["deepseek_logits"]
    cs.ranks_serve_check(dict(rec), witness)
    # past the drift's bound, or its argmax floor, the check fails even
    # with the witness bit-equal; past REPLAY_TOL, with it not
    for bad, wit in (({"rel_err": 2 * cs.RANK_MOE_SERVE_TOL}, witness),
                     ({"argmax_agree": cs.RANK_MOE_ARGMAX_MIN / 2}, witness),
                     ({"rel_err": 2 * cs.REPLAY_TOL},
                      dict(witness, bit_equal=False))):
        with pytest.raises(AssertionError):
            cs.ranks_serve_check(dict(rec, **bad), wit)
