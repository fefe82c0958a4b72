"""The port stands alone: no JAX, no ``repro``, no quiet CPU fallback.

* an AST scan finds no import of ``jax``, ``repro`` or ``ml_dtypes``
  (the card's machine has none) anywhere under
  ``src/repro_torch``, in ``chip_smoke.py``, in the port's scripts
  (``scripts/*torch*.py``: the profiling scripts and the gloo probe),
  in the ranks' test workers or in the port's examples
  (``examples/torch_*.py``);
* a subprocess in which ``jax`` and ``repro`` cannot be imported still
  imports the port, serves a small trace on the CPU, runs the LM serve
  of the dense, ssm, moe, hybrid, vlm and encdec families (the moe FFN
  and the RG-LRU modules with them), the B-link tree, a transaction
  batch, the DES workers and transaction engine, the rounds-plane
  generator, the training stack (``launch.train`` with a
  checkpoint and a resume, the optimizer tiers, gradient compression,
  the fault runtime, the input specs and the train-state conversions),
  and the sharded LM stack (the named-axis meshes, the sharding specs
  and contexts, expert-parallel ``moe_ffn`` and the pipeline), and the
  port's quickstart example; another
  runs one rank of a process group with ``jax`` and ``repro`` blocked;
* without a GPU, the entry points raise unless the CPU is asked for;
* CPU runs launch no kernel: the launch counters stay at 0;
* ``convert`` carries every leaf dtype bit for bit.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert, kernels  # noqa: E402
from repro_torch.core.rounds import make_state  # noqa: E402
from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool  # noqa: E402
from repro_torch.index import DeviceBTree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ServeLoop, ToyLM  # noqa: E402
from repro_torch.train.step import build_serve_step  # noqa: E402

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CFG = KVPoolConfig(n_pages=16, page_size=4, n_kv_heads=2, head_dim=4,
                   n_replicas=2, dtype="bfloat16")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    root = PORT.parents[1]
    files = sorted(PORT.rglob("*.py")) + [
        root / "chip_smoke.py",
        root / "tests" / "_torch_rank_worker.py",
        root / "tests" / "_torch_rank_train_worker.py",
        root / "tests" / "_torch_rank_data_worker.py",
        root / "tests" / "_torch_rank_tp_worker.py",
        root / "tests" / "_torch_serve_side.py"] + sorted(
        (root / "scripts").glob("*torch*.py")) + sorted(
        (root / "examples").glob("torch_*.py"))
    assert len(files) > 25
    assert {f.name for f in files if f.parent.name == "scripts"} == {
        "profile_torch_serve.py", "profile_torch_lm.py",
        "profile_torch_apps.py", "probe_torch_gloo.py"}
    assert {f.name for f in files if f.parent.name == "examples"} == {
        "torch_quickstart.py", "torch_serve_paged.py",
        "torch_train_micro.py", "torch_elastic_restart.py"}
    scanned = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"parallel/__init__.py", "parallel/sharding.py",
            "parallel/pipeline.py", "parallel/dist.py", "launch/mesh.py",
            "launch/hloparse.py", "launch/dryrun.py",
            "launch/hillclimb.py"} <= scanned
    bad = [(str(f.relative_to(root)), name) for f in files
           for name in _imported_roots(f)
           if name in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, bad


def test_port_serves_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, "src")
        from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool
        from repro_torch.serve import ServeLoop, ToyLM
        cfg = KVPoolConfig(n_pages=8, page_size=4, n_kv_heads=2,
                           head_dim=4, n_replicas=2, dtype="bfloat16")
        pool = SELCCKVPool(cfg, device="cpu")
        pool.open_rounds_plane()
        loop = ServeLoop(pool, ToyLM(cfg, n_q_heads=4), n_slots=2,
                         max_pages=4, prefill_chunk=4)
        reqs = [loop.submit([1, 2, 3], 4), loop.submit([9], 2)]
        assert loop.drain(timeout=60)
        assert [len(r.generated) for r in reqs] == [4, 2]
        from repro_torch.launch.serve import main
        for arch in ("qwen3-1.7b", "mamba2-2.7b", "deepseek-moe-16b",
                     "starcoder2-7b", "recurrentgemma-2b",
                     "llava-next-mistral-7b", "seamless-m4t-medium"):
            res = main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "32",
                        "--gen", "2"])
            assert res["tokens"] == 4 and res["finite"]
        from repro_torch.index import DeviceBTree
        tree = DeviceBTree.create(4, 64, fanout=4, device="cpu")
        tree.insert_batch(list(range(40, 0, -3)), list(range(14)))
        assert tree.lookup_batch([40, 1, 2])[1].tolist() == [True, True,
                                                             False]
        tree.check_invariants()
        from repro_torch.apps import (DeviceTxnConfig, DeviceTxnEngine,
                                      TxnBatchConfig, device_txn_batches)
        from repro_torch.core.rounds import (DevicePlane, make_state,
                                             txn_payload_width)
        cfg = TxnBatchConfig(n_gcls=12, tuples_per_gcl=4, batch=8, iters=1)
        eng = DeviceTxnEngine(DevicePlane.open(make_state(
            4, 12, payload_width=txn_payload_width(4), device="cpu")),
            DeviceTxnConfig(algo="to", tuples_per_gcl=4))
        txns, node, ts = device_txn_batches(cfg)[0]
        assert len(eng.run_batch(node, txns, ts)[0].decision) == 8
        import tempfile
        import torch
        from repro_torch import convert
        from repro_torch.launch.specs import train_inputs
        from repro_torch.launch.train import main as train_main
        from repro_torch.optim import AdamWConfig, compress_grads
        from repro_torch.runtime import (FailureDetector, StragglerWatchdog,
                                         plan_elastic_mesh)
        from repro_torch.train import TrainConfig, init_train_state
        with tempfile.TemporaryDirectory() as d:
            for arch in ("qwen3-1.7b", "mamba2-2.7b"):
                argv = ["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "32",
                        "--ckpt", d + "/" + arch]
                rec = train_main(argv)
                assert rec["grads_missing"] == 0 and len(rec["losses"]) == 2
                assert train_main(argv + ["--resume"])["steps"] == []
        from repro_torch.configs import get_smoke_config
        tcfg = TrainConfig(compress_grads=True, opt=AdamWConfig(
            m_dtype="int8", v_mode="int8"))
        state = init_train_state(get_smoke_config("qwen3-1.7b"), tcfg,
                                 torch.Generator(), "cpu")
        back = convert.train_state_to_torch(
            convert.train_state_to_numpy(state), "cpu")
        assert back["opt"]["mu"]["embed"]["m"]["q"].dtype == torch.int8
        compress_grads(state["params"])
        assert plan_elastic_mesh(4, 2, [1]).new_data_size == 3
        FailureDetector(["h0"]).sweep()
        StragglerWatchdog().observe(1.0, 0)
        assert train_inputs(get_smoke_config("seamless-m4t-medium"), 32,
                            2)["enc_embeds"].shape == (2, 8, 64)
        from repro_torch.apps import BLinkTree
        from repro_torch.core import ClusterConfig, SELCCLayer
        from repro_torch.core.rounds import (FlightRecorder, plan_replication,
                                             stripe_state, unstripe_state)
        layer = SELCCLayer(ClusterConfig(n_compute=2, n_memory=2,
                                         threads_per_node=2))
        bt = BLinkTree(layer, layer.nodes[0], fanout=8)
        def work():
            for i in range(20):
                yield from bt.insert(i, i)
            return (yield from bt.lookup(7))
        p = layer.env.process(work())
        layer.env.run_until_complete([p], hard_limit=100)
        assert p.value == 7
        layer.assert_released()
        plane = layer.as_plane(payload_width=2, device="cpu")
        plane.attach_recorder(FlightRecorder(8))
        res = plane.ops([0, 1], [3, 3], [1, 0], [[5, 6], [0, 0]])
        assert plane.recorder.total == 1
        assert plan_replication(res.telemetry).tolist() == []  # a write
        st = unstripe_state(stripe_state(plane.state, 2), 2)
        assert all(torch.equal(st[k], plane.state[k]) for k in st)
        kv = layer.make_kv_pool(KVPoolConfig(
            n_pages=8, page_size=4, n_kv_heads=2, head_dim=4,
            n_replicas=2, dtype="bfloat16"), device="cpu")
        kv.append([1], [0], torch.ones(1, 2, 4), torch.ones(1, 2, 4))
        assert kv.read(1, [1])[0][0, 0].float().sum().item() == 8.0
        from repro_torch.apps import (DeviceRoundsConfig, MicroConfig,
                                      TPCCConfig, TPCCTables, TxnConfig,
                                      TxnEngine, device_rounds_batches,
                                      micro_worker, parity_worker,
                                      tpcc_worker)
        gcls = layer.allocate_many(16)
        mcfg = MicroConfig(n_gcls=16, zipf_theta=0.99, ops_per_thread=10)
        procs = [layer.env.process(micro_worker(nd, gcls, mcfg, nd.node_id,
                                                2, 0, 1))
                 for nd in layer.nodes]
        procs.append(layer.env.process(parity_worker(layer.nodes[0],
                                                     gcls[:4], 1, 2)))
        layer.env.run_until_complete(procs, hard_limit=100)
        tcfg = TPCCConfig(warehouses=2, txns_per_thread=4)
        tables = TPCCTables(tcfg)
        engines = [TxnEngine(layer, nd, TxnConfig(algo="to"),
                             tables.n_tuples) for nd in layer.nodes]
        procs = [layer.env.process(tpcc_worker(e, tables, tcfg, 0, i, 2, 0,
                                               3))
                 for i, e in enumerate(engines)]
        layer.env.run_until_complete(procs, hard_limit=100)
        assert sum(e.stats.commits + e.stats.aborts for e in engines) == 8
        layer.assert_released()
        assert len(device_rounds_batches(DeviceRoundsConfig(iters=2))) == 2
        from repro_torch.core.rounds import Mesh
        from repro_torch.launch.mesh import (make_local_mesh,
                                             make_mesh_from_devices)
        from repro_torch.models import moe
        from repro_torch.parallel import (ShardingPolicy, make_ctx,
                                          param_specs, to_named)
        from repro_torch.parallel.pipeline import (pipeline_forward,
                                                   split_stages)
        from repro_torch.train.step import state_shapes, state_specs
        mcfg = get_smoke_config("dbrx-132b")
        mesh = make_mesh_from_devices(list(range(8)), data=2, model=4,
                                      device="cpu")
        ctx = make_ctx(mesh, mcfg, ShardingPolicy())
        p = moe.init_moe(torch.Generator(), mcfg, torch.float32)
        y, aux = moe.moe_ffn(torch.ones(4, 8, mcfg.d_model), p, mcfg, ctx)
        assert ctx.ep == 4 and torch.isfinite(y).all()
        shapes = state_shapes(mcfg, TrainConfig())
        assert len(to_named(mesh, state_specs(mesh, shapes,
                                              TrainConfig()))) == 2
        assert param_specs(make_local_mesh("cpu"), shapes["params"])
        y = pipeline_forward(lambda w, h: h @ w[0], split_stages(
            torch.eye(4)[None].repeat(4, 1, 1), 2), torch.ones(3, 1, 4),
            mesh=Mesh({"pipe": 2}, "cpu"))
        assert torch.equal(y, torch.ones(3, 1, 4))
        import os
        flags = os.environ.get("XLA_FLAGS")
        from repro_torch.launch import dryrun, hillclimb
        from repro_torch.launch.hloparse import analyze
        from repro_torch.models.config import ShapeSpec
        assert os.environ.get("XLA_FLAGS") == flags
        hlo = analyze("ENTRY %m (p: f32[4,8]) -> f32[4,8] {\\n"
                      "  %p = f32[4,8]{1,0} parameter(0)\\n"
                      "  ROOT %ar = f32[4,8]{1,0} all-reduce(f32[4,8]{1,0} "
                      "%p), replica_groups=[2,4]<=[8], to_apply=%add\\n}\\n")
        assert hlo["collectives"]["all-reduce"]["count"] == 1
        with tempfile.TemporaryDirectory() as d:
            rec = dryrun.run_cell(get_smoke_config("qwen3-1.7b"),
                                  ShapeSpec("s", 32, 32, "train"), False, d)
        assert rec["status"] == "ok", rec.get("traceback")
        assert "qwen_v1_notp" in hillclimb.VARIANTS
        sys.path.insert(0, "examples")
        import torch_quickstart
        seen = torch_quickstart.run("cpu", say=lambda *a: None)
        assert seen["lookup"] == 137 * 137 and seen["rdma"] == 0
        assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                             if v is not None}
        assert "ml_dtypes" not in sys.modules
        print("PORT_WITHOUT_JAX_OK")
    """)
    root = PORT.parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert "PORT_WITHOUT_JAX_OK" in out.stdout, out.stderr[-3000:]


def test_a_rank_runs_with_jax_blocked(tmp_path):
    """One rank (world 1, a gloo group through a ``file://``
    rendezvous) in a subprocess where ``jax`` and ``repro`` cannot be
    imported: the ranked plane, expert-parallel ``moe_ffn`` and the
    pipeline over the group equal the same meshes without one."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, "src")
        sys.path.insert(0, "tests")
        import _torch_rank_worker as W
        assert W.one_rank({str(tmp_path)!r})
        assert "jax" not in {{m.split(".")[0] for m, v in sys.modules.items()
                             if v is not None}}
        print("RANK_WITHOUT_JAX_OK")
    """)
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=PORT.parents[1], capture_output=True,
                         text=True, timeout=120)
    assert "RANK_WITHOUT_JAX_OK" in out.stdout, out.stderr[-3000:]


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SELCCKVPool(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_state(2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_state(2, 4, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBTree.create(4, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.to_torch({"words": np.zeros((4, 2), np.int32)})
    from repro_torch.core import SELCCLayer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SELCCLayer().as_plane()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SELCCLayer.make_kv_pool(CFG)
    assert make_state(2, 4, device="cpu")["words"].device.type == "cpu"
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serve_step(cfg, make_local_mesh())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "qwen3-1.7b", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_to_torch({"embed": np.zeros((4, 2), np.float32)})
    for arch in ("deepseek-moe-16b", "recurrentgemma-2b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.init_params(get_smoke_config(arch), torch.Generator())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_main(["--arch", arch, "--smoke", "--requests", "1"])
    # the dry-run is the exception: fake tensors, no device to ask for
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeSpec
    rec = dryrun.run_cell(cfg, ShapeSpec("s", 32, 2, "decode"), False,
                          tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    step, prefill, _ = build_serve_step(cfg, make_local_mesh("cpu"))
    params = lm.init_params(cfg, torch.Generator(), device="cpu")
    logits, _ = prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert logits.device.type == "cpu"
    assert serve_main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                       "--requests", "1", "--prompt-len", "4",
                       "--gen", "2"])["tokens"] == 2


def test_cpu_run_launches_no_kernel():
    kernels.reset_launch_counts()
    pool = SELCCKVPool(CFG, device="cpu")
    pool.open_rounds_plane()
    loop = ServeLoop(pool, ToyLM(CFG, n_q_heads=4), n_slots=2,
                     max_pages=4, prefill_chunk=4)
    loop.submit([4, 5, 6], 3)
    assert loop.drain(timeout=60)
    assert loop.stats().attend_calls > 0
    legacy = SELCCKVPool(CFG, device="cpu")
    legacy.append([2], [1], torch.ones(1, 2, 4), torch.ones(1, 2, 4))
    legacy.read(0, [2, 3])
    legacy.attend(torch.ones(1, 4, 4), [[2]], [2])
    tree = DeviceBTree.create(4, 32, fanout=4, device="cpu")
    tree.insert_batch([3, 1, 2, 9, 7], [30, 10, 20, 90, 70])
    assert tree.scan_batch([2], 3)[0] == [(2, 20), (3, 30), (7, 70)]
    for arch in ("deepseek-moe-16b", "recurrentgemma-2b",
                 "llava-next-mistral-7b", "seamless-m4t-medium"):
        assert serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "1", "--prompt-len", "8",
                           "--gen", "2"])["tokens"] == 2
    for arch in ("qwen3-1.7b", "mamba2-2.7b"):
        rec = train_main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "1", "--batch", "2", "--seq", "32"])
        assert rec["launches"] == [kernels.launch_counts()]
    assert kernels.launch_counts() == {"latch_ops": 0, "gcl_fetch": 0,
                                       "paged_attention": 0,
                                       "flash_attention": 0,
                                       "ssd_intra": 0,
                                       "flash_attention_bwd": 0,
                                       "ssd_intra_bwd": 0}


def test_convert_round_trip_keeps_dtypes_and_bits():
    rng = np.random.default_rng(0)
    tree = {"words": rng.integers(-2**31, 2**31, (6, 2)).astype(np.int32),
            "cache_state": rng.integers(0, 3, (3, 6)).astype(np.int8),
            "dirty": rng.random((3, 6)) < 0.5,
            "mem_data": rng.integers(-2**31, 2**31, (6, 5)).astype(
                np.int32)}
    back = convert.to_numpy(convert.to_torch(tree, "cpu"))
    for k, v in tree.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_train_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    from repro_torch.train import TrainConfig, build_train_step, \
        init_train_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(cfg, make_local_mesh(), TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, TrainConfig(), torch.Generator())
    rec = train_main(["--smoke", "--device", "cpu", "--production-mesh",
                      "--steps", "1", "--batch", "2", "--seq", "32"])
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["n_micro"] == 1
    assert np.isfinite(rec["losses"]).all() and rec["grads_missing"] == 0


def test_train_state_round_trip_keeps_dtypes_and_bits():
    """bf16 parameters (as raw uint16 bits on the numpy side), int8 m and
    v blocks, fp32 scales, the int32 step and the error-feedback tree."""
    from repro_torch import tree as pt
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state
    tcfg = TrainConfig(compress_grads=True, opt=AdamWConfig(
        m_dtype="int8", v_mode="int8"))
    state = init_train_state(get_smoke_config("mamba2-2.7b"), tcfg,
                             torch.Generator().manual_seed(1), "cpu")
    as_np = convert.train_state_to_numpy(state)
    assert as_np["params"]["embed"].dtype == np.uint16
    back = convert.train_state_to_torch(as_np, "cpu")
    for a, b in zip(pt.leaves(state), pt.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
