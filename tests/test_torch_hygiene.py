"""The port stands alone: no JAX, no ``repro``, no quiet CPU fallback.

* an AST scan finds no import of ``jax``, ``repro`` or ``ml_dtypes``
  (the card's machine has none) anywhere under
  ``src/repro_torch``, in ``chip_smoke.py`` or in the profiling scripts;
* a subprocess in which ``jax`` and ``repro`` cannot be imported still
  imports the port, serves a small trace on the CPU, runs the LM serve
  of the dense, ssm, moe, hybrid, vlm and encdec families (the moe FFN
  and the RG-LRU modules with them), the B-link tree, a transaction
  batch, and the training stack (``launch.train`` with a checkpoint and
  a resume, the optimizer tiers, gradient compression, the fault
  runtime, the input specs and the train-state conversions);
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
        root / "chip_smoke.py", root / "scripts" / "profile_torch_serve.py",
        root / "scripts" / "profile_torch_lm.py",
        root / "scripts" / "profile_torch_apps.py"]
    assert len(files) > 25
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
        assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                             if v is not None}
        assert "ml_dtypes" not in sys.modules
        print("PORT_WITHOUT_JAX_OK")
    """)
    root = PORT.parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert "PORT_WITHOUT_JAX_OK" in out.stdout, out.stderr[-3000:]


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
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
    assert make_state(2, 4, device="cpu")["words"].device.type == "cpu"
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serve_step(cfg)
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
    step, prefill, _ = build_serve_step(cfg, device="cpu")
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
        build_train_step(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, TrainConfig(), torch.Generator())
    with pytest.raises(NotImplementedError, match="item 9"):
        train_main(["--smoke", "--device", "cpu", "--production-mesh"])


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
