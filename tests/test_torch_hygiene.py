"""The port stands alone: no JAX, no ``repro``, no quiet CPU fallback.

* an AST scan finds no import of ``jax`` or ``repro`` anywhere under
  ``src/repro_torch``, in ``chip_smoke.py`` or in the profiling script;
* a subprocess in which ``jax`` and ``repro`` cannot be imported still
  imports the port and serves a small trace on the CPU;
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
from repro_torch.serve import ServeLoop, ToyLM  # noqa: E402

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
        root / "chip_smoke.py", root / "scripts" / "profile_torch_serve.py"]
    assert len(files) > 15
    bad = [(str(f.relative_to(root)), name) for f in files
           for name in _imported_roots(f)
           if name in ("jax", "jaxlib", "repro")]
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
        assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                             if v is not None}
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
        convert.to_torch({"words": np.zeros((4, 2), np.int32)})
    assert make_state(2, 4, device="cpu")["words"].device.type == "cpu"


def test_cpu_run_launches_no_kernel():
    kernels.reset_launch_counts()
    pool = SELCCKVPool(CFG, device="cpu")
    pool.open_rounds_plane()
    loop = ServeLoop(pool, ToyLM(CFG, n_q_heads=4), n_slots=2,
                     max_pages=4, prefill_chunk=4)
    loop.submit([4, 5, 6], 3)
    assert loop.drain(timeout=60)
    assert loop.stats().attend_calls > 0
    assert kernels.launch_counts() == {"latch_ops": 0, "gcl_fetch": 0,
                                       "paged_attention": 0}


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
