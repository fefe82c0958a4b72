"""The port's GPipe pipeline against the JAX package's.

One stage in process against the reference on a one-device ``pipe``
mesh; four stages against the reference run once in a subprocess on an
``Auto`` mesh of 4 CPU devices (``jax.sharding.Mesh``: the reference's
own four-stage test builds its mesh with ``jax.make_mesh``, whose
``Explicit`` axes fail under jax 0.9) and against the unpipelined layer
loop, rtol 1e-5 (against JAX with an atol of 1e-6); ``split_stages`` and
``bubble_fraction``; the schedule runs each stage's body only while the
stage is active; ``chip_smoke.pipeline_check`` rehearsed.
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.parallel import pipeline as jpipe  # noqa: E402
from repro_torch.core.rounds import Mesh  # noqa: E402
from repro_torch.parallel import pipeline as tpipe  # noqa: E402


def _stage(params, x):
    """The reference tests' stage body: tanh(h @ w) over the stage's
    layers."""
    h = x
    for w in params["w"]:
        h = torch.tanh(h @ w)
    return h


def _unpipelined(w, x):
    out = []
    for xm in x:
        h = xm
        for wi in w:
            h = torch.tanh(h @ wi)
        out.append(h)
    return torch.stack(out)


def test_split_stages_shapes():
    p = {"w": torch.zeros((8, 4, 4)), "b": torch.zeros((8, 4))}
    s = tpipe.split_stages(p, 4)
    assert s["w"].shape == (4, 2, 4, 4) and s["b"].shape == (4, 2, 4)
    with pytest.raises(AssertionError, match="layers 8 % stages 3"):
        tpipe.split_stages(p, 3)


@pytest.mark.parametrize("stages,micro", [(1, 8), (4, 12), (4, 4), (8, 8)])
def test_bubble_fraction_matches_jax(stages, micro):
    assert tpipe.bubble_fraction(stages, micro) == \
        jpipe.bubble_fraction(stages, micro)


def test_single_stage_pipeline_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 8, 8)).astype(np.float32)
    x = rng.normal(size=(6, 2, 8)).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("pipe",))

    def jstage(params, h):
        def layer(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(layer, h, params["w"])[0]
    want = jpipe.pipeline_forward(jstage, jpipe.split_stages(
        {"w": jnp.asarray(w)}, 1), jnp.asarray(x), mesh=mesh, axis="pipe")
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    got = tpipe.pipeline_forward(_stage, tpipe.split_stages({"w": tw}, 1),
                                 tx, mesh=Mesh({"pipe": 1}, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _unpipelined(tw, tx).numpy(),
                               rtol=1e-5)


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.pipeline import pipeline_forward, split_stages

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("pipe",))
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32)
    x = rng.normal(size=(8, 4, 16)).astype(np.float32)

    def stage_fn(params, x):
        def layer(h, wi):
            return jnp.tanh(h @ wi), None
        h, _ = jax.lax.scan(layer, x, params["w"])
        return h

    y = pipeline_forward(stage_fn, split_stages({"w": jnp.asarray(w)}, 4),
                         jnp.asarray(x), mesh=mesh, axis="pipe")
    np.savez(sys.argv[1], w=w, x=x, y=np.asarray(y))
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline_ref") / "ref.npz"
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    return dict(np.load(path))


def test_four_stage_pipeline_matches_jax_and_the_loop(ref):
    """Four stages of two layers, eight micro-batches: the unpipelined
    loop, rtol 1e-5; the reference's pipeline on four devices, rtol 1e-5
    with an atol of 1e-6 (the two libraries' fp32 tanh and products
    differ by ~3e-7 near zero, where no rtol holds)."""
    w, x = torch.from_numpy(ref["w"]), torch.from_numpy(ref["x"])
    got = tpipe.pipeline_forward(_stage, tpipe.split_stages({"w": w}, 4), x,
                                 mesh=Mesh({"pipe": 4}, "cpu"))
    np.testing.assert_allclose(got.numpy(), ref["y"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _unpipelined(w, x).numpy(),
                               rtol=1e-5)


def test_schedule_runs_only_active_stages():
    """Stage s runs micro-batch t - s at step t, so each stage's body
    runs M times in all, and the micro-batches reach each stage in
    order; fewer micro-batches than stages are refused."""
    calls = []

    def stage(params, h):
        calls.append((int(params["id"]), int(h[0, 0])))
        return h + 1

    m, n = 6, 3
    x = torch.arange(m, dtype=torch.float32)[:, None, None].expand(m, 1, 2) \
        * 10
    params = {"id": torch.arange(n)}
    out = tpipe.pipeline_forward(stage, params, x.contiguous(),
                                 mesh=Mesh({"pipe": n}, "cpu"))
    torch.testing.assert_close(out, x + n)
    for s in range(n):
        assert [v for sid, v in calls if sid == s] == \
            [10 * i + s for i in range(m)]
    with pytest.raises(AssertionError, match="at least one microbatch"):
        tpipe.pipeline_forward(stage, {"id": torch.arange(4)}, x[:3],
                               mesh=Mesh({"pipe": 4}, "cpu"))


def test_chip_smoke_pipeline_check_on_cpu(monkeypatch):
    """``chip_smoke.pipeline_check`` (phase 7b's pipeline) at width 32 on
    the CPU, ``torch.cuda.synchronize`` stubbed: the same schedule and
    check as on the card."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    res = cs.pipeline_check(torch.device("cpu"), width=32, rows=4)
    assert res["stages"] == 4 and res["micro_batches"] == 8
    assert res["bubble_fraction"] == tpipe.bubble_fraction(4, 8)
    assert res["max_rel_err"] <= 1e-5
