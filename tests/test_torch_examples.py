"""The port's examples (``examples/torch_*.py``) against the reference's.

Each ``torch_*`` example runs to its end on the CPU at its smallest
setting, in this process (pinned to one thread).  The reference's
examples run in one subprocess each with ``JAX_PLATFORMS=cpu``; under
jax 0.9 ``jax.make_mesh``'s ``Explicit`` axes make the reference's
``build_train_step`` fail (ROADMAP.md queue 3), so that subprocess
gives ``repro.launch.mesh.make_local_mesh`` the same (1, 1) mesh with
``Auto`` axes, and points the reference's checkpoint directories into
the test's own.  Held:

* ``torch_quickstart`` prints ``examples/quickstart.py``'s lines, and
  its device plane reads the written line at the written version;
* ``torch_serve_paged``'s ``[check]`` line, its ``[coherence]`` lines
  and its engine counts equal the reference example's;
* ``torch_train_micro --tiny`` and ``torch_elastic_restart``: finite
  losses; the tiny run's loss falls over 40 steps as the reference's
  does, and the elastic walkthrough's losses stay within 1 % of the
  reference's step by step; the elastic plan's lines are equal;
* ``chip_smoke.py``'s examples phase, rehearsed on the CPU.
"""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_threads import _one_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TINY_STEPS = 40

REFERENCE = textwrap.dedent("""
    import runpy, sys
    sys.path.insert(0, "src")
    import numpy as np, jax
    from jax.sharding import Mesh
    import repro.launch.mesh as rm
    rm.make_local_mesh = lambda: Mesh(
        np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    import repro.checkpoint as rc
    real, ckpt = rc.CheckpointManager, sys.argv[1]

    class Redirected(real):
        def __init__(self, directory, *a, **k):
            super().__init__(ckpt, *a, **k)
    rc.CheckpointManager = Redirected
    sys.argv = sys.argv[2:]
    runpy.run_path(sys.argv[0], run_name="__main__")
""")


def _reference(name, tmp, *args):
    """The reference example's standard output, its lines."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp / f"ref_{name}_ckpt"),
         str(EXAMPLES / f"{name}.py"), *args], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def _example(name):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return __import__(f"torch_{name}")


def _capture(capsys, fn, *a, **k):
    capsys.readouterr()
    res = fn(*a, **k)
    return res, capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_lines(capsys, tmp_path):
    """The same lines as ``examples/quickstart.py``, in order; the same
    cluster's device plane serves the written line at its version."""
    res, lines = _capture(capsys, _example("quickstart").main,
                          ["--device", "cpu"])
    assert lines == _reference("quickstart", tmp_path)
    assert res["rdma"] == 0 and res["lookup"] == 137 * 137
    assert res["plane_versions"] == (1, 1)


def _serve_summary(lines):
    """The lines the two serves must share: ``[check]``, ``[coherence]``
    and the engine's counts (its rates are timings)."""
    engine = [ln for ln in lines if ln.startswith("[engine]")]
    assert len(engine) == 1
    counts = re.sub(r"in [0-9.]+s \([0-9]+ tok/s\), ", "", engine[0])
    return [counts] + [ln for ln in lines
                       if ln.startswith(("[check]", "[coherence]"))]


def test_serve_paged_matches_the_reference(capsys, tmp_path):
    """``[check]`` (the engine's tokens equal the hand-rolled loop's for
    all 8 sequences), both ``[coherence]`` lines and the engine's ticks,
    rows, rounds and pages in use equal the reference's."""
    res, lines = _capture(capsys, _example("serve_paged").main,
                          ["--device", "cpu"])
    want = _serve_summary(_reference("serve_paged", tmp_path))
    assert _serve_summary(lines) == want
    assert len(want) == 4 and want[1].startswith("[check]")
    assert res["engine_tokens"] == res["ref_tokens"]


def _losses(lines, pattern):
    return {int(m.group(1)): float(m.group(2))
            for m in map(re.compile(pattern).search, lines) if m}


def test_train_micro_tiny_loss_falls_as_the_reference(capsys, tmp_path):
    """``--tiny`` for 40 steps with its checkpoints: every loss finite,
    and the loss falls from step 0 to step 39 as the reference's does
    (by more than 0.02, within half to twice the reference's fall)."""
    rec, lines = _capture(capsys, _example("train_micro").main, [
        "--tiny", "--steps", str(TINY_STEPS), "--device", "cpu",
        "--ckpt", str(tmp_path / "ckpt")])
    assert len(rec["losses"]) == TINY_STEPS
    assert np.isfinite(rec["losses"]).all()
    assert (tmp_path / "ckpt" / f"step_{TINY_STEPS - 1:06d}").is_dir()
    pat = r"\[train\] step +(\d+) loss +([0-9.]+)"
    got = _losses(lines, pat)
    want = _losses(_reference("train_micro", tmp_path, "--tiny", "--steps",
                              str(TINY_STEPS), "--ckpt",
                              str(tmp_path / "ref_ckpt")), pat)
    last = TINY_STEPS - 1
    assert sorted(got) == sorted(want) == [0, 20, last]
    fall, ref_fall = got[0] - got[last], want[0] - want[last]
    assert ref_fall > 0.02 and fall > 0.02
    assert 0.5 * ref_fall <= fall <= 2 * ref_fall, (got, want)
    assert torch.allclose(torch.tensor(rec["losses"][::20] + [rec[
        "losses"][last]]), torch.tensor([got[0], got[20], got[last]]),
        atol=1e-4)


def test_elastic_restart_matches_the_reference(capsys, tmp_path):
    """The walkthrough's phases, the detector's verdict and the elastic
    plan print the reference's lines; the seven losses are finite and
    within 1 % of the reference's step by step; the restore resumes
    after step 3 at batch 6."""
    res, lines = _capture(capsys, _example("elastic_restart").main,
                          ["--device", "cpu", "--ckpt",
                           str(tmp_path / "ckpt")])
    want = _reference("elastic_restart", tmp_path)
    plan = ("[", "  detector verdict", "  elastic plan")
    assert [ln for ln in lines if ln.startswith(plan)] == \
        [ln for ln in want if ln.startswith(plan)]
    pat = r"step (\d+): loss ([0-9.]+)"
    got, ref = _losses(lines, pat), _losses(want, pat)
    assert sorted(got) == sorted(ref) == list(range(7))
    assert np.isfinite(list(got.values())).all()
    for s in got:
        assert got[s] == pytest.approx(ref[s], rel=1e-2), s
    assert res["restored_step"] == 3 and res["dead"] == ["h1"]
    assert "(batch 6)" in lines[-2]


def test_chip_smoke_examples_phase_on_cpu(monkeypatch):
    """``chip_smoke.py``'s examples phase rehearsed on the CPU (a few
    train steps): every device example runs to its end, with its checks,
    and launches no kernel here."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels
    out, launches = cs.examples_phase(torch.device("cpu"), kernels, steps=3)
    assert sorted(out) == ["elastic_restart", "serve_paged", "train_micro"]
    assert out["serve_paged"]["reads"] == [True, False, True, True, False]
    assert len(out["train_micro"]["losses"]) == 3
    assert out["elastic_restart"]["micro_batches"] == [8] * 4 + [6] * 3
    assert all(not c for c in launches.values())

