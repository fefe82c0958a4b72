"""Nothing the benchmark runs imports JAX or the JAX package: no module
of ``perfbench/`` names ``jax``, ``jaxlib``, ``flax`` or ``repro`` as a
top-level import, the references and controls import nothing of the
program either, and a cell runs in a process where those cannot be
imported.  Top-level names are compared whole: ``repro_torch`` is the
port, ``repro`` the JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench.lib import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = list((ROOT / "perfbench").rglob("*.py"))
    assert files
    for f in files:
        if f.parent.name == "tests":
            continue
        assert not imports(f) & FORBIDDEN, f


def test_references_and_controls_import_nothing_of_the_program():
    for part in ("references", "controls", "generators"):
        for f in (ROOT / "perfbench" / part).glob("*.py"):
            assert "repro_torch" not in imports(f), f


BLOCKED = r'''
import importlib.abc, json, sys
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} may not be imported here")
        return None

sys.meta_path.insert(0, Block())
sys.path[0:0] = [ROOT, ROOT + "/src"]
from perfbench.lib import harness
from perfbench.tests._run import CELLS, tiny
for cell in CELLS:
    rc = harness.main(["--workload", cell, "--seed", "9", "--seconds",
                       "0.2", "--trace", "1"],
                      device="cpu", overrides=tiny(cell),
                      trace_seconds=0.1)
    assert rc == 0
bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not bad, bad
'''


def test_a_cell_runs_where_jax_and_repro_cannot_import():
    env = dict(os.environ, PYTHONPATH="")
    code = f"ROOT = {str(ROOT)!r}\n" + BLOCKED
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert len(lines) == 2 and all(x["correct"] for x in lines), \
        p.stderr[-4000:]


def test_without_the_port_a_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[0:0] = [sys.argv[1]]\n"
            "from perfbench.lib import harness\n"
            "sys.exit(harness.main(['--workload', 'btree.ycsb-c', '--seed', "
            "'1', '--seconds', '0.1'], root=sys.argv[1], device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=""), timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "repro_torch" in p.stderr
