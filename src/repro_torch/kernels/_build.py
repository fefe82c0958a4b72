"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, with its own ``nvcc`` process, into
``lib<name>.so`` — a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes).  All sources
build at once, in parallel, at the first launch of any kernel.  The
libraries land in ``build/repro_torch/<key>/`` at the repository root,
where ``<key>`` hashes the sources, the flags and the compiler path: an
edited source builds afresh, an unchanged one is reused.  Nothing here
runs at import time, so the CPU-only tests import every kernel module
without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}        # name -> compiler output of the last build


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build on the machine with the GPU")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_path().encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source not yet built for the current key, one
    ``nvcc`` per source, all started together.  Raises with the
    compiler's output if any fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources()
            if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode:
            failed.append(f"--- {src.name} (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` (building all sources on first use),
    with ``signatures`` — ``{function: argtypes}``, each returning a
    CUDA error code as ``int`` — declared on it.  Pointers and streams
    must be declared ``c_void_p``, or ctypes cuts them to 32 bits."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
