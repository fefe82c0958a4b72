"""Fault-tolerant checkpointing: async, integrity-checked; port of
``repro.checkpoint.ckpt`` with the same on-disk layout, so either
package restores what the other saved, bit for bit::

    <dir>/step_000123.tmp/...      while writing
    <dir>/step_000123/
        manifest.json              tree structure, shapes, dtypes, crc32s
        leaf_00000.npy ...         one file per leaf, in jax.tree.flatten
                                   order (dict keys sorted)

A bf16 leaf is stored as its raw bytes (a uint8 array whose last axis is
twice as long) under the dtype name ``bfloat16``, as JAX stores it
(numpy has no bf16; the port never needs ``ml_dtypes``); each leaf's
crc32 is over its raw bytes.  Publishing is an atomic rename of
``step_N.tmp``.  Saves are async: the tensors are copied to host memory
on the calling thread (so the training step may update its state in
place right after), and written on a background thread; ``wait()``
joins.  Restore takes the newest step whose manifest verifies.  It
places every leaf on the device of the matching leaf of ``tree_like``,
or, given
``shardings`` (a matching tree of ``parallel.sharding.NamedSharding``,
e.g. ``to_named(mesh, state_specs(mesh, ...))`` of a new mesh after an
elastic remesh), on its sharding's mesh device, refusing a spec that
does not divide the leaf's shape as JAX's placement would.

Over ``torch.distributed`` ranks (``shardings`` over a mesh with a
``group``) a checkpoint is the same whatever the world size: ``save``
all-gathers the leaves each rank holds as its block (a sharding's
``rank_dim``: the routed experts and their optimizer state) on every
rank, synchronously and before any write, and only the group's rank 0
writes the whole state in the one-process layout; ``restore`` waits at
a barrier for rank 0's publish (rank 0 joins its pending write first),
reads the whole state on every rank and keeps each ranked leaf's block.
"""

from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from .. import tree as pt

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "int32": torch.int32,
                 "int64": torch.int64, "uint8": torch.uint8,
                 "bool": torch.bool, "float16": torch.float16}


def _host(x):
    """(numpy array of the leaf's raw values, dtype name): a copy, so the
    caller may change the tensor afterwards; bf16 as uint16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.array(x, copy=True)
    return arr, arr.dtype.name


def _storable(arr, dtype_name):
    return arr.view(np.uint8) if dtype_name == "bfloat16" else arr


def _loaded(arr, dtype_name, shape):
    """The stored array back as numpy raw values (bf16 as uint16 bits)."""
    if dtype_name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr.reshape(shape)


def _crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _ranked_mesh(shardings):
    """The ranked mesh of a tree of shardings, or None."""
    if shardings is None:
        return None
    for sh in pt.leaves(shardings):
        if getattr(sh.mesh, "ranked", False):
            return sh.mesh
    return None


def save(tree, step: int, directory, async_: bool = False, shardings=None):
    """Write ``tree`` (nested dicts/lists of tensors or arrays) as step
    ``step``; returns the writer thread when ``async_`` else None.  With
    ``shardings`` over a ranked mesh every rank calls it: the ranked
    leaves are all-gathered, and only rank 0 writes."""
    directory = Path(directory)
    leaves, spec = pt.flatten(tree)
    mesh = _ranked_mesh(shardings)
    if mesh is not None:
        places = pt.leaves(shardings)
        if len(places) != len(leaves):
            raise ValueError("shardings/tree structure mismatch")
        leaves = [x if sh.rank_dim is None
                  else mesh.all_gather(x.contiguous(), sh.rank_dim)
                  for x, sh in zip(leaves, places)]
        if mesh.rank != 0:
            return None
    directory.mkdir(parents=True, exist_ok=True)
    host = [_host(x) for x in leaves]
    del leaves

    def _write():
        tmp = directory / f"step_{step:06d}.tmp"
        final = directory / f"step_{step:06d}"
        tmp.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "treedef": repr(spec), "leaves": []}
        for i, (arr, dtype_name) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, _storable(arr, dtype_name))
            manifest["leaves"].append({
                "file": fname, "shape": list(arr.shape),
                "dtype": dtype_name, "crc32": _crc(arr)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def verify_manifest(step_dir: Path) -> bool:
    mf = Path(step_dir) / "manifest.json"
    if not mf.exists():
        return False
    try:
        manifest = json.loads(mf.read_text())
        for leaf in manifest["leaves"]:
            arr = _loaded(np.load(Path(step_dir) / leaf["file"]),
                          leaf["dtype"], leaf["shape"])
            if _crc(arr) != leaf["crc32"]:
                return False
        return True
    except Exception:  # noqa: BLE001 - any corruption = invalid
        return False


def _steps(directory: Path):
    return sorted((int(p.name.split("_")[1]) for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp")), reverse=True)


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    for s in _steps(directory):
        if verify_manifest(directory / f"step_{s:06d}"):
            return s
    return None


def _to_tensor(arr, dtype_name, device):
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
        if dtype_name in _TORCH_DTYPES:
            t = t.to(_TORCH_DTYPES[dtype_name])
    return t.to(device)


def restore(tree_like, directory, step: int | None = None, shardings=None):
    """(tree, step): the checkpoint in the structure of ``tree_like``,
    each leaf a tensor on the device of ``tree_like``'s leaf (a leaf
    that is not a tensor gives a CPU tensor), or with ``shardings`` on
    its sharding's device after its spec is checked against the leaf's
    shape; over a ranked mesh every rank calls it, after rank 0's save
    has returned, and gets its block of each ranked leaf."""
    directory = Path(directory)
    mesh = _ranked_mesh(shardings)
    if mesh is not None:
        mesh.barrier()
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    step_dir = directory / f"step_{step:06d}"
    if not verify_manifest(step_dir):
        raise IOError(f"checkpoint {step_dir} failed integrity check")
    manifest = json.loads((step_dir / "manifest.json").read_text())
    leaves, spec = pt.flatten(tree_like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError("checkpoint/tree structure mismatch")
    placements = [None] * len(leaves) if shardings is None \
        else pt.leaves(shardings)
    if len(placements) != len(leaves):
        raise ValueError("shardings/tree structure mismatch")
    out = []
    for info, ref, sh in zip(manifest["leaves"], leaves, placements):
        arr = _loaded(np.load(step_dir / info["file"]), info["dtype"],
                      info["shape"])
        if sh is not None:
            arr = sh.block(arr)
            sh.check(arr.shape)
            dev = sh.device
        else:
            dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        out.append(_to_tensor(arr, info["dtype"], dev))
    return pt.unflatten(spec, out), step


class CheckpointManager:
    """Keeps N newest checkpoints, async by default, join-safe.
    ``shardings`` (a tree matching the saved state) is the default of
    :meth:`save` and :meth:`restore`: over a ranked mesh every rank
    calls both, and only rank 0 writes and prunes."""

    def __init__(self, directory, keep: int = 3, async_: bool = True,
                 shardings=None):
        self.directory = Path(directory)
        self.keep = keep
        self.async_ = async_
        self.shardings = shardings
        mesh = _ranked_mesh(shardings)
        self.writer = mesh is None or mesh.rank == 0
        self._pending: threading.Thread | None = None

    def save(self, tree, step: int) -> None:
        self.wait()
        self._pending = save(tree, step, self.directory, async_=self.async_,
                             shardings=self.shardings)
        if not self.async_ and self.writer:
            self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def restore(self, tree_like, shardings=None):
        self.wait()
        return restore(tree_like, self.directory,
                       shardings=self.shardings if shardings is None
                       else shardings)

    def _gc(self) -> None:
        for s in _steps(self.directory)[self.keep:]:
            shutil.rmtree(self.directory / f"step_{s:06d}",
                          ignore_errors=True)
