"""Carry state between the reference and the port, bit for bit.

The two packages meet in numpy: a JAX round state (or a pool's rounds
state) becomes a dict of numpy arrays with ``{k: np.asarray(v)}``, and
:func:`to_torch` turns that into port tensors with every dtype kept —
int8 ``cache_state``, bool ``dirty``, int32 lanes.  :func:`to_numpy`
goes back.  :func:`pool_from_arrays` rebuilds a serving pool from a
rounds state and its allocator's bump pointer and free list.
:func:`lm_params_to_torch` carries a JAX LM parameter tree across, and
:func:`train_state_to_torch` / :func:`train_state_to_numpy` a whole
train state (params, the AdamW ``mu`` in any tier, ``step``, the
error-feedback tree) both ways; the port's numpy side keeps bf16 as its
raw ``uint16`` bits (it has no ``ml_dtypes``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def to_torch(tree: dict, device=None) -> dict:
    """Dict of arrays -> dict of tensors on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), same shapes, dtypes and bits."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in tree.items()}


def to_numpy(tree: dict) -> dict:
    """Dict of tensors -> dict of host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def pool_from_arrays(cfg, rounds_state: dict, *, alloc_top: int,
                     alloc_freed=(), device=None):
    """A :class:`~repro_torch.dsm.kvpool.SELCCKVPool` serving
    ``rounds_state`` (arrays, e.g. a JAX pool's ``rounds_state``), with
    its page allocator at bump pointer ``alloc_top`` and free list
    ``alloc_freed``."""
    from .dsm.kvpool import SELCCKVPool
    pool = SELCCKVPool(cfg, device=device)
    pool.open_rounds_plane(write_back="dirty" in rounds_state)
    pool.rounds_plane.state = to_torch(rounds_state, pool.device)
    pool._alloc.top = int(alloc_top)
    pool._alloc._freed = set(int(p) for p in alloc_freed)
    return pool


def _leaf_to_torch(a, dev):
    a = np.asarray(a)
    # ml_dtypes' bf16, or the port's numpy form of bf16 (its raw uint16
    # bits: no tree this module carries holds a true uint16 leaf)
    if a.dtype.name in ("bfloat16", "uint16"):
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def lm_params_to_torch(params_np, device=None):
    """A JAX ``lm.init_params`` tree (nested dicts and lists of arrays,
    e.g. after ``jax.tree.map(np.asarray, params)``; the hybrid family's
    ``blocks`` is a list of per-layer dicts) -> the port's tree of
    tensors on ``device`` (``cuda`` unless ``"cpu"`` is asked for), the
    same structure, every dtype and bit kept (bf16 included)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf_to_torch(node, dev)
    return walk(params_np)


def train_state_to_torch(state_np, device=None):
    """A JAX train state (``init_train_state``'s tree after
    ``jax.tree.map(np.asarray, ...)``: {"params", "opt": {"mu", "step"}}
    and "err" with compression; mu's m and v fp32, bf16 or int8
    {"q", "scale"} blocks), or :func:`train_state_to_numpy`'s output ->
    the port's tree of tensors on ``device``, every leaf's dtype and bits
    kept (a uint16 leaf is bf16 bits)."""
    return lm_params_to_torch(state_np, device)


def train_state_to_numpy(state):
    """The port's train state (or any tree of tensors) -> the same tree of
    host numpy arrays, bit for bit; bf16 leaves as their raw ``uint16``
    bits (view them as ``ml_dtypes.bfloat16`` where that is installed)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    return walk(state)
