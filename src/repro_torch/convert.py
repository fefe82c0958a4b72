"""Carry state between the reference and the port, bit for bit.

The two packages meet in numpy: a JAX round state (or a pool's rounds
state) becomes a dict of numpy arrays with ``{k: np.asarray(v)}``, and
:func:`to_torch` turns that into port tensors with every dtype kept —
int8 ``cache_state``, bool ``dirty``, int32 lanes.  :func:`to_numpy`
goes back.  :func:`pool_from_arrays` rebuilds a serving pool from a
rounds state and its allocator's bump pointer and free list.
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
