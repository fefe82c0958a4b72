"""Carry state between the reference and the port, bit for bit.

The two packages meet in numpy: a JAX round state (or a pool's rounds
state) becomes a dict of numpy arrays with ``{k: np.asarray(v)}``, and
:func:`to_torch` turns that into port tensors with every dtype kept —
int8 ``cache_state``, bool ``dirty``, int32 lanes.  :func:`to_numpy`
goes back.  :func:`pool_from_arrays` rebuilds a serving pool from a
rounds state and its allocator's bump pointer and free list, and
:func:`legacy_pool_from_arrays` one that serves the legacy page-copy
path from a JAX pool's ``pool`` and ``cache`` dicts.
:func:`sharded_state_from_arrays` carries a JAX sharded round state
(its leaves gathered with ``np.asarray``, in stripe layout) onto a
port :class:`~repro_torch.core.rounds.Mesh`.
:func:`rank_experts` cuts an LM parameter tree or a whole train state
(the JAX package's numpy leaves or the port's tensors) down to the
routed experts of one expert-parallel rank, and :func:`rank_state` to a
rank's block on every ranked axis (the data axis's too); :func:`lm_params_to_torch` carries a JAX LM
parameter tree across, and
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


def sharded_state_from_arrays(state: dict, mesh) -> dict:
    """The port's sharded round state from a JAX sharded state given as
    gathered numpy leaves (``{k: np.asarray(v)}``): both packages keep
    the global stripe layout, so every leaf carries over as it is, onto
    the mesh's device, contiguous; over ranks each rank keeps its
    shards' slabs of the striped leaves."""
    from .core.rounds.mesh import shards_of
    from .core.rounds.state import GLOBAL_LEAVES, LINE_AXIS
    n_shards = shards_of(mesh)
    n_lines = np.shape(state["words"])[0]
    if n_lines % n_shards:
        raise ValueError(f"n_lines={n_lines} not divisible by "
                         f"n_shards={n_shards}")
    if mesh.ranked:
        first, stop = mesh.block()
        rows = n_lines // n_shards
        state = {k: v if k in GLOBAL_LEAVES else np.take(
            v, np.arange(first * rows, stop * rows), axis=LINE_AXIS[k])
            for k, v in state.items()}
    return to_torch(state, mesh.device)


EXPERT_LEAVES = ("we_g", "we_u", "we_d")


def rank_experts(tree, mesh, axis: str = "model"):
    """``tree`` (an LM parameter tree, one moe layer's dict, or a whole
    train state: the parameters, the AdamW ``opt.mu`` m and v in any
    tier, ``err``; numpy arrays or tensors) with every leaf under a
    routed-expert key (``we_g``, ``we_u``, ``we_d``: a parameter ``[...,
    E, a, b]``, or its int8 ``{"q", "scale"}`` blocks ``[..., E, a, nb,
    k]``) cut to the experts of this rank's block of ``mesh``'s expert
    axis, ``E / W`` of them: the share an expert-parallel rank holds.
    Every other leaf is kept as it is (the same object)."""
    n = mesh.shape[axis]
    first, stop = mesh.block(axis)

    def cut(leaf, trailing):
        ax = leaf.ndim - trailing
        e = leaf.shape[ax]
        if e % n:
            raise ValueError(f"{e} experts do not split over {n} shards")
        idx = (slice(None),) * ax + (slice(first * e // n, stop * e // n),)
        return leaf[idx]

    def experts(node):
        if isinstance(node, dict):
            if set(node) == {"q", "scale"}:     # int8 blocks: one more axis
                return {k: cut(v, 4) for k, v in node.items()}
            return {k: experts(v) for k, v in node.items()}
        return cut(node, 3)

    def walk(node, key=None):
        if key in EXPERT_LEAVES:
            return experts(node)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node
    return walk(tree)


def rank_state(tree, mesh, specs, axes=None):
    """``tree`` (a whole parameter tree, train state or single leaf:
    the parameters, the AdamW ``opt.mu`` m and v in any tier, ``err``;
    numpy arrays or tensors) cut to this rank's block on every ranked
    axis of ``mesh`` (or only on ``axes``): each leaf by its
    ``parallel.sharding.rank_dims`` entry of ``specs`` (``state_specs``
    or ``param_specs`` of the whole shapes: a model rank holds every
    leaf the specs shard over ``model``).  A cut leaf is
    a copy, so the whole one can be freed; a leaf held whole is kept as
    it is (the same object)."""
    from .parallel.sharding import NamedSharding, RankDims, _map, rank_dims

    def cut(_, spec, leaf, dims):
        if axes is not None:
            dims = RankDims({a: d for a, d in dims.items() if a in axes})
        if not dims:
            return leaf
        out = NamedSharding(mesh, spec, dims).block(leaf)
        return out.clone() if isinstance(out, torch.Tensor) \
            else np.array(out, copy=True)
    return _map(cut, specs, tree, rank_dims(mesh, specs))


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


def legacy_pool_from_arrays(cfg, pool: dict, cache: dict, *,
                            alloc_top: int, alloc_freed=(), device=None):
    """A :class:`~repro_torch.dsm.kvpool.SELCCKVPool` on the legacy
    path whose ``pool`` and ``cache`` leaves are ``pool`` and ``cache``
    (arrays, e.g. a JAX legacy pool's, bf16 pages included), with its
    page allocator at bump pointer ``alloc_top`` and free list
    ``alloc_freed``."""
    from .dsm.kvpool import SELCCKVPool
    out = SELCCKVPool(cfg, device=device)
    for dst, src in ((out.pool, pool), (out.cache, cache)):
        if sorted(dst) != sorted(src):
            raise ValueError(f"leaves {sorted(src)} are not the pool's "
                             f"{sorted(dst)}")
        for k, v in src.items():
            dst[k] = _leaf_to_torch(v, out.device)
    out._alloc.top = int(alloc_top)
    out._alloc._freed = set(int(p) for p in alloc_freed)
    return out


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
