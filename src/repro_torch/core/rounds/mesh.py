"""The port's mesh: named shard axes on one device.

Counterpart of the ``jax.sharding.Mesh`` the reference's sharded code
takes.  It is read the way the reference reads a JAX mesh —
``mesh.shape[axis]`` for an axis's size, ``mesh.axis_names`` for the
axes in order, ``mesh.devices`` for the shard ids laid out in the mesh's
shape — and every shard lives on the mesh's one ``device``.

* ``Mesh(S)`` has the one axis ``"shards"``: the S home shards of the
  sharded coherence plane, which keeps the reference's global stripe
  layout (shard ``s`` owns one contiguous slab along each leaf's line
  axis); each round's two ``all_to_all``s become index moves along the
  shard axis, and each ``psum`` a sum over it
  (:mod:`repro_torch.core.rounds.sharded`).
* ``Mesh({"data": 2, "model": 4})`` has the LM stack's named axes
  (``data``, ``model``, optionally ``pod`` or ``pipe``;
  :mod:`repro_torch.launch.mesh` builds the reference's meshes).  A
  tensor keeps its global layout and a sharding is a record of
  (mesh, spec) (:mod:`repro_torch.parallel.sharding`); inside a sharded
  body an ``all_to_all`` is a transpose of the source and destination
  shard axes, a ``psum`` or ``pmean`` a sum or mean over a shard axis,
  a ``ppermute`` a roll along it.

A state on another device than its mesh's is refused, never moved.
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from ... import resolve_device

AXIS = "shards"


class Mesh:
    """Named shard axes on one ``device`` (``cuda`` unless the caller
    asks for ``"cpu"``).  ``shape`` is a shard count (the one axis
    ``"shards"``) or an ordered ``{axis: size}`` mapping (or a sequence
    of (axis, size) pairs); ``devices`` optionally names the shard ids
    (any labels, ``arange`` by default), laid out in the mesh's shape."""

    def __init__(self, shape, device=None, devices=None):
        if isinstance(shape, numbers.Integral):
            axes = {AXIS: int(shape)}
        else:
            axes = {str(a): int(n) for a, n in dict(shape).items()}
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        for a, n in axes.items():
            if n < 1:
                raise ValueError(f"axis {a!r} has size {n}; it must be >= 1")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._axes = axes
        self.n_shards = math.prod(axes.values())
        self.device = dev
        sizes = tuple(axes.values())
        ids = np.arange(self.n_shards) if devices is None \
            else np.asarray(devices)
        if ids.size != self.n_shards:
            raise ValueError(f"{ids.size} shard ids for a mesh of "
                             f"{self.n_shards} shards")
        self.devices = ids.reshape(sizes)

    @property
    def shape(self) -> dict:
        return dict(self._axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(self._axes)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and tuple(other._axes.items()) == tuple(self._axes.items())
                and other.device == self.device
                and np.array_equal(other.devices, self.devices))

    def __hash__(self) -> int:
        return hash((tuple(self._axes.items()), str(self.device)))

    def __repr__(self) -> str:
        shape = self.n_shards if self.axis_names == (AXIS,) else self._axes
        return f"Mesh({shape!r}, device={str(self.device)!r})"


def shards_of(mesh, axis: str = AXIS) -> int:
    """The shard count of ``mesh`` along ``axis``; ``TypeError`` for an
    object that is not a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh.shape[axis]


def check_on_mesh(state, mesh) -> None:
    """Refuse a state whose leaves live on another device than the
    mesh's (the sharded plane never moves a state silently)."""
    dev = state["words"].device
    if dev != mesh.device:
        raise ValueError(f"the state lives on {dev} but the mesh on "
                         f"{mesh.device}; move the state first")
