"""The port's mesh: S home shards of the coherence plane on one device.

Counterpart of the ``jax.sharding.Mesh`` the reference's sharded verbs
take.  The verbs read it the way the reference reads a JAX mesh —
``mesh.shape[axis]`` for the shard count and ``mesh.axis_names`` — and
its one axis is ``"shards"``.  Every shard lives on the mesh's
``device``: the sharded plane keeps the reference's global stripe
layout (shard ``s`` owns one contiguous slab along each leaf's line
axis), each round's two ``all_to_all``s become index moves along the
shard axis, and each ``psum`` a sum over it
(:mod:`repro_torch.core.rounds.sharded`).

A state on another device than its mesh's is refused, never moved.
"""

from __future__ import annotations

import torch

from ... import resolve_device

AXIS = "shards"


class Mesh:
    """``n_shards`` home shards on one ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``)."""

    def __init__(self, n_shards: int, device=None):
        n = int(n_shards)
        if n < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.n_shards = n
        self.device = dev

    @property
    def shape(self) -> dict:
        return {AXIS: self.n_shards}

    @property
    def axis_names(self) -> tuple:
        return (AXIS,)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and other.n_shards == self.n_shards
                and other.device == self.device)

    def __hash__(self) -> int:
        return hash((self.n_shards, str(self.device)))

    def __repr__(self) -> str:
        return f"Mesh({self.n_shards}, device={str(self.device)!r})"


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
