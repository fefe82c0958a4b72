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

A mesh may also carry a ``torch.distributed`` process group
(:mod:`repro_torch.parallel.dist` sets one up): its last axis, the
``ranked_axis`` (``shards``, ``model`` or ``pipe``), is then split over
the group's ``world`` ranks
in contiguous blocks, rank ``r`` owning shards ``[r*n/W, (r+1)*n/W)``
of it, and everything else stays on every rank.  Index moves inside a
rank's block stay index moves; the moves across ranks are the mesh's
collectives below, built on the two primitives every backend runs,
``all_to_all_single`` (with explicit split sizes) and ``all_reduce``:
:meth:`Mesh.all_to_all`, :meth:`Mesh.all_reduce`, :meth:`Mesh.all_gather`
(an all-to-all that sends a rank's block to every rank) and
:meth:`Mesh.ppermute` (an all-to-all whose only nonzero split is the
neighbour's), and :meth:`Mesh.barrier`.  With no group the mesh is
world 1 and issues no collective.  :mod:`repro_torch.parallel.collectives`
wraps the moves as autograd functions.  ``COLLECTIVES`` counts each collective's calls and the
bytes a rank sent through it.

A state on another device than its mesh's is refused, never moved.
"""

from __future__ import annotations

import collections
import math
import numbers

import numpy as np
import torch

from ... import resolve_device

AXIS = "shards"

# calls and bytes sent, by collective, since the last reset (this rank)
COLLECTIVES: collections.Counter = collections.Counter()


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def collective_counts() -> dict:
    return dict(COLLECTIVES)


class Mesh:
    """Named shard axes on one ``device`` (``cuda`` unless the caller
    asks for ``"cpu"``).  ``shape`` is a shard count (the one axis
    ``"shards"``) or an ordered ``{axis: size}`` mapping (or a sequence
    of (axis, size) pairs); ``devices`` optionally names the shard ids
    (any labels, ``arange`` by default), laid out in the mesh's shape.
    ``group`` (a ``torch.distributed`` process group) splits the last
    axis, ``ranked_axis``, over its ranks in blocks; ``device`` is then
    this rank's own."""

    def __init__(self, shape, device=None, devices=None, *, group=None):
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
        self.group = group
        self.ranked_axis = tuple(axes)[-1]
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        if axes[self.ranked_axis] % self.world:
            raise ValueError(
                f"{self.world} ranks do not split axis {self.ranked_axis!r} "
                f"of size {axes[self.ranked_axis]}")

    @property
    def shape(self) -> dict:
        return dict(self._axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(self._axes)

    @property
    def ranked(self) -> bool:
        """Whether the mesh spans a process group (world 1 included)."""
        return self.group is not None

    def local(self, axis: str | None = None) -> int:
        """The shards of ``axis`` on this rank: a block of the ranked
        axis, any other axis whole."""
        axis = self.ranked_axis if axis is None else axis
        n = self._axes[axis]
        return n // self.world if axis == self.ranked_axis else n

    def block(self, axis: str | None = None) -> tuple:
        """``(first, stop)``: this rank's shards along ``axis``."""
        k = self.local(axis)
        axis = self.ranked_axis if axis is None else axis
        first = self.rank * k if axis == self.ranked_axis else 0
        return first, first + k

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and tuple(other._axes.items()) == tuple(self._axes.items())
                and other.device == self.device
                and np.array_equal(other.devices, self.devices)
                and other.group is self.group)

    def __hash__(self) -> int:
        return hash((tuple(self._axes.items()), str(self.device),
                     self.rank, self.world))

    def __repr__(self) -> str:
        shape = self.n_shards if self.axis_names == (AXIS,) else self._axes
        ranks = (f", rank={self.rank}/{self.world} over "
                 f"{self.ranked_axis!r}" if self.ranked else "")
        return f"Mesh({shape!r}, device={str(self.device)!r}{ranks})"

    # ------------------------------------------------------ collectives
    # (gloo takes CUDA tensors for both primitives, so ranks that share
    # a card pass their tensors as they are, as nccl ranks do)
    def all_to_all(self, x: torch.Tensor, out_splits=None,
                   in_splits=None) -> torch.Tensor:
        """``all_to_all_single`` along dim 0: ``in_splits[q]`` rows go to
        rank ``q`` (in rank order), ``out_splits[q]`` rows come from it
        (equal splits when omitted).  World 1 without a group returns
        ``x``."""
        if not self.ranked:
            return x
        import torch.distributed as dist
        x = x.contiguous()
        rest = tuple(x.shape[1:])
        n_out = (x.shape[0] if out_splits is None
                 else int(sum(out_splits)))
        row = math.prod(rest) * x.element_size()
        sent = (x.shape[0] - (x.shape[0] // self.world if in_splits is None
                              else int(in_splits[self.rank]))) * row
        COLLECTIVES["all_to_all_calls"] += 1
        COLLECTIVES["all_to_all_bytes"] += sent
        out = torch.empty((n_out,) + rest, dtype=x.dtype, device=x.device)
        dist.all_to_all_single(
            out, x, None if out_splits is None else list(out_splits),
            None if in_splits is None else list(in_splits),
            group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (``psum``), in place; world 1
        without a group returns ``x``."""
        if not self.ranked:
            return x
        import torch.distributed as dist
        COLLECTIVES["all_reduce_calls"] += 1
        COLLECTIVES["all_reduce_bytes"] += x.numel() * x.element_size()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order:
        an all-to-all that sends this rank's block to every rank."""
        if not self.ranked:
            return x
        x = x.movedim(dim, 0)
        send = x.unsqueeze(0).expand(self.world, *x.shape)
        out = self.all_to_all(send.reshape((self.world * x.shape[0],)
                                           + tuple(x.shape[1:])))
        return out.movedim(0, dim)

    def barrier(self) -> None:
        """Wait until every rank of the group gets here (world 1 without
        a group returns at once)."""
        if not self.ranked:
            return
        import torch.distributed as dist
        COLLECTIVES["barrier_calls"] += 1
        dist.barrier(group=self.group)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Rank ``r``'s ``x`` arrives at rank ``(r + shift) % world``
        (the ring permute): an all-to-all whose only nonzero split is
        the neighbour's."""
        if not self.ranked or self.world == 1:
            return x
        n = x.shape[0]
        dst = (self.rank + shift) % self.world
        src = (self.rank - shift) % self.world
        ins = [n if q == dst else 0 for q in range(self.world)]
        outs = [n if q == src else 0 for q in range(self.world)]
        return self.all_to_all(x, outs, ins)


def shards_of(mesh, axis: str = AXIS) -> int:
    """The shard count of ``mesh`` along ``axis``; ``TypeError`` for an
    object that is not a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh.shape[axis]


def check_on_mesh(state, mesh) -> None:
    """Refuse a state with a leaf on another device than this rank's
    own (the mesh's; the sharded plane never moves a state silently)."""
    for k, v in state.items():
        if v.device != mesh.device:
            raise ValueError(f"the state's {k!r} lives on {v.device} but "
                             f"this rank's mesh on {mesh.device}; move the "
                             f"state first")
