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
(:mod:`repro_torch.parallel.dist` sets one up) and a layout of it,
``ranks``: an ordered ``{axis: n}`` of the axes split over the ranks,
whose product is the group's ``world`` (each ``n`` dividing its axis).
By default (``ranks=None``) the last axis (``shards``, ``model`` or
``pipe``) is split over every rank.  A rank's coordinates are row-major
over the ranked axes in the mesh's order, so ``data`` is the major one
of ``{"data": 2, "model": 2}``, and along each ranked axis rank ``r``
owns a contiguous block of ``n_axis / n`` shards; everything else stays
on every rank.  Each ranked axis has its sub-group, the ranks that share
every other coordinate (:func:`repro_torch.parallel.dist.subgroups`
makes them, every rank every sub-group in the same order).  Index moves
inside a rank's block stay index moves; the moves across ranks are the
mesh's collectives below, each over one ranked axis (the default one,
``ranked_axis``, the last, unless ``axis=`` names another; a tuple of
every ranked axis is the whole group; an axis no rank splits is the
identity), built on the two primitives every backend runs,
``all_to_all_single`` (with explicit split sizes) and ``all_reduce``:
:meth:`Mesh.all_to_all`, :meth:`Mesh.all_reduce`, :meth:`Mesh.all_gather`
(an all-to-all that sends a rank's block to every rank),
:meth:`Mesh.reduce_scatter` (an all-to-all of the blocks and a local
fp32 sum), :meth:`Mesh.ppermute` (an all-to-all whose only nonzero split
is the neighbour's), and :meth:`Mesh.barrier`.  With no group the mesh
is world 1 and issues no collective.
:mod:`repro_torch.parallel.collectives` wraps the moves as autograd
functions.  ``COLLECTIVES`` counts each collective's calls and the bytes
a rank sent through it, in all (``all_to_all_calls``) and by the axis it
ran over (``all_to_all_calls.data``; ``.world`` for the whole group).

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


WORLD = "world"     # the label of a collective over the whole group


def _count(name: str, label: str, nbytes: int) -> None:
    for key in (name, f"{name}.{label}"):
        COLLECTIVES[f"{key}_calls"] += 1
        COLLECTIVES[f"{key}_bytes"] += nbytes


class Mesh:
    """Named shard axes on one ``device`` (``cuda`` unless the caller
    asks for ``"cpu"``).  ``shape`` is a shard count (the one axis
    ``"shards"``) or an ordered ``{axis: size}`` mapping (or a sequence
    of (axis, size) pairs); ``devices`` optionally names the shard ids
    (any labels, ``arange`` by default), laid out in the mesh's shape.
    ``group`` (a ``torch.distributed`` process group) splits the axes of
    ``ranks`` (``{axis: n}``; by default the last axis over every rank)
    over its ranks in blocks; ``device`` is then this rank's own."""

    def __init__(self, shape, device=None, devices=None, *, group=None,
                 ranks=None):
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
        if group is None:
            if ranks:
                raise ValueError("a layout of ranks needs a process group")
            self.rank, self.world = 0, 1
            self.ranks, self._groups = {}, {}
            self.ranked_axis = tuple(axes)[-1]
            self._coords = {}
            return
        import torch.distributed as dist
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if ranks is None:
            ranks = {tuple(axes)[-1]: self.world}
        ranks = {str(a): int(n) for a, n in dict(ranks).items()}
        for a, n in ranks.items():
            if a not in axes:
                raise ValueError(f"ranked axis {a!r} is not an axis of "
                                 f"the mesh {tuple(axes)}")
            if n < 1 or axes[a] % n:
                raise ValueError(f"{n} ranks do not split axis {a!r} of "
                                 f"size {axes[a]}")
        if math.prod(ranks.values()) != self.world:
            raise ValueError(f"the layout {ranks} has "
                             f"{math.prod(ranks.values())} ranks, the "
                             f"group {self.world}")
        if len(ranks) > 1:      # an axis of one rank splits nothing
            ranks = {a: n for a, n in ranks.items() if n > 1} or \
                {tuple(ranks)[-1]: 1}
        # the mesh's order: data-major
        self.ranks = {a: ranks[a] for a in axes if a in ranks}
        self.ranked_axis = tuple(self.ranks)[-1]
        self._coords, rest = {}, self.rank
        for a in reversed(tuple(self.ranks)):
            self._coords[a] = rest % self.ranks[a]
            rest //= self.ranks[a]
        if len(self.ranks) == 1:
            self._groups = {self.ranked_axis: group}
        else:
            from ...parallel.dist import subgroups
            self._groups = subgroups(group, self.ranks)

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

    def n_ranks(self, axis=None) -> int:
        """The ranks that split ``axis`` (1 for an axis no rank splits;
        the product over a tuple of axes)."""
        if isinstance(axis, tuple):
            return math.prod(self.n_ranks(a) for a in axis)
        return self.ranks.get(self.ranked_axis if axis is None else axis, 1)

    def coord(self, axis: str | None = None) -> int:
        """This rank's coordinate along ``axis`` (0 where no rank splits
        it)."""
        return self._coords.get(self.ranked_axis if axis is None else axis,
                                0)

    def local(self, axis: str | None = None) -> int:
        """The shards of ``axis`` on this rank: a block of a ranked axis,
        any other axis whole."""
        axis = self.ranked_axis if axis is None else axis
        return self._axes[axis] // self.n_ranks(axis)

    def block(self, axis: str | None = None) -> tuple:
        """``(first, stop)``: this rank's shards along ``axis``."""
        k = self.local(axis)
        first = self.coord(axis) * k
        return first, first + k

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and tuple(other._axes.items()) == tuple(self._axes.items())
                and other.device == self.device
                and np.array_equal(other.devices, self.devices)
                and other.group is self.group
                and other.ranks == self.ranks)

    def __hash__(self) -> int:
        return hash((tuple(self._axes.items()), str(self.device),
                     self.rank, self.world, tuple(self.ranks.items())))

    def __repr__(self) -> str:
        shape = self.n_shards if self.axis_names == (AXIS,) else self._axes
        ranks = (f", rank={self.rank}/{self.world} over {self.ranks!r}"
                 if self.ranked else "")
        return f"Mesh({shape!r}, device={str(self.device)!r}{ranks})"

    # ------------------------------------------------------ collectives
    # (gloo takes CUDA tensors for both primitives, so ranks that share
    # a card pass their tensors as they are, as nccl ranks do)
    def _over(self, axis):
        """``(group, n, coord, label)`` of a collective over ``axis`` (a
        name, a tuple of names, None for :attr:`ranked_axis`); group None
        where no rank splits it."""
        if not self.ranked:
            return None, 1, 0, ""
        names = (self.ranked_axis,) if axis is None else (
            tuple(axis) if isinstance(axis, (tuple, list)) else (axis,))
        mine = tuple(a for a in self.ranks if a in names)
        if not mine:
            return None, 1, 0, ""
        if len(mine) == 1:
            a = mine[0]
            return self._groups.get(a), self.ranks[a], self._coords[a], a
        if mine == tuple(self.ranks):
            return self.group, self.world, self.rank, WORLD
        raise NotImplementedError(f"a collective over {mine} of the "
                                  f"ranked axes {tuple(self.ranks)}")

    def all_to_all(self, x: torch.Tensor, out_splits=None,
                   in_splits=None, axis=None) -> torch.Tensor:
        """``all_to_all_single`` along dim 0 over ``axis``'s ranks:
        ``in_splits[q]`` rows go to its rank ``q`` (in rank order),
        ``out_splits[q]`` rows come from it (equal splits when omitted).
        Where no rank splits ``axis`` (world 1 without a group) it
        returns ``x``."""
        group, n, me, label = self._over(axis)
        if group is None:
            return x
        import torch.distributed as dist
        x = x.contiguous()
        rest = tuple(x.shape[1:])
        n_out = (x.shape[0] if out_splits is None
                 else int(sum(out_splits)))
        row = math.prod(rest) * x.element_size()
        sent = (x.shape[0] - (x.shape[0] // n if in_splits is None
                              else int(in_splits[me]))) * row
        _count("all_to_all", label, sent)
        out = torch.empty((n_out,) + rest, dtype=x.dtype, device=x.device)
        dist.all_to_all_single(
            out, x, None if out_splits is None else list(out_splits),
            None if in_splits is None else list(in_splits), group=group)
        return out

    def all_reduce(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """The sum of ``x`` over ``axis``'s ranks (``psum``), in place;
        where no rank splits ``axis`` it returns ``x``."""
        group, _, _, label = self._over(axis)
        if group is None:
            return x
        import torch.distributed as dist
        _count("all_reduce", label, x.numel() * x.element_size())
        dist.all_reduce(x, group=group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   axis=None) -> torch.Tensor:
        """Every ``axis`` rank's ``x`` concatenated along ``dim`` in rank
        order: an all-to-all that sends this rank's block to every
        rank."""
        group, n, _, _ = self._over(axis)
        if group is None:
            return x
        x = x.movedim(dim, 0)
        send = x.unsqueeze(0).expand(n, *x.shape)
        out = self.all_to_all(send.reshape((n * x.shape[0],)
                                           + tuple(x.shape[1:])), axis=axis)
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0,
                       axis=None) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of every ``axis``
        rank's ``x`` (the ``n`` blocks of equal size, in rank order): an
        all-to-all of ``x`` in fp32 that sends block ``q`` to rank ``q``,
        then the received blocks summed in rank order and cast back to
        ``x``'s dtype (gloo has no reduce-scatter)."""
        group, n, _, _ = self._over(axis)
        if group is None:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"{n} ranks do not split dim {dim} of size "
                             f"{x.shape[dim]}")
        x = x.movedim(dim, 0)
        got = self.all_to_all(x.float(), axis=axis)
        got = got.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        out = got[0].clone()            # (a view would keep all n alive)
        for q in range(1, n):
            out.add_(got[q])
        return out.to(x.dtype).movedim(0, dim)

    def barrier(self) -> None:
        """Wait until every rank of the group gets here (world 1 without
        a group returns at once)."""
        if not self.ranked:
            return
        import torch.distributed as dist
        COLLECTIVES["barrier_calls"] += 1
        dist.barrier(group=self.group)

    def ppermute(self, x: torch.Tensor, shift: int = 1,
                 axis=None) -> torch.Tensor:
        """The ``axis`` rank ``r``'s ``x`` arrives at rank ``(r + shift)
        % n`` (the ring permute): an all-to-all whose only nonzero split
        is the neighbour's."""
        group, w, me, _ = self._over(axis)
        if group is None or w == 1:
            return x
        n = x.shape[0]
        dst = (me + shift) % w
        src = (me - shift) % w
        ins = [n if q == dst else 0 for q in range(w)]
        outs = [n if q == src else 0 for q in range(w)]
        return self.all_to_all(x, outs, ins, axis=axis)


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
