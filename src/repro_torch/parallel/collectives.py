"""The mesh's moves across ranks as ``torch.autograd.Function``s, so a
loss over a ranked mesh differentiates through them.

Each forward is the :class:`~repro_torch.core.rounds.Mesh` collective
itself (:meth:`Mesh.all_to_all`, :meth:`Mesh.all_gather`,
:meth:`Mesh.all_reduce`) or a plain slice, so the values are the ones
the mesh computes without autograd.  The backward keeps one convention:
a tensor that every rank holds whole (replicated) carries the same
gradient on every rank, and the loss is one replicated value, not a sum
of ``world`` copies.  So:

=====================  ==========================  ==========================
move                   forward                     backward
=====================  ==========================  ==========================
:func:`all_to_all`     ``all_to_all_single``       ``all_to_all`` of the
                       (``out_splits`` rows come   gradient with the two
                       in, ``in_splits`` go out)   split lists swapped
:func:`all_gather`     block -> replicated         this rank's block of the
                                                   gradient (a slice, no sum)
:func:`block`          replicated -> this rank's   an all-gather of every
                       block along ``dim``         rank's block gradient
:func:`all_reduce`     partial sums -> their       identity
                       replicated sum
=====================  ==========================  ==========================

``torch.distributed.nn.functional`` would not do: its ``all_gather``
backward reduce-scatters and its ``all_reduce`` backward all-reduces,
which scales a replicated gradient by ``world``.  The backward's
collectives go through the same mesh methods, so ``mesh.COLLECTIVES``
counts them; every rank runs the same graph and so issues them in the
same order (under remat the checkpointed forward's collectives run
again inside the backward, on every rank alike).  Without a group
(world 1, no ranks) every move is the identity or a whole slice.
"""

from __future__ import annotations

import torch


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, out_splits, in_splits):
        ctx.mesh, ctx.splits = mesh, (out_splits, in_splits)
        return mesh.all_to_all(x, out_splits, in_splits)

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return ctx.mesh.all_to_all(g, in_splits, out_splits), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        first = ctx.mesh.rank * ctx.n
        return g.narrow(ctx.dim, first, ctx.n).contiguous(), None, None


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.world
        return x.narrow(dim, mesh.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_to_all(x, mesh, out_splits=None, in_splits=None):
    """:meth:`Mesh.all_to_all` along dim 0, differentiable."""
    if not mesh.ranked:
        return x
    return _AllToAll.apply(x, mesh, out_splits, in_splits)


def all_gather(x, mesh, dim: int = 0):
    """Every rank's equal block ``x`` concatenated along ``dim`` in rank
    order (block -> replicated); the backward keeps this rank's block of
    the replicated gradient."""
    if not mesh.ranked:
        return x
    return _AllGather.apply(x, mesh, dim)


def block(x, mesh, dim: int = 0):
    """This rank's block of the replicated ``x`` along ``dim`` (the
    ``world`` blocks of equal size, in rank order); the backward
    all-gathers the blocks' gradients into the replicated one."""
    if not mesh.ranked:
        return x
    if x.shape[dim] % mesh.world:
        raise ValueError(f"{mesh.world} ranks do not split dim {dim} of "
                         f"size {x.shape[dim]}")
    return _Block.apply(x, mesh, dim)


def all_reduce(x, mesh):
    """The sum of every rank's ``x`` (a new tensor; ``x`` is left as it
    is), its gradient passed through unchanged."""
    if not mesh.ranked:
        return x
    return _AllReduce.apply(x, mesh)
