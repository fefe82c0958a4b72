"""The mesh's moves across ranks as ``torch.autograd.Function``s, so a
loss over a ranked mesh differentiates through them.

Each forward is the :class:`~repro_torch.core.rounds.Mesh` collective
itself (:meth:`Mesh.all_to_all`, :meth:`Mesh.all_gather`,
:meth:`Mesh.all_reduce`) or a plain slice, over one ranked axis
(``axis``: the mesh's ``ranked_axis`` unless named), so the values are
the ones the mesh computes without autograd.  The backward keeps one
convention an axis:

* along ``model`` (and any axis but the data axes) a tensor that every
  rank holds whole (replicated) carries the same gradient on every
  rank, and the loss is one replicated value, not a sum of copies;
* along ``data`` each rank's loss is its share of the global loss, and
  the shares sum to it; so a rank's gradient of a tensor replicated
  along ``data`` is its share of the whole one (the train step sums
  those shares once, after the backward), and the gradient of a data
  rank's block of a leaf is the sum of every data rank's.

So:

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
:func:`all_reduce`     partial sums -> their       identity, or the sum of
                       replicated sum              the gradient's shares
                                                   over ``grad_axis``
:func:`gather_block`   a data rank's block of a    the gradient reduce-
                       leaf -> the whole leaf      scattered (summed in
                                                   fp32) over the same ranks
:func:`enter`          identity (a replicated      the gradient's partials
                       input of column-parallel    summed over the ranks
                       products; Megatron's *f*)   (:func:`sum_ranks`' sum)
:func:`sum_ranks`      partial sums -> their sum,  identity
                       in fp32 in rank order
                       (Megatron's *g*)
=====================  ==========================  ==========================

Along the model axis under tensor parallelism (``models.lm``) a rank's
gradient of a tensor it computes from its blocks alone is a partial
sum: :func:`enter` sits where a replicated tensor meets the rank's
column blocks (the normed residual before ``wq``/``wg``, a norm weight
that acts on the rank's heads only) and sums those partials in its
backward.  :func:`sum_ranks` adds the ranks' partials of a
row-parallel product in fp32, in rank order, after one all-gather, so
every rank gets the same bits on gloo and nccl alike (a moe router
downstream routes the same tokens on every rank); its backward passes
the replicated gradient through, as :func:`all_reduce`'s does.

:func:`gather_blocks` is :func:`gather_block` of several leaves at once:
their blocks packed into one buffer a dtype, one all-gather forward and
one reduce-scatter backward (a collective through gloo costs several ms
before its first byte on ranks that share a card, so a layer's blocks
travel together), a buffer at most :data:`PACK` whole elements (its fp32
gradient and the received copy are the backward's transients), a larger
leaf alone.

``torch.distributed.nn.functional`` would not do: its ``all_gather``
backward reduce-scatters and its ``all_reduce`` backward all-reduces,
which scales a replicated gradient by ``world``.  The backward's
collectives go through the same mesh methods, so ``mesh.COLLECTIVES``
counts them; every rank runs the same graph and so issues them in the
same order (under remat the checkpointed forward's collectives run
again inside the backward, on every rank alike).  Where no rank splits
the axis (world 1, no ranks) every move is the identity or a whole
slice.
"""

from __future__ import annotations

import torch

PACK = 1 << 26             # whole elements a packed gather carries at most


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, out_splits, in_splits, axis):
        ctx.mesh, ctx.splits, ctx.axis = mesh, (out_splits, in_splits), axis
        return mesh.all_to_all(x, out_splits, in_splits, axis=axis)

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return (ctx.mesh.all_to_all(g, in_splits, out_splits, axis=ctx.axis),
                None, None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.n, ctx.axis = mesh, dim, x.shape[dim], axis
        return mesh.all_gather(x, dim, axis=axis)

    @staticmethod
    def backward(ctx, g):
        first = ctx.mesh.coord(ctx.axis) * ctx.n
        return (g.narrow(ctx.dim, first, ctx.n).contiguous(), None, None,
                None)


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        n = x.shape[dim] // mesh.n_ranks(axis)
        return x.narrow(dim, mesh.coord(axis) * n, n)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g.contiguous(), ctx.dim, axis=ctx.axis),
                None, None, None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, grad_axis):
        ctx.mesh, ctx.grad_axis = mesh, grad_axis
        return mesh.all_reduce(x.clone(), axis=axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_axis is not None:
            g = ctx.mesh.all_reduce(g.clone(), axis=ctx.grad_axis)
        return g, None, None, None


class _GatherBlocks(torch.autograd.Function):
    """Blocks of one dtype, packed: rank q's flattened blocks are row q
    of the gathered [n, total] buffer; each whole leaf is its n row
    pieces concatenated along its dim.  The backward packs each whole
    gradient's n blocks (block q in row q) into [n, total] and
    reduce-scatters it."""

    @staticmethod
    def forward(ctx, mesh, dims, axis, *xs):
        ctx.mesh, ctx.dims, ctx.axis = mesh, dims, axis
        ctx.shapes = [x.shape for x in xs]
        n = mesh.n_ranks(axis)
        flat = torch.cat([x.reshape(-1) for x in xs])
        got = mesh.all_gather(flat, 0, axis=axis).view(n, -1)
        out, at = [], 0
        for x, d in zip(xs, dims):
            k = x.numel()
            out.append(torch.cat(got[:, at:at + k].reshape(
                (n,) + tuple(x.shape)).unbind(0), d))
            at += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        mesh, n = ctx.mesh, ctx.mesh.n_ranks(ctx.axis)
        total = sum(shape.numel() for shape in ctx.shapes)
        # block q of every gradient, in fp32, in row q: one buffer
        send = torch.empty((n, total), dtype=torch.float32,
                           device=mesh.device)
        at = 0
        for g, shape, d in zip(gs, ctx.shapes, ctx.dims):
            k = shape.numel()
            if g is None:
                send[:, at:at + k].zero_()
            else:
                for q, piece in enumerate(g.chunk(n, d)):
                    send[q, at:at + k].view(shape).copy_(piece)
            at += k
        got = mesh.reduce_scatter(send.view(-1), 0, axis=ctx.axis)
        del send
        out, at = [], 0
        for g, shape in zip(gs, ctx.shapes):
            k = shape.numel()
            dt = g.dtype if g is not None else torch.float32
            out.append(got[at:at + k].view(shape).to(dt))
            at += k
        return (None, None, None, *out)


def _rank_sum(mesh, xs, axis):
    """Every ``axis`` rank's ``xs`` summed in fp32 in rank order after
    one all-gather of their packed fp32 copy, each cast back to its
    dtype: the same bits on every rank."""
    n = mesh.n_ranks(axis)
    flat = torch.cat([x.float().reshape(-1) for x in xs])
    got = mesh.all_gather(flat.unsqueeze(0), 0, axis=axis).view(n, -1)
    out = got[0].clone()            # (a view would keep all n alive)
    for q in range(1, n):
        out.add_(got[q])
    res, at = [], 0
    for x in xs:
        k = x.numel()
        res.append(out[at:at + k].view(x.shape).to(x.dtype))
        at += k
    return res


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.like = [(x.shape, x.dtype) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=d, device=ctx.mesh.device) if g is None
              else g for g, (s, d) in zip(gs, ctx.like)]
        return (None, None, *_rank_sum(ctx.mesh, gs, ctx.axis))


class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _rank_sum(mesh, [x], axis)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _split(mesh, axis) -> bool:
    return mesh.ranked and mesh.n_ranks(axis) > 1


def enter(x, mesh, axis="model"):
    """``x`` (a replicated tensor that enters this rank's blocks) as it
    is; its gradient's partials are summed over the ``axis`` ranks in
    fp32 in rank order (Megatron's *f*)."""
    return enter_many([x], mesh, axis)[0]


def enter_many(xs, mesh, axis="model") -> list:
    """:func:`enter` of each of ``xs``, their gradients summed in one
    collective."""
    if not _split(mesh, axis) or not xs:
        return list(xs)
    return list(_Enter.apply(mesh, axis, *xs))


def sum_ranks(x, mesh, axis="model"):
    """The sum of every ``axis`` rank's partial ``x`` (a row-parallel
    product's), in fp32 in rank order, cast back to ``x``'s dtype: the
    same bits on every rank.  The replicated gradient passes through
    (Megatron's *g*)."""
    if not _split(mesh, axis):
        return x
    return _SumRanks.apply(x, mesh, axis)


def all_to_all(x, mesh, out_splits=None, in_splits=None, axis=None):
    """:meth:`Mesh.all_to_all` along dim 0 over ``axis``'s ranks,
    differentiable."""
    if not mesh.ranked:
        return x
    return _AllToAll.apply(x, mesh, out_splits, in_splits, axis)


def all_gather(x, mesh, dim: int = 0, axis=None):
    """Every ``axis`` rank's equal block ``x`` concatenated along ``dim``
    in rank order (block -> replicated); the backward keeps this rank's
    block of the replicated gradient."""
    if not mesh.ranked:
        return x
    return _AllGather.apply(x, mesh, dim, axis)


def block(x, mesh, dim: int = 0, axis=None):
    """This rank's block of the replicated ``x`` along ``dim`` (the
    ``axis`` ranks' blocks of equal size, in rank order); the backward
    all-gathers the blocks' gradients into the replicated one."""
    if not mesh.ranked:
        return x
    if x.shape[dim] % mesh.n_ranks(axis):
        raise ValueError(f"{mesh.n_ranks(axis)} ranks do not split dim "
                         f"{dim} of size {x.shape[dim]}")
    return _Block.apply(x, mesh, dim, axis)


def all_reduce(x, mesh, axis=None, grad_axis=None):
    """The sum of every ``axis`` rank's ``x`` (a new tensor; ``x`` is
    left as it is).  Its gradient passes through unchanged, or, with
    ``grad_axis`` (the data axes, where each rank's loss is a share), is
    summed over those ranks first."""
    if not mesh.ranked:
        return x
    return _AllReduce.apply(x, mesh, axis, grad_axis)


def gather_block(x, mesh, dim: int, axis="data"):
    """The whole leaf from every ``axis`` rank's block ``x`` along ``dim``
    (an all-gather over the axis's sub-group); the backward reduce-
    scatters the whole leaf's gradient over the same ranks, a sum in
    fp32, so a rank gets its block of the summed gradient.  ``x`` as it
    is where no rank splits ``axis``."""
    return gather_blocks([x], mesh, [dim], axis)[0]


def gather_blocks(xs, mesh, dims, axis="data") -> list:
    """:func:`gather_block` of each of ``xs`` along its ``dims`` entry,
    the blocks of a dtype in one collective each way."""
    if not xs or not mesh.ranked or mesh.n_ranks(axis) == 1:
        return list(xs)
    n = mesh.n_ranks(axis)
    packs = []                  # index lists: a dtype, at most PACK whole
    for dt in dict.fromkeys(x.dtype for x in xs):
        pack, size = [], 0
        for i, x in enumerate(xs):
            if x.dtype != dt:
                continue
            if pack and size + n * x.numel() > PACK:
                packs.append(pack)
                pack, size = [], 0
            pack.append(i)
            size += n * x.numel()
        packs.append(pack)
    out = [None] * len(xs)
    for idx in packs:
        got = _GatherBlocks.apply(mesh, [dims[i] for i in idx], axis,
                                  *(xs[i] for i in idx))
        for i, y in zip(idx, got):
            out[i] = y
    return out
