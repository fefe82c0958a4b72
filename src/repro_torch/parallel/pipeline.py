"""Pipeline parallelism: GPipe-style micro-batch pipelining over a
``pipe`` mesh axis; port of ``repro.parallel.pipeline``.

The reference runs one stage a device under ``shard_map`` and hops the
activations with a ``collective_permute``.  In one process every stage
lives on the mesh's one device: the stages' carries are one tensor with
a leading stage axis, the ring permute is a roll along it, and the final
broadcast from the last stage is that stage's row.  On a mesh whose
``pipe`` axis is split over ``torch.distributed`` ranks, each rank runs
its block of stages (one a rank when W = S): the roll moves carries
inside the block, the carry of its last stage crosses to the next rank
(``Mesh.ppermute``, an ``all_to_all_single`` with one nonzero split),
and the broadcast is the reference's ``psum``: an ``all_reduce`` of the
last stage's outputs, zeros on every other rank.

Schedule (GPipe, S stages, M micro-batches, M >= S), as the
reference's:  step t in [0, M+S-2]: stage s works on micro-batch
(t - s) when 0 <= t - s < M (the ``active`` mask; an inactive stage
keeps its carry and runs no body); stage 0 injects micro-batch t; the
last stage collects micro-batch t - (S-1); then every stage's output
moves to the next stage (the wrap edge into stage 0 is overwritten by
the next injection).  Bubble fraction = (S-1)/(M+S-1).
"""

from __future__ import annotations

import torch

from .. import tree as pt


def pipeline_forward(stage_fn, params_stacked, x_micro, *, mesh,
                     axis: str = "pipe"):
    """Run micro-batches through pipeline stages.

    stage_fn: (stage_params, x) -> y, the per-stage body (a slice of
              the layer stack is each stage's params).
    params_stacked: tree with leading dim = n_stages (stage-major), or,
              over ranks, this rank's block of stages.
    x_micro: [M, mb, ...] micro-batched input (M >= n_stages), on the
             mesh's device.
    Returns [M, mb, ...] outputs (micro-batch order preserved).
    """
    n_stages = mesh.shape[axis]
    m = x_micro.shape[0]
    assert m >= n_stages, "need at least one microbatch per stage"
    if x_micro.device != mesh.device:
        raise ValueError(f"the micro-batches live on {x_micro.device}, "
                         f"the mesh on {mesh.device}")
    ranked = mesh.ranked and mesh.ranked_axis == axis
    first, stop = mesh.block(axis) if ranked else (0, n_stages)
    k = stop - first
    leaves, spec = pt.flatten(params_stacked)
    if leaves and leaves[0].shape[0] == n_stages:     # the whole stack
        leaves = [p[first:stop] for p in leaves]
    if leaves and leaves[0].shape[0] != k:
        raise ValueError(f"{leaves[0].shape[0]} stages of parameters for "
                         f"this rank's {k}")
    stage_params = [pt.unflatten(spec, [p[i] for p in leaves])
                    for i in range(k)]
    carry = torch.zeros((k,) + tuple(x_micro.shape[1:]),
                        dtype=x_micro.dtype, device=x_micro.device)
    outs = torch.zeros_like(x_micro)
    last = n_stages - 1
    for t in range(m + n_stages - 1):
        ys = []
        for i in range(k):
            sid = first + i
            x_in = x_micro[min(t, m - 1)] if sid == 0 else carry[i]
            active = 0 <= t - sid < m
            ys.append(stage_fn(stage_params[i], x_in) if active
                      else carry[i])
        y = torch.stack(ys)
        # the last stage collects finished micro-batches
        if stop == n_stages and 0 <= t - last < m:
            outs[t - last] = y[k - 1]
        # hop activations stage s -> s+1 (the ring permute)
        carry = torch.roll(y, 1, dims=0)
        if ranked:
            carry[:1] = mesh.ppermute(y[k - 1:])
    if ranked:
        # broadcast the last stage's results: the reference's psum of
        # zeros elsewhere
        return mesh.all_reduce(outs)
    # on one device the last stage's row is the result
    return outs


def split_stages(stacked_params, n_stages: int):
    """[L, ...] layer-stacked params -> [S, L/S, ...] stage-major."""
    def split(p):
        n_layers = p.shape[0]
        assert n_layers % n_stages == 0, \
            f"layers {n_layers} % stages {n_stages}"
        return p.reshape(n_stages, n_layers // n_stages, *p.shape[1:])
    return pt.tree_map(split, stacked_params)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
