"""Process groups for a mesh over several ranks.

One process per rank, as ``torchrun`` starts them: the rank reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and ``LOCAL_WORLD_SIZE``
when set) from its environment, and is given its ``init_method``
explicitly (``env://`` under ``torchrun``; a ``file://`` path in the
tests).  The backend follows from the layout, never from a failure:

* ``nccl`` when every rank has a card of its own (``cuda:LOCAL_RANK``);
* ``gloo`` for CPU tensors, and for several ranks that share one card
  (NCCL refuses two ranks on one GPU).

A failed initialisation raises.  :func:`init` returns the group and this
rank's device; hand the group to a :class:`~repro_torch.core.rounds.Mesh`
(``Mesh(shape, device, group=group)``) and the mesh's ranked axis is
split over the ranks.  :func:`spawn` starts ranks on this host without
``torchrun`` and joins them within a time limit: a rank that fails or
outlasts it ends them all and raises.  :func:`subgroups` makes the
sub-groups of a layout of several ranked axes (``Mesh(..., ranks=)``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device


@dataclass(frozen=True)
class Layout:
    """Where this process sits: its rank, the world, its rank on the
    host and the ranks on the host."""
    rank: int
    world: int
    local_rank: int
    local_world: int


def env_layout(environ=None) -> Layout:
    """The layout ``torchrun`` describes in the environment (one rank,
    world 1, without ``WORLD_SIZE``)."""
    env = os.environ if environ is None else environ
    world = int(env.get("WORLD_SIZE", 1))
    rank = int(env.get("RANK", 0))
    local = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if not 0 <= rank < world or not 0 <= local < local_world:
        raise ValueError(f"rank {rank} / local rank {local} outside a world "
                         f"of {world} ({local_world} on this host)")
    return Layout(rank, world, local, local_world)


def in_ranks(environ=None) -> bool:
    """Whether this process was started as one of several ranks
    (``WORLD_SIZE`` set)."""
    env = os.environ if environ is None else environ
    return "WORLD_SIZE" in env


def choose(layout: Layout, device_type: str, n_cards: int) -> tuple:
    """``(backend, device)`` for ``layout`` on ``device_type`` with
    ``n_cards`` visible cards: nccl and ``cuda:LOCAL_RANK`` when the
    host's ranks each have a card, gloo and a shared card (``cuda:
    LOCAL_RANK % n_cards``) when they do not, gloo and the CPU for
    ``cpu``."""
    if device_type == "cpu":
        return "gloo", torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if n_cards < 1:
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the ranks on the CPU")
    if layout.local_world <= n_cards:
        return "nccl", torch.device("cuda", layout.local_rank)
    return "gloo", torch.device("cuda", layout.local_rank % n_cards)


def init(*, init_method: str, device=None, environ=None):
    """Join this rank's process group (or return the one already
    joined) and return ``(group, device)``.  ``device`` (``cuda``
    unless ``"cpu"`` is asked for) names the device type; the backend
    and this rank's device are :func:`choose`'s."""
    import torch.distributed as dist
    layout = env_layout(environ)
    dev_type = resolve_device(device).type
    backend, dev = choose(layout, dev_type,
                          torch.cuda.device_count() if dev_type == "cuda"
                          else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_world_size() != layout.world
                or dist.get_rank() != layout.rank):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already joined as rank {dist.get_rank()}, not "
                f"{layout.rank} of {layout.world}")
        if dist.get_backend() != backend:
            raise RuntimeError(f"the joined group runs "
                               f"{dist.get_backend()}, not {backend}")
        return dist.group.WORLD, dev
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            rank=layout.rank, world_size=layout.world, **kw)
    return dist.group.WORLD, dev


_SUBGROUPS: dict = {}


def subgroups(group, ranks: dict) -> dict:
    """``{axis: process group}`` for the layout ``ranks`` (an ordered
    ``{axis: n}``, row-major, product the world of ``group``): along each
    axis the ranks that share every other coordinate, this rank's group
    of them.  Every rank of the world creates every sub-group with
    ``new_group``, in the same order (axis by axis, then by the other
    coordinates in row-major order), including the groups it is not in,
    as ``new_group`` asks; so ``group`` must span the world.  A layout is
    made once a process group (cached until :func:`finish`)."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    if world != dist.get_world_size():
        raise ValueError(f"a layout of several ranked axes needs a group "
                         f"that spans the world ({dist.get_world_size()} "
                         f"ranks), not one of {world}")
    members = dist.get_process_group_ranks(group)
    key = (tuple(members), tuple(ranks.items()))
    if key in _SUBGROUPS:
        return _SUBGROUPS[key]
    axes, sizes = tuple(ranks), tuple(ranks.values())
    me = dist.get_rank(group)
    coords = list(np.ndindex(*sizes))           # row-major: rank order
    out = {}
    for i, a in enumerate(axes):
        for fixed in np.ndindex(*(sizes[:i] + sizes[i + 1:])):
            mine = [r for r, c in enumerate(coords)
                    if c[:i] + c[i + 1:] == fixed]
            pg = dist.new_group([members[r] for r in mine])
            if me in mine:
                out[a] = pg
    _SUBGROUPS[key] = out
    return out


def finish() -> None:
    """Leave the process group (a no-op when none was joined)."""
    import torch.distributed as dist
    _SUBGROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(fn, rank: int, world: int, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    fn(rank, world, *args)


def spawn(fn, world: int, *, args=(), timeout: float) -> float:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method; ``fn`` must be importable by name), each with
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    set, and join them.  Returns the seconds the ranks took.  A rank that
    exits non-zero, or ranks still running after ``timeout`` seconds,
    kill every rank and raise ``RuntimeError``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    t0 = time.monotonic()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, args),
                         name=f"rank{r}") for r in range(world)]
    for p in procs:
        p.start()
    failure = None
    try:
        while failure is None:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                # a rank's peers may abort on its closed connections: give
                # them a moment, then name every rank that failed
                end = time.monotonic() + 2.0
                for p in procs:
                    p.join(max(0.0, end - time.monotonic()))
                failure = "; ".join(
                    f"rank {r} of {world} exited with code {p.exitcode}"
                    for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0))
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() - t0 > timeout:
                late = [r for r, c in enumerate(codes) if c is None]
                failure = (f"ranks {late} of {world} still running after "
                           f"{timeout} s")
            else:
                procs[[c is None for c in codes].index(True)].join(0.05)
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(30)
    if failure:
        raise RuntimeError(failure)
    return time.monotonic() - t0
