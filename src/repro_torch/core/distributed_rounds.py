"""Distributed coherence rounds: the latch plane at mesh scale.

Counterpart of ``repro/core/distributed_rounds.py``.  The latch-word
array is sharded over a :class:`~repro_torch.core.rounds.mesh.Mesh` in
stripe layout (line ``l`` homes on shard ``l % S`` at local index
``l // S``; :func:`stripe` / :func:`unstripe` permute a line-major
array), each round's requests are sorted into per-home buckets
(:func:`_bucket`), the buckets cross to their homes, every home applies
its requests with the ``latch_ops`` kernel (K1) on its own slab, and the
old words travel back.  The reference does the two crossings with
``all_to_all``s inside ``shard_map``.  Here, with every shard in one
process, a crossing is a transpose of the stacked ``[S_src, S_dst,
cap]`` buckets and the ``psum`` of the dropped count a sum over the
shard axis; over ``torch.distributed`` ranks (a mesh with a process
group) a crossing is one ``all_to_all_single`` and the ``psum`` an
``all_reduce``.  Requests past a bucket's capacity are not
sent; they come back in ``keep`` and ``dropped``.  The full sharded MSI
engine (:mod:`repro_torch.core.rounds.sharded`) reuses :func:`_bucket`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.latch_ops import apply_batch

AXIS = "shards"       # the port's Mesh has this one axis
FIELDS = ("line", "op", "arg_hi", "arg_lo", "cmp_hi", "cmp_lo")


def make_sharded_words(n_lines: int, mesh, axis: str = AXIS):
    """Zeroed latch words [n_lines, 2] int32 on the mesh's device, in
    stripe layout (``n_lines`` must divide by the shard count)."""
    from .rounds.mesh import shards_of
    n = shards_of(mesh, axis)
    if n_lines % n:
        raise ValueError(f"n_lines={n_lines} not divisible by "
                         f"n_shards={n}")
    return torch.zeros((n_lines, 2), dtype=torch.int32, device=mesh.device)


def _bucket(requests, n_shards: int, cap: int, fields=FIELDS, home=None):
    """Sort each source shard's requests into per-home buckets.

    ``requests`` holds ``[*lead, R, *rest]`` tensors (``lead`` is empty
    for one shard's requests, ``[S]`` for every shard's at once);
    ``home`` ``[*lead, R]`` is each slot's destination shard
    (``n_shards`` = pad / no send), by default ``line % n_shards`` for
    ``line >= 0``.  Returns ``(buckets, order, keep, (b_idx, s_idx),
    dropped)`` as the reference's does: ``buckets[k]`` is ``[*lead,
    n_shards, cap, *rest]`` int32 (``line`` -1 and the rest 0 where
    empty), ``order`` the STABLE sort of each row by home (within a
    bucket, slot order is the serialization order the home's round body
    keeps), ``keep`` / ``b_idx`` / ``s_idx`` in sorted order (``b_idx =
    n_shards`` and ``s_idx = 0`` where not kept), and ``dropped`` the
    overflowed requests a row."""
    line = requests["line"]
    if home is None:
        home = torch.where(line >= 0, line % n_shards, n_shards)
    home = home.to(torch.int64)
    lead = tuple(home.shape[:-1])
    r = home.shape[-1]
    n_rows = 1
    for d in lead:
        n_rows *= d
    dev = home.device
    order = torch.argsort(home, dim=-1, stable=True)
    home_sorted = home.gather(-1, order)
    onehot = F.one_hot(home_sorted, n_shards + 1)
    slot = (onehot.cumsum(-2) - 1).gather(
        -1, home_sorted.unsqueeze(-1)).squeeze(-1)
    keep = (home_sorted < n_shards) & (slot < cap)
    b_idx = torch.where(keep, home_sorted, n_shards)
    s_idx = torch.where(keep, slot, 0)
    # each kept entry's cell in the flattened [*lead, S, cap] buckets;
    # pads and overflow land in one sink row past the end, dropped
    row = torch.arange(n_rows, device=dev).view(*lead, 1)
    n_cells = n_rows * n_shards * cap
    cell = torch.where(keep, (row * n_shards + b_idx) * cap + s_idx,
                       n_cells).reshape(-1)
    src = (row * r + order).reshape(-1)
    out = {}
    for k in fields:
        v = requests[k]
        rest = tuple(v.shape[len(lead) + 1:])
        flat = v.reshape((n_rows * r,) + rest)[src].to(torch.int32)
        buf = torch.full((n_cells + 1,) + rest, -1 if k == "line" else 0,
                         dtype=torch.int32, device=dev)
        buf.index_copy_(0, cell, flat)
        out[k] = buf[:n_cells].view(lead + (n_shards, cap) + rest)
    dropped = ((home_sorted < n_shards) & ~keep).sum(-1, dtype=torch.int32)
    return out, order, keep, (b_idx, s_idx), dropped


def _unbucket(back, order, keep, b_idx, s_idx):
    """Replies ``back`` ``[*lead, S, cap, *rest]`` (what each source got
    back from each home) -> ``[*lead, R, *rest]`` in the original slot
    order, 0 where a slot was not sent."""
    lead = tuple(order.shape[:-1])
    n_shards, cap = back.shape[len(lead)], back.shape[len(lead) + 1]
    rest = tuple(back.shape[len(lead) + 2:])
    n_rows = 1
    for d in lead:
        n_rows *= d
    row = torch.arange(n_rows, device=back.device).view(*lead, 1)
    cell = ((row * n_shards + b_idx.clamp(max=n_shards - 1)) * cap
            + s_idx).reshape(-1)
    got = back.reshape((n_rows * n_shards * cap,) + rest)[cell]
    mask = keep.reshape((-1,) + (1,) * len(rest))
    got = torch.where(mask, got, torch.zeros_like(got))
    r = order.shape[-1]
    inv = torch.argsort(order.reshape(n_rows, r), dim=-1)
    rows = torch.arange(n_rows, device=back.device)[:, None]
    return got.view((n_rows, r) + rest)[rows, inv].view(lead + (r,) + rest)


def _ranks(mesh) -> int:
    """The world a crossing spans: 0 for a mesh without a process group
    (every shard in this process), else the group's size."""
    return mesh.world if mesh is not None and mesh.ranked else 0


def exchange(buckets: torch.Tensor, mesh=None) -> torch.Tensor:
    """The ``all_to_all(x, axis, 0, 0, tiled=False)`` of a round:
    ``[k_src, S_dst, cap, *rest]`` buckets of this process's ``k``
    source shards -> what its ``k`` homes receive, ``[k_dst, S_src * cap,
    *rest]`` in source-major order.  Without a process group (``k =
    S``) it is a transpose; over W ranks each rank sends every other
    rank the buckets bound for that rank's homes
    (``Mesh.all_to_all``)."""
    k, s, cap = buckets.shape[:3]
    rest = tuple(buckets.shape[3:])
    w = _ranks(mesh)
    if not w:
        return buckets.transpose(0, 1).reshape((s, s * cap) + rest)
    send = buckets.reshape((k, w, s // w, cap) + rest).transpose(0, 1)
    got = mesh.all_to_all(send.flatten(0, 3))
    return got.view((w, k, s // w, cap) + rest).permute(
        2, 0, 1, 3, *range(4, 4 + len(rest))).reshape((s // w, s * cap)
                                                      + rest)


def reply(per_home: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reply ``all_to_all``: this process's homes' ``[k_dst, S_src *
    cap, *rest]`` results -> ``[k_src, S_dst, cap, *rest]`` at its
    sources (a view without a process group)."""
    k = per_home.shape[0]
    w = _ranks(mesh)
    s = k * w if w else k
    cap = per_home.shape[1] // s
    rest = tuple(per_home.shape[2:])
    if not w:
        return per_home.view((s, s, cap) + rest).transpose(0, 1)
    send = per_home.view((k, w, k, cap) + rest).transpose(0, 1)
    got = mesh.all_to_all(send.flatten(0, 3))
    return got.view((w, k, k, cap) + rest).permute(
        2, 0, 1, 3, *range(4, 4 + len(rest))).reshape((k, s, cap) + rest)


def distributed_latch_round(words, requests, *, mesh, axis: str = AXIS):
    """One round of the latch plane: ``words`` [L, 2] int32 in stripe
    layout on the mesh's device (over ranks, this rank's shards' slabs),
    ``requests`` a dict of the six int32 [R] kernel fields with GLOBAL
    line ids, R a multiple of the shard count (shard ``s`` presents
    slots ``[s*R/S, (s+1)*R/S)``; each bucket holds R/S).  Each home
    applies its bucket with K1 on its slab.

    Returns ``(new_words, old_hi [R], old_lo [R], ok [R], dropped)``,
    the replies all-gathered over ranks.  The reference's default axis
    name is ``"model"``; the port's mesh has the one axis ``"shards"``."""
    from .rounds.mesh import check_on_mesh, shards_of
    n = shards_of(mesh, axis)
    check_on_mesh({"words": words}, mesh)
    ranked = _ranks(mesh)
    k, first = (mesh.local(axis), mesh.block(axis)[0]) if ranked \
        else (n, 0)
    xmesh = mesh if ranked else None
    rt = requests["line"].shape[0]
    if rt % n:
        raise ValueError(f"R={rt} not divisible by n_shards={n}")
    r = rt // n
    l_local = words.shape[0] // k
    req = {f: requests[f].to(torch.int32)[first * r:(first + k) * r]
           .reshape(k, r) for f in FIELDS}
    buckets, order, keep, (b_idx, s_idx), dropped = _bucket(req, n, r)
    recv = {f: exchange(v, xmesh) for f, v in buckets.items()}
    new_words = torch.empty_like(words)
    his, los, oks = [], [], []
    for h in range(k):
        flat = {f: recv[f][h] for f in FIELDS}
        line = flat["line"]
        flat["line"] = torch.where(line >= 0, line // n, -1) \
            .to(torch.int32)
        sl = slice(h * l_local, (h + 1) * l_local)
        new_words[sl], old_hi, old_lo, ok = apply_batch(words[sl], flat)
        his.append(old_hi)
        los.append(old_lo)
        oks.append(ok)

    def back(per_home):
        got = _unbucket(reply(torch.stack(per_home), xmesh), order, keep,
                        b_idx, s_idx).reshape(k * r)
        return mesh.all_gather(got) if ranked else got
    dropped = dropped.sum(dtype=torch.int32)
    if ranked:
        dropped = mesh.all_reduce(dropped.reshape(1))[0]
    return new_words, back(his), back(los), back(oks), dropped


def stripe(words_flat, n_shards: int):
    """[L, 2] line-major -> stripe-major layout (home-contiguous)."""
    from .rounds.state import stripe_lines
    return stripe_lines(words_flat, n_shards, 0)


def unstripe(words_striped, n_shards: int):
    from .rounds.state import unstripe_lines
    return unstripe_lines(words_striped, n_shards, 0)
