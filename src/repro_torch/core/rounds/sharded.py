"""Mesh-sharded device rounds: the full MSI engine, striped across shards.

Counterpart of ``repro/core/rounds/sharded.py``, whose module docstring
describes the design; it is the same here step for step:

* every line-indexed leaf lives in PHYSICAL-SLOT layout: line ``l``
  occupies slot ``p = home[l]`` (the identity without a home directory)
  on shard ``p % S`` at local index ``p // S``, so each shard owns one
  contiguous slab along each leaf's line axis (``state.LINE_AXIS``);
  the ``GLOBAL_LEAVES`` (the directory and the replica plane) are held
  once;
* each round, every source shard buckets its pending slots by home
  (``distributed_rounds._bucket``, a stable sort: slot order is the
  serialization order of the home's round body), the buckets cross to
  the homes, each home runs the flat round body (``engine._round_impl``,
  K1 and, on payload planes, K2) on its slab, and the replies cross
  back;
* a request past its (source, home) bucket's capacity stays pending
  and re-presents next round, counted in ``deferred``;
* a read of a replicated line with a valid image is served on its
  source shard from the image taken before the round, and the homes
  republish the image after it;
* the drivers accumulate the congestion telemetry: ``occupancy`` /
  ``deferred`` [S, S] (row = source, column = home), ``served_per_home``
  and ``replica_served`` [S], and per-slot ``slot_hits`` / ``slot_whits``
  [L] in slab-concatenation order.

What differs from the reference: the S shards live in one process
(a :class:`~repro_torch.core.rounds.mesh.Mesh` without a process group)
or are split over ``torch.distributed`` ranks in blocks (a mesh with a
group: rank ``r`` holds shards ``[r*k, (r+1)*k)``, ``k = S/W``).  The
drivers run SPMD, as ``shard_map`` runs its body: every rank calls them
with the same GLOBAL op slots, keeps only its shards' slabs of the
striped leaves (the global leaves whole), presents its block of slots,
and gets every result all-gathered, so each caller sees exactly what the
one-process mesh returns.  The two ``all_to_all``s of a round are
``distributed_rounds.exchange`` / ``reply`` (index moves inside a
process, ``all_to_all_single`` across ranks), each ``psum`` a sum over
the shards in the process and an ``all_reduce`` across ranks; the home
round bodies of a process run one after another, each updating its
slab in place.  The reference's one ``lax.while_loop`` is a host loop
here that syncs once a round on the global pending count.  A slot of
source shard ``s`` is global slot ``s * R/S + i``: the reference's block
distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import coherence as co
from ..distributed_rounds import _bucket, _unbucket, exchange, reply
from . import state as st
from .descent import _walk
from .driver import _as_ops, _ops_wdata, _rmw, _spin, add_tele
from .engine import _evict_impl, _round_impl
from .mesh import AXIS, check_on_mesh, shards_of
from .placement import _host

OP_FIELDS = ("node", "line", "isw")


# ---------------------------------------------------------------- geometry

class _Geo:
    """Where a process sits on the plane's mesh: ``s`` shards in all,
    ``k`` of them here, the first being shard ``first``."""

    def __init__(self, mesh, axis: str = AXIS):
        self.s = shards_of(mesh, axis)
        self.mesh = mesh
        self.ranked = mesh.ranked
        if self.ranked and mesh.ranked_axis != axis:
            raise ValueError(f"the mesh splits {mesh.ranked_axis!r} over "
                             f"its ranks, not the plane's axis {axis!r}")
        self.k = mesh.local(axis) if self.ranked else self.s
        self.first = mesh.block(axis)[0] if self.ranked else 0

    def block(self, x, r: int):
        """This process's block of global slots (``r`` a shard)."""
        return x[self.first * r:(self.first + self.k) * r]

    def gather(self, x):
        """Every process's block along dim 0, in shard order."""
        return self.mesh.all_gather(x) if self.ranked else x

    def psum(self, x):
        return self.mesh.all_reduce(x) if self.ranked else x

    def count(self, flags) -> int:
        """The global number of set ``flags`` (one sync)."""
        if not self.ranked:
            return int(flags.sum())
        return int(self.mesh.all_reduce(
            flags.sum(dtype=torch.int32).reshape(1)))


def lines_of(state, mesh=None, axis: str = AXIS) -> int:
    """The global line count of a state: its rows, times the ranks
    when a process group splits the mesh."""
    rows = int(state["words"].shape[0])
    if mesh is not None and mesh.ranked:
        return rows * mesh.shape[axis] // mesh.local(axis)
    return rows


# --------------------------------------------------------------- state I/O

def _local_rows(v, ax: int, geo: _Geo):
    """The rows of this process's shards of a stripe-layout leaf (its
    own copy)."""
    rows = v.shape[ax] // geo.s
    return v.narrow(ax, geo.first * rows, geo.k * rows).clone(
        memory_format=torch.contiguous_format)


def shard_state(state, mesh, axis: str = AXIS) -> dict:
    """Flat (line-major) round state -> stripe layout over ``mesh[axis]``
    (contiguous leaves on the mesh's device); over ranks every rank
    passes the same flat state and keeps its shards' slabs.  n_lines
    must divide evenly by the shard count; a state on another device
    raises."""
    geo = _Geo(mesh, axis)
    check_on_mesh(state, mesh)
    n_lines = state["words"].shape[0]
    if n_lines % geo.s:
        raise ValueError(
            f"n_lines={n_lines} not divisible by n_shards={geo.s}")
    out = {}
    for k, v in st.stripe_state(state, geo.s).items():
        if k in st.GLOBAL_LEAVES:
            out[k] = v
        elif geo.ranked:
            out[k] = _local_rows(v, st.LINE_AXIS[k], geo)
        else:
            out[k] = v.contiguous()
    return out


def gather_state(state, mesh, axis: str = AXIS, keys=None) -> dict:
    """The whole stripe-layout state (or its ``keys``) on every rank:
    each striped leaf's slabs all-gathered along its line axis; the
    state itself without a process group."""
    geo = _Geo(mesh, axis)
    keys = tuple(state) if keys is None else tuple(keys)
    if not geo.ranked:
        return {k: state[k] for k in keys}
    return {k: state[k] if k in st.GLOBAL_LEAVES
            else geo.mesh.all_gather(state[k], st.LINE_AXIS[k])
            for k in keys}


def unshard_state(state, mesh=None, axis: str = AXIS, *,
                  n_shards: int | None = None) -> dict:
    """Sharded stripe-layout state -> flat line-major state (copies, on
    the state's device), on every rank of a ranked mesh.  Accepts either
    the mesh or a shard count (one process)."""
    if mesh is not None:
        n_shards = shards_of(mesh, axis)
        state = gather_state(state, mesh, axis)
    return st.unstripe_state(state, n_shards)


def read_rows(state, mesh, key: str, rows, axis: str = AXIS):
    """Leaf ``key`` at GLOBAL stripe-layout rows ``rows`` (a 1-D long
    tensor), the same on every rank: each rank reads the rows its slabs
    hold and an ``all_reduce`` adds the zeros elsewhere."""
    v = state[key]
    ax = st.LINE_AXIS[key]
    if mesh is None or not mesh.ranked:
        return v.index_select(ax, rows)
    n = v.shape[ax]
    base = _Geo(mesh, axis).first * (n // mesh.local(axis))
    own = (rows >= base) & (rows < base + n)
    got = v.index_select(ax, (rows - base).clamp(0, n - 1))
    shape = [1] * got.dim()
    shape[ax] = -1
    got = torch.where(own.view(shape), got, torch.zeros_like(got))
    return mesh.all_reduce(got)


def make_sharded_state(n_nodes: int, n_lines: int, mesh,
                       axis: str = AXIS, *, write_back: bool = False,
                       payload_width: int = 0, home_directory: bool = False,
                       replicas: bool = False) -> dict:
    """Fresh sharded round state on the mesh's device.  ``n_lines`` is
    rounded UP to a multiple of the shard count.  A fresh state's
    striped leaves are zeros and its directory (a global leaf) is the
    identity, so the flat ``make_state`` is already in stripe layout;
    over ranks each rank makes its shards' slabs and the global leaves
    whole."""
    geo = _Geo(mesh, axis)
    n_lines = -(-n_lines // geo.s) * geo.s
    kw = dict(write_back=write_back, payload_width=payload_width,
              device=mesh.device)
    if not geo.ranked:
        return st.make_state(n_nodes, n_lines, home_directory=home_directory,
                             replicas=replicas, **kw)
    state = st.make_state(n_nodes, n_lines // geo.s * geo.k, **kw)
    glob = st.make_state(1, n_lines, payload_width=payload_width
                         if replicas else 0, home_directory=home_directory,
                         replicas=replicas, device=mesh.device)
    state.update({k: v for k, v in glob.items() if k in st.GLOBAL_LEAVES})
    return state


def _i32(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.int32)
    return torch.from_numpy(np.asarray(x, np.int32))


def pad_ops(node_id, line, is_write, n_shards: int, wdata=None):
    """Pad op slots with empty (line = -1) entries so the slot count
    divides evenly across shards (each shard presents R/S slots).  With
    ``wdata`` [R, W], pads it with zero payloads too and returns a
    4-tuple.  Tensors stay on their device; anything else becomes a CPU
    int32 tensor."""
    node_id, line, is_write = _i32(node_id), _i32(line), _i32(is_write)
    pad = (-line.shape[0]) % n_shards

    def grow(x, fill):
        if not pad:
            return x
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])
    out = (grow(node_id, 0), grow(line, -1), grow(is_write, 0))
    if wdata is None:
        return out
    return out + (grow(_i32(wdata), 0),)


def _check_slots(r_total: int, n_shards: int, what: str = "R") -> int:
    if r_total % n_shards:
        raise ValueError(f"{what}={r_total} not divisible by "
                         f"n_shards={n_shards} (use pad_ops)")
    return r_total // n_shards


def _slab(state, h: int, n_shards: int) -> dict:
    """Home ``h``'s view of the state: a slab view of every striped leaf
    (writes land in the global leaves) and the global leaves whole."""
    out = {}
    for k, v in state.items():
        if k in st.GLOBAL_LEAVES:
            out[k] = v
        else:
            ax = st.LINE_AXIS[k]
            ll = v.shape[ax] // n_shards
            out[k] = v.narrow(ax, h * ll, ll)
    return out


def _slot_of(state, line):
    """Physical slot of each line (-1 stays -1): the directory when the
    state has one, the line itself otherwise."""
    perm = state.get("home")
    if perm is None:
        return line
    return torch.where(line >= 0, perm[line.long().clamp(min=0)], -1)


def _home_of(state, line, n_shards: int):
    """Destination shard per slot; ``n_shards`` for an empty slot."""
    slot = _slot_of(state, line)
    return torch.where(line >= 0, slot % n_shards, n_shards)


def _local_index(state, line, n_shards: int):
    """Global line -> index in its home's slab (-1 stays -1)."""
    slot = _slot_of(state, line)
    return torch.where(line >= 0, slot // n_shards, -1).to(torch.int32)


# ------------------------------------------------------------ one round

def _zero_tele(n_shards: int, n_lines: int, device=None,
               k: int | None = None) -> dict:
    """Zeroed sharded telemetry accumulator (the drivers' trailing
    dict): ``occupancy`` / ``deferred`` [k, S], ``served_per_home`` /
    ``replica_served`` [k], ``slot_hits`` / ``slot_whits`` [n_lines]
    (``k`` = S, the whole mesh, unless a rank's block is meant).
    Rounds add into it with ``driver.add_tele``, as on the flat
    plane."""
    k = n_shards if k is None else k

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return {"occupancy": z(k, n_shards),
            "deferred": z(k, n_shards),
            "served_per_home": z(k), "replica_served": z(k),
            "slot_hits": z(n_lines), "slot_whits": z(n_lines)}


def _gather_tele(tele, geo: _Geo) -> dict:
    """A rank's telemetry blocks -> the mesh's (every key along dim
    0: sources, homes or slab rows in shard order), in one all-gather
    of the keys packed end to end."""
    if not geo.ranked:
        return tele
    got = geo.gather(torch.cat([v.reshape(-1) for v in tele.values()])[None])
    out, at = {}, 0
    for k, v in tele.items():
        n = v.numel()
        out[k] = got[:, at:at + n].reshape((-1,) + tuple(v.shape[1:]))
        at += n
    return out


def _lanes(scalars, lanes=None):
    """int32 per-slot ``scalars`` (each ``[..]``) and optional ``lanes``
    (``[.., W]``) side by side on one last axis: one crossing instead of
    one a field."""
    return torch.cat([x.to(torch.int32).unsqueeze(-1) for x in scalars]
                     + ([lanes] if lanes is not None else []), -1)


def _replica_refresh(state, geo: _Geo) -> dict:
    """Republish the read-replica image at the round boundary: each
    line's home contributes its memory version and bytes where no
    exclusive holder exists, and the sum of the contributions (the
    reference's psum: exactly one shard owns each line; an
    ``all_reduce`` across ranks) becomes the image every shard holds.
    A write granted M drops ``replica_ok`` at the next boundary —
    replica invalidation rides the normal MSI write path."""
    perm = state.get("home")
    l_total = state["replica"].shape[0]
    rows = state["words"].shape[0]
    slot = (perm.long() if perm is not None
            else torch.arange(l_total, device=state["replica"].device))
    pos = st.slot_positions(slot, geo.s)
    base = geo.first * (l_total // geo.s)
    own = (pos >= base) & (pos < base + rows)
    lpos = (pos - base).clamp(0, rows - 1)
    no_m = ~(state["cache_state"] == co.M).any(dim=0)
    okc = state["replica"] & own & no_m[lpos]
    ok = geo.psum(okc.to(torch.int32)) > 0
    out = dict(state)
    out["replica_ok"] = ok
    ver = geo.psum(torch.where(okc, state["mem_version"][lpos], 0))
    out["replica_version"] = torch.where(ok, ver, state["replica_version"])
    if "replica_data" in state:
        data = geo.psum(torch.where(okc[:, None], state["mem_data"][lpos],
                                    0))
        out["replica_data"] = torch.where(ok[:, None], data,
                                          state["replica_data"])
    return out


def _route_round(state, node, pending, isw, wdata, *, geo: _Geo,
                 n_nodes: int, cap: int):
    """One sharded round over this process's slots [k*R/S] (its ``k``
    source shards' blocks of the global slots): serve replica reads at
    their source, bucket the rest by home (through the directory when
    present), cross to the homes, run the flat round body at each of
    this process's homes on its slab, send the replies back, republish
    the replica image.  Returns ``(state', served, version, data [.., W],
    tele)`` over this process's slots, ``tele`` this round's telemetry
    delta in its blocks; a slot that overflowed its bucket comes back
    unserved."""
    s, k = geo.s, geo.k
    r_local = pending.shape[0]
    r = r_local // k
    width = wdata.shape[1]
    rows = state["words"].shape[0]
    l_local = rows // k
    dev = pending.device
    valid = pending >= 0
    idx = pending.long().clamp(min=0)
    rserve_data = None
    if "replica" in state:
        # a pure read of a replicated line with a valid image never
        # leaves its source shard; it reads the PRE-round image
        rserve = (valid & (isw == 0) & state["replica"][idx]
                  & state["replica_ok"][idx])
        route = torch.where(rserve, -1, pending)
        rserve_ver = state["replica_version"][idx]
        if "replica_data" in state:
            rserve_data = state["replica_data"][idx]
    else:
        rserve = torch.zeros_like(valid)
        route = pending
    home = _home_of(state, route, s)
    fields = OP_FIELDS + ("wdata",) if width else OP_FIELDS
    reqs = {"node": node, "line": route, "isw": isw}
    if width:
        reqs["wdata"] = wdata
    reqs = {f: v.reshape((k, r) + tuple(v.shape[1:]))
            for f, v in reqs.items()}
    buckets, order, keep, (b_idx, s_idx), _ = _bucket(
        reqs, s, cap, fields=fields, home=home.view(k, r))
    mesh = geo.mesh if geo.ranked else None
    got = exchange(_lanes([buckets[f] for f in OP_FIELDS],
                          buckets.get("wdata")), mesh)   # [k, S*cap, 3+W]
    recv = {f: got[..., i].contiguous() for i, f in enumerate(OP_FIELDS)}
    if width:
        recv["wdata"] = got[..., len(OP_FIELDS):].contiguous()
    loc = _local_index(state, recv["line"], s)
    out = dict(state)
    served_h, ver_h, data_h = [], [], []
    for h in range(k):
        slab = _slab(state, h, k)
        new, sv, vr, dt = _round_impl(
            slab, recv["node"][h], loc[h], recv["isw"][h],
            recv["wdata"][h] if width else None, n_nodes=n_nodes)
        slab["words"].copy_(new["words"])
        for key in ("replica_ok", "replica_version", "replica_data"):
            if key in new:    # the flat refresh runs at one shard only
                out[key] = new[key]
        served_h.append(sv)
        ver_h.append(vr)
        data_h.append(dt)
    if "replica" in state:
        out = _replica_refresh(out, geo)
    served_h = torch.stack(served_h)                          # [k, S*cap]

    replies = _lanes([served_h, torch.stack(ver_h)],
                     torch.stack(data_h) if width else None)
    replies = _unbucket(reply(replies, mesh), order, keep, b_idx,
                        s_idx).reshape(r_local, 2 + width)
    served = replies[:, 0].bool() | rserve
    version = replies[:, 1]
    data = replies[:, 2:]
    if "replica" in state:
        version = torch.where(rserve, rserve_ver, version)
        if rserve_data is not None:
            data = torch.where(rserve[:, None], rserve_data, data)
    # congestion telemetry: bucket occupancy and defers per (source,
    # home), ops served at each home, replica serves per source, and
    # per-slot hits in slab-concatenation order
    sent = keep.gather(-1, torch.argsort(order, dim=-1)).reshape(-1)
    src = torch.arange(k, device=dev).repeat_interleave(r)
    cell = src * s + home.clamp(max=s - 1)
    occ = torch.zeros(k * s, dtype=torch.int32, device=dev).index_add_(
        0, cell, sent.to(torch.int32)).view(k, s)
    dfr = torch.zeros(k * s, dtype=torch.int32, device=dev).index_add_(
        0, cell, ((route >= 0) & ~sent).to(torch.int32)).view(k, s)
    at = (torch.arange(k, device=dev)[:, None] * l_local
          + loc.long().clamp(min=0)).reshape(-1)
    hit = served_h.reshape(-1).to(torch.int32)
    whit = hit * recv["isw"].reshape(-1).bool().to(torch.int32)
    tele = {"occupancy": occ, "deferred": dfr,
            "served_per_home": served_h.sum(dim=1, dtype=torch.int32),
            "replica_served": rserve.view(k, r).sum(dim=1,
                                                    dtype=torch.int32),
            "slot_hits": torch.zeros(rows, dtype=torch.int32,
                                     device=dev).index_add_(0, at, hit),
            "slot_whits": torch.zeros(rows, dtype=torch.int32,
                                      device=dev).index_add_(0, at, whit)}
    return out, served, version, data, tele


def _prepare(state, mesh, axis, n_nodes, node_id, line, is_write, wdata,
             bucket_cap):
    """Shared argument handling of the sharded round and its driver:
    checks, ops on the state's device, the bucket capacity (default
    R/S: no overflow) and a zero payload where none is given.  Returns
    the geometry, the slots per shard and this process's block of the
    global slots."""
    co.check_node_capacity(n_nodes)
    geo = _Geo(mesh, axis)
    check_on_mesh(state, mesh)
    node_id, line, is_write = _as_ops(state, node_id, line, is_write)
    r = _check_slots(line.shape[0], geo.s)
    cap = bucket_cap if bucket_cap is not None else r
    wdata = _ops_wdata(state, line, wdata)
    return (geo, r, cap, *(geo.block(x, r)
                           for x in (node_id, line, is_write, wdata)))


def coherence_round_sharded(state, node_id, line, is_write, wdata=None, *,
                            mesh, axis: str = AXIS, n_nodes: int,
                            bucket_cap: int | None = None):
    """One sharded round over GLOBAL op slots [R] (R divisible by the
    shard count; line = -1 empty).  Returns ``(state', served[R],
    version[R], data[R, W])``; overflowed slots return unserved."""
    geo, r, cap, node_l, line_l, isw_l, wd_l = _prepare(
        state, mesh, axis, n_nodes, node_id, line, is_write, wdata,
        bucket_cap)
    state, served, ver, data, _ = _route_round(
        state, node_l, line_l, isw_l, wd_l, geo=geo, n_nodes=n_nodes,
        cap=cap)
    got = geo.gather(_lanes([served, ver], data))
    return state, got[:, 0].bool(), got[:, 1], got[:, 2:]


# ------------------------------------------------------- the drivers

def run_rounds_sharded(state, node_id, line, is_write, wdata=None, *,
                       mesh, axis: str = AXIS, n_nodes: int,
                       max_rounds: int = 64,
                       bucket_cap: int | None = None):
    """Drive GLOBAL op slots [R] to completion across the mesh — the
    sharded mirror of :func:`driver.run_rounds`.  Returns ``(state',
    versions[R], data[R, W], rounds_used, all_served, telemetry)``:
    tensors on the state's device, the host int / bool the loop knows,
    and the telemetry dict (:func:`_zero_tele` keys).  Unserved slots
    (latch contention or bucket overflow) re-present round after round,
    payload included.  Over ranks every rank runs its block of the
    slots while any slot of the mesh is pending."""
    geo, r, cap, node_l, line_l, isw_l, wd_l = _prepare(
        state, mesh, axis, n_nodes, node_id, line, is_write, wdata,
        bucket_cap)

    def step(stt, pending, tele):
        stt, served, ver, rdata, dtele = _route_round(
            stt, node_l, pending, isw_l, wd_l, geo=geo, n_nodes=n_nodes,
            cap=cap)
        return stt, served, ver, rdata, add_tele(tele, dtele)
    state, versions, data, rounds, done, tele = _spin(
        state, line_l, wd_l.shape[1], max_rounds=max_rounds, step=step,
        tele=_zero_tele(geo.s, state["words"].shape[0], line_l.device,
                        geo.k),
        n_pending=geo.count if geo.ranked else None)
    got = geo.gather(_lanes([versions], data))
    return (state, got[:, 0], got[:, 1:], rounds, done,
            _gather_tele(tele, geo))


def run_rmw_sharded(state, node_id, line, operands=(), *, modify, mesh,
                    axis: str = AXIS, n_nodes: int, max_rounds: int = 64,
                    bucket_cap: int | None = None):
    """Sharded mirror of :func:`driver.run_rmw`: the S-grant read phase,
    ``modify(data, line, *operands)`` on the gathered ``[R, W]`` bytes
    (on every rank), then the S->X upgrade write phase, each through
    :func:`run_rounds_sharded`.  Same return contract (telemetry summed
    over both phases, the write phase's versions and bytes)."""
    node_id, line = _as_ops(state, node_id, line)
    return _rmw(state, node_id, line, operands, modify,
                lambda *a: run_rounds_sharded(
                    *a, mesh=mesh, axis=axis, n_nodes=n_nodes,
                    max_rounds=max_rounds, bucket_cap=bucket_cap))


def run_descent_sharded(state, node_id, key, root, *, transition, mesh,
                        axis: str = AXIS, n_nodes: int,
                        max_steps: int = 64,
                        bucket_cap: int | None = None,
                        path_cap: int = 16):
    """Sharded mirror of :func:`descent.run_descent`: every undone
    slot's S-latch read routes to its line's home each step, and the
    caller's ``transition`` advances the slot where it lives.  A slot
    whose read lost a latch race or overflowed its bucket re-presents
    next step.  Same return contract as ``run_descent``, with the
    sharded telemetry dict; over ranks each rank walks its block of the
    slots while any slot of the mesh is undone, and the walks are
    all-gathered."""
    co.check_node_capacity(n_nodes)
    geo = _Geo(mesh, axis)
    check_on_mesh(state, mesh)
    node_id, key, root = _as_ops(state, node_id, key, root)
    b = root.shape[0]
    r = _check_slots(b, geo.s, "B")
    cap = bucket_cap if bucket_cap is not None else r
    width = st.payload_width(state)
    if not width:
        raise ValueError("run_descent_sharded needs a payload-plane "
                         "state (the transition decodes node bytes)")
    node_l, key_l, root_l = (geo.block(x, r) for x in (node_id, key, root))
    b_l = root_l.shape[0]
    no_write = torch.zeros((b_l,), dtype=torch.int32, device=root.device)
    no_bytes = torch.zeros((b_l, width), dtype=torch.int32,
                           device=root.device)

    def step(stt, line, tele):
        stt, served, _, d, dtele = _route_round(
            stt, node_l, line, no_write, no_bytes, geo=geo,
            n_nodes=n_nodes, cap=cap)
        return stt, served, d, add_tele(tele, dtele)
    (state, cur, lanes, levels, hops, paths, plen, steps, done,
     tele) = _walk(state, key_l, root_l, transition=transition,
                   max_steps=max_steps, path_cap=path_cap, step=step,
                   tele=_zero_tele(geo.s, state["words"].shape[0],
                                   root.device, geo.k),
                   n_left=geo.count if geo.ranked else None)
    got = geo.gather(_lanes([cur, levels, hops, plen],
                            torch.cat([lanes, paths], 1)))
    return (state, got[:, 0], got[:, 4:4 + width], got[:, 1], got[:, 2],
            got[:, 4 + width:], got[:, 3], steps, done,
            _gather_tele(tele, geo))


# --------------------------------------------------------------- eviction

def evict_lines_sharded(state, node_id, line, *, mesh, axis: str = AXIS,
                        bucket_cap: int | None = None) -> dict:
    """Sharded :func:`engine.evict_lines`: eviction slots [R] route to
    their homes (the same buckets; an overflowed slot goes next pass,
    ``ceil(R/S / cap)`` passes in all) and apply to the slabs, releasing
    the holder's latch and flushing dirty exclusive copies first.  Then
    every evicted line's replica image is invalidated.  Consumes the
    state (in place) and returns the new state dict; over ranks every
    rank passes the same global slots and routes its block."""
    geo = _Geo(mesh, axis)
    check_on_mesh(state, mesh)
    node_id, line = _as_ops(state, node_id, line)
    r = _check_slots(line.shape[0], geo.s)
    cap = bucket_cap if bucket_cap is not None else r
    s, k = geo.s, geo.k
    xmesh = geo.mesh if geo.ranked else None
    node_l = geo.block(node_id, r)
    pending = geo.block(line, r).clone()
    for _ in range(-(-r // cap)):
        home = _home_of(state, pending, s)
        buckets, order, keep, _, _ = _bucket(
            {"node": node_l.reshape(k, r), "line": pending.reshape(k, r)},
            s, cap, fields=("node", "line"), home=home.reshape(k, r))
        recv = {f: exchange(v, xmesh) for f, v in buckets.items()}
        loc = _local_index(state, recv["line"], s)
        for h in range(k):
            slab = _slab(state, h, k)
            new = _evict_impl(slab, recv["node"][h], loc[h])
            slab["words"].copy_(new["words"])
        sent = keep.gather(-1, torch.argsort(order, dim=-1)).reshape(-1)
        pending = torch.where(sent, -1, pending)
    state = dict(state)
    if "replica" in state:
        # eviction flushes can advance memory: invalidate the replica
        # image of every evicted line; the next round republishes it
        l_total = state["replica"].shape[0]
        emask = torch.zeros(l_total, dtype=torch.int32,
                            device=line.device).index_add_(
            0, line.long().clamp(min=0), (line >= 0).to(torch.int32)) > 0
        state["replica_ok"] = state["replica_ok"] & ~emask
    return state


# ----------------------------------------------------------- re-homing

def rehome_exchange(state, src_slot, dst_slot, new_home, *, mesh,
                    axis: str = AXIS) -> dict:
    """Move slab rows between physical slots and install a new home
    directory — the device half of :meth:`DevicePlane.rehome`.

    ``src_slot`` / ``dst_slot`` [M] (-1 in ``src_slot`` = empty) name
    row moves in PHYSICAL slot ids: the row at slot ``src_slot[i]``
    (shard ``src % S``, local index ``src // S``) moves to
    ``dst_slot[i]``.  The move set must permute the touched slots
    (``plane.rehome`` builds pairwise swaps).  Every striped leaf moves
    (latch words, MSI states, versions, payloads, dirty bits), all rows
    read before any is written; the global leaves (the replica plane)
    key by line id and stay.  ``new_home`` [L] is the post-exchange
    directory.  Legal only at op-quiescent boundaries; protocol state
    never changes, only where it lives."""
    if "home" not in state:
        raise ValueError("rehome_exchange needs a home-directory state "
                         "(make_state(..., home_directory=True))")
    geo = _Geo(mesh, axis)
    check_on_mesh(state, mesh)
    n_shards = geo.s
    src = np.asarray(_host(src_slot), np.int64).reshape(-1)
    dst = np.asarray(_host(dst_slot), np.int64).reshape(-1)
    use = src >= 0
    src, dst = src[use], dst[use]
    l_local = state["words"].shape[0] // geo.k
    dev = state["words"].device

    def rows(p):
        """Physical slots -> row in this process's slabs."""
        return torch.from_numpy((p % n_shards - geo.first) * l_local
                                + p // n_shards).to(dev)
    moved = tuple(sorted(k for k in state if k not in st.GLOBAL_LEAVES))
    if not geo.ranked:
        at_src, at_dst = rows(src), rows(dst)
        for k in moved:
            ax = st.LINE_AXIS[k]
            v = state[k]
            v.index_copy_(ax, at_dst, v.index_select(ax, at_src))
    else:
        # each rank sends the rows it holds to the ranks that hold their
        # destinations, grouped by destination rank in move order, and
        # receives its destinations' rows grouped by source rank
        w, me = geo.mesh.world, geo.mesh.rank
        src_rank, dst_rank = (src % n_shards) // geo.k, \
            (dst % n_shards) // geo.k
        out_i = np.flatnonzero(src_rank == me)
        out_i = out_i[np.argsort(dst_rank[out_i], kind="stable")]
        in_i = np.flatnonzero(dst_rank == me)
        in_i = in_i[np.argsort(src_rank[in_i], kind="stable")]
        in_splits = np.bincount(dst_rank[out_i], minlength=w).tolist()
        out_splits = np.bincount(src_rank[in_i], minlength=w).tolist()
        at_src, at_dst = rows(src[out_i]), rows(dst[in_i])
        for k in moved:
            ax = st.LINE_AXIS[k]
            v = state[k]
            send = v.index_select(ax, at_src).movedim(ax, 0)
            got = geo.mesh.all_to_all(send, out_splits, in_splits)
            v.index_copy_(ax, at_dst, got.movedim(0, ax))
    out = dict(state)
    out["home"] = torch.as_tensor(_host(new_home)).to(
        device=dev, dtype=torch.int32)
    return out
