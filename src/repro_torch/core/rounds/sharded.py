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

What differs from the reference: all S shards live on the mesh's one
device (:class:`~repro_torch.core.rounds.mesh.Mesh`).  The two
``all_to_all``s of a round are index moves along the shard axis
(``distributed_rounds.exchange`` / ``reply``) and each ``psum`` a sum
over it; the home round bodies run one after another, each updating its
slab of the global leaves in place.  The reference's one
``lax.while_loop`` is a host loop here that syncs once a round on the
pending flag, as the flat driver does.  A slot of source shard ``s`` is
global slot ``s * R/S + i``: the reference's block distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import coherence as co
from ..distributed_rounds import _bucket, _unbucket, exchange, reply
from . import state as st
from .descent import _walk
from .driver import _as_ops, _ops_wdata, _rmw, _spin, add_tele
from .engine import _evict_impl, _note_trace, _round_impl
from .mesh import AXIS, check_on_mesh, shards_of
from .placement import _host

OP_FIELDS = ("node", "line", "isw")


# --------------------------------------------------------------- state I/O

def shard_state(state, mesh, axis: str = AXIS) -> dict:
    """Flat (line-major) round state -> stripe layout over ``mesh[axis]``
    (contiguous leaves on the mesh's device).  n_lines must divide
    evenly by the shard count; a state on another device raises."""
    n_shards = shards_of(mesh, axis)
    check_on_mesh(state, mesh)
    n_lines = state["words"].shape[0]
    if n_lines % n_shards:
        raise ValueError(
            f"n_lines={n_lines} not divisible by n_shards={n_shards}")
    return {k: v if k in st.GLOBAL_LEAVES else v.contiguous()
            for k, v in st.stripe_state(state, n_shards).items()}


def unshard_state(state, mesh=None, axis: str = AXIS, *,
                  n_shards: int | None = None) -> dict:
    """Sharded stripe-layout state -> flat line-major state (copies, on
    the state's device).  Accepts either the mesh or a shard count."""
    if n_shards is None:
        n_shards = shards_of(mesh, axis)
    return st.unstripe_state(state, n_shards)


def make_sharded_state(n_nodes: int, n_lines: int, mesh,
                       axis: str = AXIS, *, write_back: bool = False,
                       payload_width: int = 0, home_directory: bool = False,
                       replicas: bool = False) -> dict:
    """Fresh sharded round state on the mesh's device.  ``n_lines`` is
    rounded UP to a multiple of the shard count.  A fresh state's
    striped leaves are zeros and its directory (a global leaf) is the
    identity, so the flat ``make_state`` is already in stripe layout."""
    n_shards = shards_of(mesh, axis)
    n_lines = -(-n_lines // n_shards) * n_shards
    return st.make_state(n_nodes, n_lines, write_back=write_back,
                         payload_width=payload_width,
                         home_directory=home_directory, replicas=replicas,
                         device=mesh.device)


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

def _zero_tele(n_shards: int, n_lines: int, device=None) -> dict:
    """Zeroed sharded telemetry accumulator (the drivers' trailing
    dict): ``occupancy`` / ``deferred`` [S, S], ``served_per_home`` /
    ``replica_served`` [S], ``slot_hits`` / ``slot_whits`` [L].  Rounds
    add into it with ``driver.add_tele``, as on the flat plane."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return {"occupancy": z(n_shards, n_shards),
            "deferred": z(n_shards, n_shards),
            "served_per_home": z(n_shards), "replica_served": z(n_shards),
            "slot_hits": z(n_lines), "slot_whits": z(n_lines)}


def _replica_refresh(state, *, n_shards: int) -> dict:
    """Republish the read-replica image at the round boundary: each
    line's home contributes its memory version and bytes where no
    exclusive holder exists, and the contributions become the image
    every shard holds (the reference's psum: exactly one shard owns each
    line).  A write granted M drops ``replica_ok`` at the next boundary
    — replica invalidation rides the normal MSI write path."""
    perm = state.get("home")
    l_total = state["replica"].shape[0]
    slot = (perm.long() if perm is not None
            else torch.arange(l_total, device=state["replica"].device))
    pos = st.slot_positions(slot, n_shards)
    no_m = ~(state["cache_state"] == co.M).any(dim=0)
    ok = state["replica"] & no_m[pos]
    out = dict(state)
    out["replica_ok"] = ok
    out["replica_version"] = torch.where(ok, state["mem_version"][pos],
                                         state["replica_version"])
    if "replica_data" in state:
        out["replica_data"] = torch.where(ok[:, None],
                                          state["mem_data"][pos],
                                          state["replica_data"])
    return out


def _route_round(state, node, pending, isw, wdata, *, n_shards: int,
                 n_nodes: int, cap: int):
    """One sharded round over global slots [R] (source shard ``s`` owns
    slots ``[s*R/S, (s+1)*R/S)``): serve replica reads at their source,
    bucket the rest by home (through the directory when present), run
    the flat round body at each home on its slab, send the replies
    back, republish the replica image.  Returns ``(state', served [R],
    version [R], data [R, W], tele)``, ``tele`` this round's telemetry
    delta; a slot that overflowed its bucket comes back unserved."""
    s = n_shards
    r_total = pending.shape[0]
    r = r_total // s
    width = wdata.shape[1]
    l_total = state["words"].shape[0]
    l_local = l_total // s
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
    reqs = {k: v.reshape((s, r) + tuple(v.shape[1:]))
            for k, v in reqs.items()}
    buckets, order, keep, (b_idx, s_idx), _ = _bucket(
        reqs, s, cap, fields=fields, home=home.view(s, r))
    recv = {k: exchange(v) for k, v in buckets.items()}      # [S, S*cap]
    loc = _local_index(state, recv["line"], s)
    out = dict(state)
    served_h, ver_h, data_h = [], [], []
    for h in range(s):
        slab = _slab(state, h, s)
        new, sv, vr, dt = _round_impl(
            slab, recv["node"][h], loc[h], recv["isw"][h],
            recv["wdata"][h] if width else None, n_nodes=n_nodes)
        slab["words"].copy_(new["words"])
        for k in ("replica_ok", "replica_version", "replica_data"):
            if k in new:      # the flat refresh runs at one shard only
                out[k] = new[k]
        served_h.append(sv)
        ver_h.append(vr)
        data_h.append(dt)
    if "replica" in state:
        out = _replica_refresh(out, n_shards=s)
    served_h = torch.stack(served_h)                          # [S, S*cap]

    def back(per_home):
        return _unbucket(reply(per_home), order, keep, b_idx, s_idx) \
            .reshape((r_total,) + tuple(per_home.shape[2:]))
    served = back(served_h.to(torch.int32)).bool() | rserve
    version = back(torch.stack(ver_h))
    if width:
        data = back(torch.stack(data_h))
    else:
        data = torch.zeros((r_total, 0), dtype=torch.int32, device=dev)
    if "replica" in state:
        version = torch.where(rserve, rserve_ver, version)
        if rserve_data is not None:
            data = torch.where(rserve[:, None], rserve_data, data)
    # congestion telemetry: bucket occupancy and defers per (source,
    # home), ops served at each home, replica serves per source, and
    # per-slot hits in slab-concatenation order
    sent = keep.gather(-1, torch.argsort(order, dim=-1)).reshape(-1)
    src = torch.arange(s, device=dev).repeat_interleave(r)
    cell = src * s + home.clamp(max=s - 1)
    occ = torch.zeros(s * s, dtype=torch.int32, device=dev).index_add_(
        0, cell, sent.to(torch.int32)).view(s, s)
    dfr = torch.zeros(s * s, dtype=torch.int32, device=dev).index_add_(
        0, cell, ((route >= 0) & ~sent).to(torch.int32)).view(s, s)
    at = (torch.arange(s, device=dev)[:, None] * l_local
          + loc.long().clamp(min=0)).reshape(-1)
    hit = served_h.reshape(-1).to(torch.int32)
    whit = hit * recv["isw"].reshape(-1).bool().to(torch.int32)
    tele = {"occupancy": occ, "deferred": dfr,
            "served_per_home": served_h.sum(dim=1, dtype=torch.int32),
            "replica_served": rserve.view(s, r).sum(dim=1,
                                                    dtype=torch.int32),
            "slot_hits": torch.zeros(l_total, dtype=torch.int32,
                                     device=dev).index_add_(0, at, hit),
            "slot_whits": torch.zeros(l_total, dtype=torch.int32,
                                      device=dev).index_add_(0, at, whit)}
    return out, served, version, data, tele


def _prepare(state, mesh, axis, n_nodes, node_id, line, is_write, wdata,
             bucket_cap):
    """Shared argument handling of the sharded round and its driver:
    checks, ops on the state's device, the bucket capacity (default
    R/S: no overflow) and a zero payload where none is given."""
    co.check_node_capacity(n_nodes)
    n_shards = shards_of(mesh, axis)
    check_on_mesh(state, mesh)
    node_id, line, is_write = _as_ops(state, node_id, line, is_write)
    r = _check_slots(line.shape[0], n_shards)
    cap = bucket_cap if bucket_cap is not None else r
    return (n_shards, node_id, line, is_write,
            _ops_wdata(state, line, wdata), cap)


def coherence_round_sharded(state, node_id, line, is_write, wdata=None, *,
                            mesh, axis: str = AXIS, n_nodes: int,
                            bucket_cap: int | None = None):
    """One sharded round over GLOBAL op slots [R] (R divisible by the
    shard count; line = -1 empty).  Returns ``(state', served[R],
    version[R], data[R, W])``; overflowed slots return unserved."""
    n_shards, node_id, line, is_write, wdata, cap = _prepare(
        state, mesh, axis, n_nodes, node_id, line, is_write, wdata,
        bucket_cap)
    _note_trace(("sharded_round", n_shards, n_nodes,
                 state["words"].shape[0], line.shape[0], cap,
                 "dirty" in state, wdata.shape[1], "home" in state,
                 "replica" in state))
    state, served, ver, data, _ = _route_round(
        state, node_id, line, is_write, wdata, n_shards=n_shards,
        n_nodes=n_nodes, cap=cap)
    return state, served, ver, data


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
    payload included."""
    n_shards, node_id, line, is_write, wdata, cap = _prepare(
        state, mesh, axis, n_nodes, node_id, line, is_write, wdata,
        bucket_cap)
    _note_trace(("sharded", n_shards, n_nodes, state["words"].shape[0],
                 line.shape[0], cap, max_rounds, "dirty" in state,
                 wdata.shape[1], "home" in state, "replica" in state))

    def step(stt, pending, tele):
        stt, served, ver, rdata, dtele = _route_round(
            stt, node_id, pending, is_write, wdata, n_shards=n_shards,
            n_nodes=n_nodes, cap=cap)
        return stt, served, ver, rdata, add_tele(tele, dtele)
    return _spin(state, line, wdata.shape[1], max_rounds=max_rounds,
                 step=step, tele=_zero_tele(n_shards,
                                            state["words"].shape[0],
                                            line.device))


def run_rmw_sharded(state, node_id, line, operands=(), *, modify, mesh,
                    axis: str = AXIS, n_nodes: int, max_rounds: int = 64,
                    bucket_cap: int | None = None):
    """Sharded mirror of :func:`driver.run_rmw`: the S-grant read phase,
    ``modify(data, line, *operands)`` on the gathered ``[R, W]`` bytes,
    then the S->X upgrade write phase, each through
    :func:`run_rounds_sharded`.  Same return contract (telemetry summed
    over both phases, the write phase's versions and bytes)."""
    node_id, line = _as_ops(state, node_id, line)
    _note_trace(("rmw_sharded", modify, shards_of(mesh, axis), n_nodes,
                 state["words"].shape[0], line.shape[0], bucket_cap,
                 "dirty" in state, st.payload_width(state),
                 "home" in state, "replica" in state))
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
    sharded telemetry dict."""
    co.check_node_capacity(n_nodes)
    n_shards = shards_of(mesh, axis)
    check_on_mesh(state, mesh)
    node_id, key, root = _as_ops(state, node_id, key, root)
    b = root.shape[0]
    r = _check_slots(b, n_shards, "B")
    cap = bucket_cap if bucket_cap is not None else r
    width = st.payload_width(state)
    if not width:
        raise ValueError("run_descent_sharded needs a payload-plane "
                         "state (the transition decodes node bytes)")
    _note_trace(("descent_sharded", transition, n_shards, n_nodes,
                 state["words"].shape[0], b, cap, max_steps,
                 "dirty" in state, width, path_cap, "home" in state,
                 "replica" in state))
    no_write = torch.zeros((b,), dtype=torch.int32, device=root.device)
    no_bytes = torch.zeros((b, width), dtype=torch.int32,
                           device=root.device)

    def step(stt, line, tele):
        stt, served, _, d, dtele = _route_round(
            stt, node_id, line, no_write, no_bytes, n_shards=n_shards,
            n_nodes=n_nodes, cap=cap)
        return stt, served, d, add_tele(tele, dtele)
    return _walk(state, key, root, transition=transition,
                 max_steps=max_steps, path_cap=path_cap, step=step,
                 tele=_zero_tele(n_shards, state["words"].shape[0],
                                 root.device))


# --------------------------------------------------------------- eviction

def evict_lines_sharded(state, node_id, line, *, mesh, axis: str = AXIS,
                        bucket_cap: int | None = None) -> dict:
    """Sharded :func:`engine.evict_lines`: eviction slots [R] route to
    their homes (the same buckets; an overflowed slot goes next pass,
    ``ceil(R/S / cap)`` passes in all) and apply to the slabs, releasing
    the holder's latch and flushing dirty exclusive copies first.  Then
    every evicted line's replica image is invalidated.  Consumes the
    state (in place) and returns the new state dict."""
    n_shards = shards_of(mesh, axis)
    check_on_mesh(state, mesh)
    node_id, line = _as_ops(state, node_id, line)
    r = _check_slots(line.shape[0], n_shards)
    cap = bucket_cap if bucket_cap is not None else r
    pending = line.clone()
    for _ in range(-(-r // cap)):
        home = _home_of(state, pending, n_shards)
        buckets, order, keep, _, _ = _bucket(
            {"node": node_id.reshape(n_shards, r),
             "line": pending.reshape(n_shards, r)},
            n_shards, cap, fields=("node", "line"),
            home=home.reshape(n_shards, r))
        recv = {k: exchange(v) for k, v in buckets.items()}
        loc = _local_index(state, recv["line"], n_shards)
        for h in range(n_shards):
            slab = _slab(state, h, n_shards)
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
    n_shards = shards_of(mesh, axis)
    check_on_mesh(state, mesh)
    src = np.asarray(_host(src_slot), np.int64).reshape(-1)
    dst = np.asarray(_host(dst_slot), np.int64).reshape(-1)
    use = src >= 0
    src, dst = src[use], dst[use]
    l_local = state["words"].shape[0] // n_shards
    dev = state["words"].device

    def rows(p):
        return torch.from_numpy((p % n_shards) * l_local + p // n_shards) \
            .to(dev)
    moved = tuple(sorted(k for k in state if k not in st.GLOBAL_LEAVES))
    _note_trace(("rehome", n_shards, state["words"].shape[0],
                 int(src.size), moved, "replica" in state))
    at_src, at_dst = rows(src), rows(dst)
    for k in moved:
        ax = st.LINE_AXIS[k]
        v = state[k]
        v.index_copy_(ax, at_dst, v.index_select(ax, at_src))
    out = dict(state)
    out["home"] = torch.as_tensor(_host(new_home)).to(
        device=dev, dtype=torch.int32)
    return out
