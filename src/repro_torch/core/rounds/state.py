"""Round state construction and invariant checking (flat plane).

Counterpart of ``repro/core/rounds/state.py``.  The state is a flat
dict of tensors on one device, with the reference's leaves, shapes and
dtypes:

    words          [L, 2] int32   latch word lanes (hi, lo) — Fig. 3
    cache_state    [N, L] int8    MSI state per (node, line)
    cache_version  [N, L] int32   version of the node's local copy
    mem_version    [L]    int32   version of the memory image
    dirty          [N, L] bool    (write-back only) copy newer than memory
    mem_data       [L, W] int32   (payload plane) memory image lanes
    cache_data     [N, L, W] i32  (payload plane) each node's local copy
    home           [L]    int32   (home directory) line -> physical slot
    replica        [L]    bool    (read replicas) line is read-mostly
    replica_ok     [L]    bool    replica image is a faithful snapshot
    replica_version[L]    int32   version of the replica image
    replica_data   [L, W] int32   (payload plane) replica payload lanes

Write-back, the payload plane, the home directory and the replica plane
are structural, as in the reference: a leaf's presence switches the
mode.  Unlike the reference, the engine updates leaves IN PLACE — at
the serving pool's defaults ``cache_data`` is 256 MiB, and copying it
every round is what a functional update would cost.  A caller that
needs an earlier state keeps a clone.

The stripe helpers (``LINE_AXIS``, ``GLOBAL_LEAVES``, ``stripe_state``
/ ``unstripe_state`` and the line-axis permutations under them) move a
state between the flat line-major layout and the sharded plane's
physical-slot layout, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import resolve_device
from .. import coherence as co


def make_state(n_nodes: int, n_lines: int, *, write_back: bool = False,
               payload_width: int = 0, home_directory: bool = False,
               replicas: bool = False, device=None) -> dict:
    """Fresh round state on ``device`` (``cuda`` unless the caller asks
    for ``"cpu"``).  Raises ``ValueError`` for node counts the latch
    word cannot encode and for a negative payload width."""
    co.check_node_capacity(n_nodes)
    if payload_width < 0:
        raise ValueError(f"payload_width={payload_width} must be >= 0")
    dev = resolve_device(device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = {
        "words": zeros((n_lines, 2), torch.int32),
        "cache_state": zeros((n_nodes, n_lines), torch.int8),
        "cache_version": zeros((n_nodes, n_lines), torch.int32),
        "mem_version": zeros((n_lines,), torch.int32),
    }
    if write_back:
        state["dirty"] = zeros((n_nodes, n_lines), torch.bool)
    if payload_width:
        state["mem_data"] = zeros((n_lines, payload_width), torch.int32)
        state["cache_data"] = zeros((n_nodes, n_lines, payload_width),
                                    torch.int32)
    if home_directory:
        state["home"] = torch.arange(n_lines, dtype=torch.int32,
                                     device=dev)
    if replicas:
        state["replica"] = zeros((n_lines,), torch.bool)
        state["replica_ok"] = zeros((n_lines,), torch.bool)
        state["replica_version"] = zeros((n_lines,), torch.int32)
        if payload_width:
            state["replica_data"] = zeros((n_lines, payload_width),
                                          torch.int32)
    return state


def is_write_back(state) -> bool:
    """Mode is structural: a state with a ``dirty`` leaf runs write-back."""
    return "dirty" in state


def payload_width(state) -> int:
    """Payload lanes per line; 0 = version-only state (no data plane)."""
    return int(state["mem_data"].shape[1]) if "mem_data" in state else 0


# ------------------------------------------------------------ stripe layout
# The sharded plane keeps every line-indexed leaf in PHYSICAL-SLOT
# layout: line l occupies slot p = home[l] (identity without a
# directory), living on shard p % S at local index p // S, so each shard
# owns one contiguous slab.  GLOBAL_LEAVES are indexed by global line id
# and replicated across the mesh — they never stripe.

LINE_AXIS = {"words": 0, "cache_state": 1, "cache_version": 1,
             "mem_version": 0, "dirty": 1, "mem_data": 0, "cache_data": 1}

GLOBAL_LEAVES = ("home", "replica", "replica_ok", "replica_version",
                 "replica_data")


def has_home_directory(state) -> bool:
    """Placement is structural: a ``home`` leaf switches the sharded
    router from the static stripe to directory lookups."""
    return "home" in state


def has_replicas(state) -> bool:
    return "replica" in state


def slot_positions(perm, n_shards: int):
    """Physical slot id -> row position in the shard-major (slab
    concatenation) order: slot ``p`` is row ``(p % S) * (L // S) +
    p // S``.  With the identity permutation this is exactly the
    :func:`stripe_lines` row mapping."""
    l = perm.shape[0]
    return (perm % n_shards) * (l // n_shards) + perm // n_shards


def stripe_lines(x: torch.Tensor, n_shards: int, axis: int = 0):
    """Permute the line axis from line-major to shard-major (stripe)
    order: row ``l`` moves to ``(l % n_shards) * (L // n_shards) + l //
    n_shards``.  Inverse of :func:`unstripe_lines`."""
    x = x.movedim(axis, 0)
    l, rest = x.shape[0], tuple(x.shape[1:])
    x = x.reshape((l // n_shards, n_shards) + rest) \
        .transpose(0, 1).reshape((l,) + rest)
    return x.movedim(0, axis)


def unstripe_lines(x: torch.Tensor, n_shards: int, axis: int = 0):
    x = x.movedim(axis, 0)
    l, rest = x.shape[0], tuple(x.shape[1:])
    x = x.reshape((n_shards, l // n_shards) + rest) \
        .transpose(0, 1).reshape((l,) + rest)
    return x.movedim(0, axis)


def stripe_state(state, n_shards: int) -> dict:
    """Flat (line-major) round state -> physical-slot-layout state.  All
    line-indexed leaves permute consistently (through the ``home``
    directory when present, the plain stripe otherwise), so
    :func:`check_invariants` works on either layout; GLOBAL_LEAVES pass
    through untouched."""
    perm = state.get("home")
    if perm is not None:
        pos = slot_positions(perm.long(), n_shards)
        inv = torch.empty_like(pos)
        inv[pos] = torch.arange(pos.shape[0], device=pos.device)
    out = {}
    for k, v in state.items():
        if k in GLOBAL_LEAVES:
            out[k] = v
        elif perm is None:
            out[k] = stripe_lines(v, n_shards, LINE_AXIS[k])
        else:
            out[k] = v.index_select(LINE_AXIS[k], inv)
    return out


def unstripe_state(state, n_shards: int) -> dict:
    """Inverse of :func:`stripe_state`."""
    perm = state.get("home")
    if perm is not None:
        pos = slot_positions(perm.long(), n_shards)
    out = {}
    for k, v in state.items():
        if k in GLOBAL_LEAVES:
            out[k] = v
        elif perm is None:
            out[k] = unstripe_lines(v, n_shards, LINE_AXIS[k])
        else:
            out[k] = v.index_select(LINE_AXIS[k], pos)
    return out


def check_invariants(state) -> None:
    """Coherence invariants on a state (tests and ``DevicePlane.check``);
    copies the leaves to the host."""
    host = {k: v.cpu().numpy() for k, v in state.items()}
    cs = host["cache_state"]
    cv = host["cache_version"]
    mv = host["mem_version"]
    n_m = (cs == co.M).sum(axis=0)
    assert (n_m <= 1).all(), "two exclusive holders on one line"
    sh = cs == co.S
    excl = (cs == co.M).any(axis=0)
    assert not np.logical_and(sh.any(axis=0), excl).any(), \
        "shared copy coexists with an exclusive holder"
    stale = np.logical_and(sh, cv != mv[None, :])
    assert not stale.any(), "stale shared copy (coherence violation)"
    # the word must BE the directory: rebuildable from the cache states
    expect = co.directory_from_state(state["cache_state"]).cpu().numpy()
    assert (host["words"] == expect).all(), \
        "latch word diverged from cache states"
    if "dirty" in host:
        dirty = host["dirty"]
        assert not np.logical_and(dirty, cs != co.M).any(), \
            "dirty copy without the exclusive latch"
        behind = np.logical_and(cs == co.M, cv < mv[None, :])
        assert not behind.any(), "exclusive holder older than memory"
    else:
        m_stale = np.logical_and(cs == co.M, cv != mv[None, :])
        assert not m_stale.any(), \
            "write-through holder diverged from memory"
    if "mem_data" in host:
        md = host["mem_data"]                        # [L, W]
        cd = host["cache_data"]                      # [N, L, W]
        differs = (cd != md[None, :, :]).any(axis=2)
        assert not np.logical_and(sh, differs).any(), \
            "shared copy's payload diverged from memory"
        if "dirty" in host:
            clean_m = np.logical_and(cs == co.M, ~host["dirty"])
            assert not np.logical_and(clean_m, differs).any(), \
                "clean exclusive copy's payload diverged from memory"
        else:
            assert not np.logical_and(cs == co.M, differs).any(), \
                "write-through holder's payload diverged from memory"
    if "home" in host:
        hm = host["home"]
        assert hm.shape == mv.shape, "home directory shape mismatch"
        assert (np.sort(hm) == np.arange(hm.shape[0])).all(), \
            "home directory is not a permutation of the physical slots"
    if "replica" in host:
        rep, rok = host["replica"], host["replica_ok"]
        rv = host["replica_version"]
        assert not np.logical_and(rok, ~rep).any(), \
            "replica image valid on an unreplicated line"
        assert not np.logical_and(rok, excl).any(), \
            "replica image valid under an exclusive holder"
        assert (rv[rok] == mv[rok]).all(), \
            "replica version diverged from memory"
        if "replica_data" in host:
            assert (host["replica_data"][rok]
                    == host["mem_data"][rok]).all(), \
                "replica payload diverged from memory"
