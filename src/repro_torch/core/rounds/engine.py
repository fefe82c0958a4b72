"""One bulk-synchronous coherence round — the full SELCC state machine.

Counterpart of ``repro/core/rounds/engine.py``; its module docstring
describes the protocol, which is the same here step for step:
coalescing per (node, line), lazy-latch hits, CAS/FAA latch requests
through the ``latch_ops`` kernel, S->X upgrades, fetch-on-grant through
the ``gcl_fetch`` kernel, write-apply, dirty flush with bytes,
round-boundary invalidations, the word rebuilt from the cache states,
and the replica refresh.

What differs from the reference:

* the state's leaves are updated IN PLACE, and the returned dict shares
  them: the input state is consumed (clone it first to keep it);
* the reference's ``.at[...].set(mode="drop")`` scatters have no torch
  counterpart.  Padding the state to give dropped writes a row would
  copy ``cache_data`` every round, so :func:`_masked_put` instead points
  each unselected slot at a selected slot's target with that slot's
  value — duplicate indices then always carry equal values, whatever
  order ``index_put_`` lands them in;
* ``TRACE_COUNTS`` counts round executions per shape key: eager
  PyTorch compiles nothing, so the reference's trace count has no
  counterpart, and the dispatch count takes its place.
"""

from __future__ import annotations

import torch

from .. import coherence as co
from ...kernels.gcl_fetch import fetch as gcl_fetch_op
from ...kernels.latch_ops import OP_CAS, OP_FAA, apply_batch

I, S, M = co.I, co.S, co.M

TRACE_COUNTS: dict = {}


def _note_trace(key) -> None:
    TRACE_COUNTS[key] = TRACE_COUNTS.get(key, 0) + 1


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where none is)."""
    return mask.to(torch.int8).argmax(dim=dim)


def _masked_put(dst: torch.Tensor, index: tuple, values: torch.Tensor,
                mask: torch.Tensor) -> None:
    """``dst[index[i]] = values[i]`` for the slots with ``mask[i]``, in
    place and without a host sync.  Masked slots that share an index
    must carry equal values.  Unmasked slots rewrite the first masked
    slot's target with its value (or, when none is masked, their own
    target with its current value), so no index is ever written with
    two different values."""
    r = mask.shape[0]
    first = _first_true(mask, 0)
    redirect = ~mask & mask[first]
    src = torch.where(redirect, first,
                      torch.arange(r, device=mask.device))
    index = tuple(torch.where(redirect, i[first], i) for i in index)
    keep = (mask | redirect).view(-1, *([1] * (values.dim() - 1)))
    dst.index_put_(index, torch.where(keep, values[src], dst[index]))


def _round_impl(state, node_id, line, is_write, wdata=None, *,
                n_nodes: int):
    """One round of R op slots; see :func:`coherence_round`."""
    co.check_node_capacity(n_nodes)
    write_back = "dirty" in state
    cstate = state["cache_state"]
    cver = state["cache_version"]
    mver = state["mem_version"]
    dirty = state.get("dirty")
    mdata = state.get("mem_data")
    cdata = state.get("cache_data")
    width = mdata.shape[1] if mdata is not None else 0
    n_lines = state["words"].shape[0]
    r = line.shape[0]
    dev = line.device
    if wdata is None:
        wdata = torch.zeros((r, width), dtype=torch.int32, device=dev)
    _note_trace(("round", n_nodes, n_lines, r, write_back, width))

    node_id = node_id.long()
    valid = line >= 0
    idx = line.long().clamp(min=0)
    is_w = is_write.bool() & valid
    arange_r = torch.arange(r, device=dev)

    # ------------- 0. coalesce duplicate (node, line) slots ---------------
    key = node_id * n_lines + idx
    eq = (key[:, None] == key[None, :]) & valid[:, None] & valid[None, :]
    first = _first_true(eq, 1)                     # my group's first slot
    is_rep = valid & (first == arange_r)
    in_grp_w = eq & is_w[None, :]
    grp_write = in_grp_w.any(dim=1)
    lower = torch.ones((r, r), dtype=torch.bool, device=dev).tril(-1)
    w_rank = (in_grp_w & lower).sum(dim=1)         # writes before me
    n_w_grp = in_grp_w.sum(dim=1)
    # last write slot of my group: slot order IS the serialization
    # order, so its wdata is the group's final payload
    last_w = torch.where(in_grp_w, arange_r, -1).max(dim=1).values \
        .clamp(min=0)

    # ------------- 1. local hits (lazy latches) ---------------------------
    st = cstate[node_id, idx]
    hit_read = ~grp_write & (st >= S)
    hit_write = grp_write & (st == M)
    hit = is_rep & (hit_read | hit_write)

    # ------------- 2. latch requests for misses ---------------------------
    miss = is_rep & ~hit
    upgrade = miss & grp_write & (st == S)
    fresh_w = miss & grp_write & (st != S)
    read_miss = miss & ~grp_write
    bit_hi, bit_lo = co.bit_lanes(node_id)
    wf = co.writer_field_hi(node_id)
    zero = torch.zeros_like(bit_hi)
    req = {
        "line": torch.where(miss, line, -1).to(torch.int32),
        "op": torch.where(grp_write, OP_CAS, OP_FAA).to(torch.int32),
        "arg_hi": torch.where(grp_write, wf, bit_hi),
        "arg_lo": torch.where(grp_write, zero, bit_lo),
        # S->X upgrade compares against the holder's own bit; a fresh
        # write compares against FREE (zeros)
        "cmp_hi": torch.where(upgrade, bit_hi, zero),
        "cmp_lo": torch.where(upgrade, bit_lo, zero),
    }
    _, old_hi, _, ok = apply_batch(state["words"], req)
    ok = ok.bool()
    no_writer = co.writer_of_hi(old_hi) < 0
    read_grant = read_miss & no_writer
    write_grant = (upgrade | fresh_w) & ok
    granted = read_grant | write_grant
    served_rep = hit | granted

    # ------------- grants + versions --------------------------------------
    # start version of the serialized group: the node's own copy on a
    # hit (may run ahead of memory under write-back), memory otherwise
    cur_ver = cver[node_id, idx]
    start = torch.where(hit, cur_ver, mver[idx])
    k = torch.where(served_rep & grp_write, n_w_grp, 0)
    final = (start + k).to(torch.int32)
    # only group representatives are granted or served, and they have
    # distinct (node, line) pairs
    _masked_put(cstate, (node_id, idx),
                torch.where(read_grant, S, M).to(torch.int8), granted)
    _masked_put(cver, (node_id, idx), final, served_rep)
    wrote = served_rep & grp_write
    if write_back:
        _masked_put(dirty, (node_id, idx),
                    torch.ones_like(wrote), wrote)
    else:
        mver.index_add_(0, idx, k.to(torch.int32))

    # ------------- payload plane: fetch-on-grant + write-apply ------------
    gdata = None
    if width:
        # fetch-on-grant through the gcl_fetch kernel (zero reader bits:
        # the latch kernel already registered them).  Rows it leaves at
        # zero are neither served nor written below.
        fetch_req = torch.where(granted, line, -1).to(torch.int32)
        no_bits = torch.zeros_like(fetch_req)
        fetched = gcl_fetch_op(mdata, state["words"], fetch_req, no_bits,
                               no_bits)[0]
        base = torch.where(hit[:, None], cdata[node_id, idx], fetched)
        gdata = torch.where(grp_write[:, None], wdata[last_w], base)
        _masked_put(cdata, (node_id, idx), gdata, served_rep)
        if not write_back:
            # one granted write per line and round: the CAS admits one
            _masked_put(mdata, (idx,), gdata, wrote)

    # ------------- 3/4. round-boundary invalidations ----------------------
    fail_w = (upgrade | fresh_w) & ~ok
    fail_r = read_miss & ~no_writer
    wr_cnt = torch.zeros(n_lines, dtype=torch.int32, device=dev) \
        .index_add_(0, idx, fail_w.to(torch.int32))
    rd_fail = torch.zeros(n_lines, dtype=torch.int32, device=dev) \
        .index_add_(0, idx, fail_r.to(torch.int32)) > 0
    self_wr_fail = torch.zeros(n_nodes * n_lines, dtype=torch.int32,
                               device=dev).index_add_(
        0, node_id * n_lines + idx, fail_w.to(torch.int32)) \
        .clamp(max=1).view(n_nodes, n_lines)
    # PeerWr/PeerUpgr from any OTHER node kills a holder (upgraders never
    # kill themselves; two racing upgraders kill each other and fall back
    # to fresh acquisition — Algorithm 2's release+reacquire)
    other_fail = (wr_cnt[None, :] - self_wr_fail) > 0
    kill = other_fail & (cstate >= S)
    # PeerRd with no competing writer: the M holder downgrades
    m_mask = cstate == M
    dg_line = rd_fail & (wr_cnt == 0) & m_mask.any(dim=0)
    dg_mask = dg_line[None, :] & m_mask
    if write_back:
        # a dirty M holder leaving M (killed or downgraded) writes back
        flush = (kill | dg_mask) & m_mask & dirty
        any_flush = flush.any(dim=0)
        flush_ver = torch.where(flush, cver, 0).max(dim=0).values
        mver.copy_(torch.where(any_flush, flush_ver, mver))
        if width:
            # dirty-flush-with-bytes: at most one M holder per line, so
            # the flushing node's row is the line's only candidate
            holder = _first_true(flush, 0)
            lines = torch.arange(n_lines, device=dev)
            mdata.copy_(torch.where(any_flush[:, None],
                                    cdata[holder, lines], mdata))
        dirty &= ~(kill | dg_mask)
    cstate.masked_fill_(kill, I)
    cstate.masked_fill_(dg_mask, S)
    # the word IS the directory: rebuild it from the post-boundary states
    words = co.directory_from_state(cstate)

    # ------------- per-slot replies (coalesced groups fan back out) -------
    served = valid & served_rep[first]
    slot_start = start[first]
    version = torch.where(
        served,
        torch.where(is_w, slot_start + w_rank + 1, slot_start + n_w_grp),
        0).to(torch.int32)
    if width:
        # every served slot replies with its group's FINAL payload
        data = torch.where(served[:, None], gdata[first], 0)
    else:
        data = torch.zeros((r, 0), dtype=torch.int32, device=dev)
    new_state = dict(state)
    new_state["words"] = words
    if "replica" in state and state["replica"].shape[0] == n_lines:
        # refresh the read-replica image at the round boundary: a line
        # with no exclusive holder has a current memory image
        rok = state["replica"] & ~(cstate == M).any(dim=0)
        new_state["replica_ok"] = rok
        new_state["replica_version"] = torch.where(
            rok, mver, state["replica_version"])
        if "replica_data" in state:
            new_state["replica_data"] = torch.where(
                rok[:, None], mdata, state["replica_data"])
    return new_state, served, version, data


def coherence_round(state, node_id, line, is_write, wdata=None, *,
                    n_nodes: int):
    """One round of R op slots (node_id, line, is_write) int32 [R] on
    the state's device; line = -1 marks an empty slot.  ``wdata`` [R, W]
    carries write payloads on a payload-plane state (None = zeros).
    Returns (state', served[R], version[R], data[R, W]).

    The input state is consumed: its leaves are updated in place and
    shared with ``state'``.  Duplicate (node, line) slots coalesce;
    duplicate lines across nodes contend through the latch kernel."""
    return _round_impl(state, node_id, line, is_write, wdata,
                       n_nodes=n_nodes)


def _evict_impl(state, node_id, line):
    """Eviction body (in place; the returned dict shares the leaves)."""
    cstate = state["cache_state"]
    n_nodes, n_lines = cstate.shape
    node_id = node_id.long()
    valid = line >= 0
    idx = line.long().clamp(min=0)
    new_state = dict(state)
    if "dirty" in state:
        dirty = state["dirty"]
        flush = valid & (cstate[node_id, idx] == M) & dirty[node_id, idx]
        cur = state["cache_version"][node_id, idx]
        state["mem_version"].scatter_reduce_(
            0, idx, torch.where(flush, cur, torch.iinfo(torch.int32).min),
            reduce="amax")
        if "mem_data" in state:
            # eviction write-back carries the bytes, not just the version
            _masked_put(state["mem_data"], (idx,),
                        state["cache_data"][node_id, idx], flush)
        _masked_put(dirty, (node_id, idx), torch.zeros_like(valid), valid)
    _masked_put(cstate, (node_id, idx),
                torch.full_like(valid, I, dtype=torch.int8), valid)
    new_state["words"] = co.directory_from_state(cstate)
    return new_state


def evict_lines(state, node_id, line):
    """Evict (node, line) slots: release the holder's latch and, in
    write-back mode, flush a dirty exclusive copy to memory first.
    line = -1 skips a slot.  Consumes ``state`` (in place) and returns
    the new state dict."""
    new_state = _evict_impl(state, node_id, line)
    if "replica" in state:
        # an eviction flush can advance memory past the replica image:
        # conservatively invalidate; the next round republishes it
        ok = new_state["replica_ok"]
        idx = line.long().clamp(min=0)
        _masked_put(ok, (idx,), torch.zeros_like(ok[idx]), line >= 0)
    return new_state
