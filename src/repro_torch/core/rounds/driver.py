"""The spin loop: run ops to completion, round after round.

Counterpart of ``repro/core/rounds/driver.py``.  The reference fuses
the loop into one ``jax.lax.while_loop`` with no host sync inside; this
first cut loops on the host and reads ``pending.any()`` once per round.
``max_rounds`` and ``all_served`` keep their meaning, and versions,
payloads, round counts and telemetry come out identical.  Like the
engine, the drivers consume the state they are given (its leaves are
updated in place).
"""

from __future__ import annotations

import torch

from .engine import _note_trace, coherence_round
from .state import payload_width


def zero_flat_tele(n_lines: int, device=None) -> dict:
    """Zeroed flat telemetry accumulator: the sharded drivers' counter
    keys shaped for one home (``occupancy`` / ``deferred`` [1, 1],
    ``served_per_home`` / ``replica_served`` [1], per-line
    ``slot_hits`` / ``slot_whits`` [L])."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return {"occupancy": z(1, 1), "deferred": z(1, 1),
            "served_per_home": z(1), "replica_served": z(1),
            "slot_hits": z(n_lines), "slot_whits": z(n_lines)}


def add_tele(a: dict, b: dict) -> dict:
    """Key-wise telemetry-dict sum (accumulation across phases/spins)."""
    return {k: a[k] + b[k] for k in a}


def _tele_round(tele: dict, pending, served, is_write) -> dict:
    """Fold one round's serve results into a flat telemetry carry:
    ``pending`` is the PRE-round line per slot (-1 = done/pad)."""
    valid = pending >= 0
    hit = served & valid
    line = pending.long().clamp(min=0)
    whit = hit & is_write.bool()
    return {"occupancy": tele["occupancy"] + valid.sum(dtype=torch.int32),
            "deferred": tele["deferred"],
            "served_per_home": tele["served_per_home"]
            + hit.sum(dtype=torch.int32),
            "replica_served": tele["replica_served"],
            "slot_hits": tele["slot_hits"].index_add(
                0, line, hit.to(torch.int32)),
            "slot_whits": tele["slot_whits"].index_add(
                0, line, whit.to(torch.int32))}


def _as_ops(state, *arrays):
    dev = state["words"].device
    return [torch.as_tensor(a).to(device=dev, dtype=torch.int32)
            for a in arrays]


def run_rounds(state, node_id, line, is_write, wdata=None, *,
               n_nodes: int, max_rounds: int = 64):
    """Drive op slots (node_id, line, is_write) [R] to completion.

    ``wdata`` [R, W] carries per-op write payloads on a payload-plane
    state (``None`` = zeros).  Returns ``(state', versions[R],
    data[R, W], rounds_used, all_served, telemetry)``: tensors on the
    state's device, except ``rounds_used`` (int) and ``all_served``
    (bool), which the host loop already knows.  ``all_served`` is False
    if ``max_rounds`` rounds ran with ops still pending."""
    node_id, line, is_write = _as_ops(state, node_id, line, is_write)
    width = payload_width(state)
    n_lines = state["words"].shape[0]
    r = line.shape[0]
    dev = line.device
    if wdata is None:
        wdata = torch.zeros((r, width), dtype=torch.int32, device=dev)
    else:
        wdata = torch.as_tensor(wdata).to(device=dev, dtype=torch.int32)
    _note_trace(("driver", n_nodes, r, max_rounds, "dirty" in state,
                 width))
    pending = line.clone()
    versions = torch.zeros_like(line)
    data = torch.zeros((r, width), dtype=torch.int32, device=dev)
    tele = zero_flat_tele(n_lines, dev)
    rounds = 0
    while True:
        all_served = not bool((pending >= 0).any())
        if all_served or rounds >= max_rounds:
            break
        state, served, ver, rdata = coherence_round(
            state, node_id, pending, is_write, wdata, n_nodes=n_nodes)
        tele = _tele_round(tele, pending, served, is_write)
        versions = torch.where(served, ver, versions)
        data = torch.where(served[:, None], rdata, data)
        pending = torch.where(served, -1, pending)
        rounds += 1
    return state, versions, data, rounds, all_served, tele


def run_rmw(state, node_id, line, operands=(), *, modify, n_nodes: int,
            max_rounds: int = 64):
    """Coherent read-modify-write: a read phase, ``modify(data, line,
    *operands)`` on the device, then a write phase carrying the new
    bytes (the S->X upgrade path).  The contract is the reference's
    (``repro/core/rounds/driver.py:run_rmw``): atomic per call, slots of
    different nodes must not share a line, and duplicate (node, line)
    slots carry group-total bytes.

    Returns ``(state', versions[R], data[R, W], rounds_used, all_served,
    telemetry)`` — the write phase's replies, both phases' rounds and
    telemetry summed."""
    node_id, line = _as_ops(state, node_id, line)
    _note_trace(("rmw", modify, n_nodes, line.shape[0], max_rounds,
                 "dirty" in state, payload_width(state)))
    state, _, data, r1, ok1, t1 = run_rounds(
        state, node_id, line, torch.zeros_like(line), None,
        n_nodes=n_nodes, max_rounds=max_rounds)
    new_data = modify(data, line, *operands).to(torch.int32)
    state, versions, data2, r2, ok2, t2 = run_rounds(
        state, node_id, line, torch.ones_like(line), new_data,
        n_nodes=n_nodes, max_rounds=max_rounds)
    return (state, versions, data2, r1 + r2, ok1 and ok2,
            add_tele(t1, t2))
