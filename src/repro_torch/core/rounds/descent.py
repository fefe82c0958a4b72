"""Batched index descent: every key's root-to-leaf walk, as a wavefront.

Counterpart of ``repro/core/rounds/descent.py``.  Each step presents
the S-latch reads of every undone key's current line, runs ONE
coherence round (``engine._round_impl``: grants, payload fetch,
boundary invalidations), decodes the returned node lanes with the
caller's ``transition`` (for the B-link tree ``index.codec.descend_step``
— child index, right-link hop, at-leaf), advances each served key, and
re-presents keys whose read lost a latch race.  Keys at different
depths advance independently.  The reference fuses the loop into one
``lax.while_loop``; here the loop runs on the host and reads one flag a
step (``any(~done)``), as ``driver.run_rounds`` does, under the same
layer span ``plane.spin_sync`` and counter ``plane.host_reads``.  Every
carry stays on the state's device.

The ``transition`` contract::

    at_leaf[B], hop[B], nxt[B] = transition(data[B, W], key[B])

* ``at_leaf`` — the slot rests on its target node: record the lanes,
  stop presenting ops;
* ``hop`` — the slot re-presents at ``nxt`` WITHOUT counting a level
  (a B-link right-link hop; counted separately);
* otherwise the slot descends to ``nxt`` (one level).

The per-slot path buffer ``paths [B, path_cap]`` records the lines a
slot DESCENDED through (hops and the final leaf excluded); a slot
deeper than ``path_cap`` overwrites its last entry.
"""

from __future__ import annotations

import torch

from ...obs import count, span
from .driver import _as_ops, _tele_round, zero_flat_tele
from .engine import _round_impl
from .state import payload_width


def run_descent(state, node_id, key, root, *, transition, n_nodes: int,
                max_steps: int = 64, path_cap: int = 16):
    """Drive descent slots (node_id, key, start line) int32 [B] to their
    leaves.  ``root[i] = -1`` marks an inactive pad slot.  Requires a
    payload-plane state (the transition decodes real node bytes).  The
    state is consumed (its leaves are updated in place).

    Returns ``(state', line[B], lanes[B, W], levels[B], hops[B],
    paths[B, path_cap], path_len[B], steps_used, all_done,
    telemetry)``: tensors on the state's device, except ``steps_used``
    (int) and ``all_done`` (bool), which the host loop already knows —
    each slot's final line and its node lanes, how many levels it
    descended and right links it hopped, the internal lines it descended
    through, and whether every slot settled within ``max_steps`` steps
    (each costs one coherence round); ``telemetry`` is the flat counter
    dict (``driver.zero_flat_tele`` keys; descents are pure reads, so
    ``slot_whits`` stays zero)."""
    node_id, key, root = _as_ops(state, node_id, key, root)
    b = root.shape[0]
    no_write = torch.zeros((b,), dtype=torch.int32, device=root.device)

    def step(st, line, tele):
        st, served, _, d = _round_impl(st, node_id, line, no_write,
                                       n_nodes=n_nodes)
        return st, served, d, _tele_round(tele, line, served, no_write)
    return _walk(state, key, root, transition=transition,
                 max_steps=max_steps, path_cap=path_cap, step=step,
                 tele=zero_flat_tele(state["words"].shape[0], root.device))


def _walk(state, key, root, *, transition, max_steps: int, path_cap: int,
          step, tele, n_left=None):
    """The wavefront over any plane: ``step(state, line, tele) ->
    (state', served, data, tele')`` runs one round of S-latch reads
    (``line = -1`` for settled slots).  ``n_left(flags)`` counts the
    undone slots of every rank (the reference's psum), where the slots
    are one rank's block.  Returns the drivers' tuple."""
    b = root.shape[0]
    width = payload_width(state)
    dev = root.device
    rows = torch.arange(b, device=dev)
    cur = root.clone()
    done = root < 0
    lanes = torch.zeros((b, width), dtype=torch.int32, device=dev)
    levels = torch.zeros((b,), dtype=torch.int32, device=dev)
    hops = torch.zeros((b,), dtype=torch.int32, device=dev)
    paths = torch.full((b, path_cap), -1, dtype=torch.int32, device=dev)
    plen = torch.zeros((b,), dtype=torch.int32, device=dev)
    steps = 0
    while True:
        with span("plane.spin_sync"):        # the step's one host sync
            count("plane.host_reads")
            all_done = (not bool((~done).any()) if n_left is None
                        else n_left(~done) == 0)
        if all_done or steps >= max_steps:
            break
        line = torch.where(done, -1, cur)
        state, served, d, tele = step(state, line, tele)
        at_leaf, hop, nxt = transition(d, key)
        move = served & ~done
        hop = move & hop
        at_leaf = move & at_leaf
        desc = move & ~hop & ~at_leaf
        lanes = torch.where(at_leaf[:, None], d, lanes)
        # path buffer: record the line a slot descends FROM, in the
        # descending rows only
        col = plen.long().clamp(max=path_cap - 1)
        paths[rows, col] = torch.where(desc, cur, paths[rows, col])
        plen = plen + desc.to(torch.int32)
        levels = levels + desc.to(torch.int32)
        hops = hops + hop.to(torch.int32)
        done = done | at_leaf
        cur = torch.where(move & ~at_leaf, nxt, cur)
        steps += 1
    return (state, cur, lanes, levels, hops, paths, plen, steps, all_done,
            tele)
