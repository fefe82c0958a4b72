"""Transaction concurrency control over the flat device plane.

Counterpart of ``repro/core/rounds/txn.py``, whose module docstring
describes the scheduler; it is the same here step for
step.  Each GCL packs a latch word plus ``T`` tuple headers into its
payload lanes (``W = 2 + 2*T``)::

    lane 0           lock word: 0 = free, else holder's slot index + 1
    lane 1           committed-writes counter (the 2PL workload effect)
    lane 2+2t, 3+2t  tuple t's (read_ts, write_ts) header   (TO)

A batch is ``node [B]``, ``glines [B, G]`` (each txn's lines sorted
ascending, ``-1`` pads at the END — validated host-side), ``rmask /
wmask [B, G, T]`` and ``ts [B]``.  Each scheduler iteration: DEDUP
(duplicate wanted lines keep only the lowest slot), a READ spin (lock
word 0 = acquired, no-wait otherwise), an ACQUIRE spin (publish the
lock word; the read lanes are carried), APPLY for txns holding their
last line (2PL: bump each write-line's counter; TO: the host engine's
per-GCL, per-tuple timestamp checks, partial-update leak on abort
included), and a FINALIZE spin (completers publish all lines with the
lock released, no-wait losers release their held prefix).

The reference runs the whole batch in one ``lax.while_loop``; here the
scheduler loop and each spin's round loop run on the host, with one
sync a round (``run_rounds``) and one an iteration, and every carry on
the state's device.  Decisions, completion order, retries, rounds,
telemetry and the state come out identical.  The sharded driver
(:func:`run_txn_rounds_sharded`) runs the same loop with every spin
through the sharded plane.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...obs import PlaneTelemetry
from .. import coherence as co
from .driver import _as_ops, add_tele, run_rounds, zero_flat_tele
from .state import payload_width

LOCK_LANE = 0
WRITES_LANE = 1
HDR_LANES = 2


def txn_payload_width(tuples_per_line: int) -> int:
    """Payload lanes a txn GCL needs: lock + writes + (rts, wts) per
    tuple."""
    return HDR_LANES + 2 * tuples_per_line


# ------------------------------------------------------ algorithm bodies

def _apply_2pl(lanes, glines, rmask, wmask, ts):
    """2PL no-wait commit effect: all locks are already held (the loop
    IS the growing phase), so commit is unconditional; the workload
    effect is one counter bump per write-line."""
    has_write = wmask.bool().any(dim=2) & (glines >= 0)
    new = lanes.clone()
    new[:, :, WRITES_LANE] += has_write.to(torch.int32)
    return torch.ones(lanes.shape[0], dtype=torch.bool,
                      device=lanes.device), new


def _apply_to(lanes, glines, rmask, wmask, ts):
    """Timestamp ordering, replicating the host engine's sequential
    per-GCL, per-sorted-tuple semantics EXACTLY — including the
    partial-update leak: tuples checked before the failing one keep
    their header updates.  Unrolled over G x T, as the reference is."""
    b, g_n, w_n = lanes.shape
    t_n = (w_n - HDR_LANES) // 2
    stopped = torch.zeros(b, dtype=torch.bool, device=lanes.device)
    new = lanes.clone()
    for g in range(g_n):
        valid = glines[:, g] >= 0
        for t in range(t_n):
            r = rmask[:, g, t].bool() & valid
            w = wmask[:, g, t].bool() & valid
            active = (r | w) & ~stopped
            rts = new[:, g, HDR_LANES + 2 * t].clone()
            wts = new[:, g, HDR_LANES + 2 * t + 1].clone()
            # the write branch wins for read+write tuples (host: `t in
            # wset` is checked first)
            wfail = w & ((ts < rts) | (ts < wts))
            rfail = ~w & r & (ts < wts)
            ok_w = active & w & ~wfail
            ok_r = active & ~w & r & ~rfail
            new[:, g, HDR_LANES + 2 * t] = torch.where(
                ok_r, torch.maximum(rts, ts), rts)
            new[:, g, HDR_LANES + 2 * t + 1] = torch.where(ok_w, ts, wts)
            stopped = stopped | (active & (wfail | rfail))
    return ~stopped, new


_APPLY = {"2pl": _apply_2pl, "to": _apply_to}


# ------------------------------------------------------- the drivers

def run_txn_rounds(state, node_id, glines, rmask, wmask, ts, *,
                   algo: str, n_nodes: int, max_rounds: int = 64,
                   max_iters: int = 64):
    """Run a whole transaction batch to completion.  Consumes ``state``
    (its leaves are updated in place).

    Returns ``(state', decision[B], exec_step[B], retries[B], iters,
    all_done, spins_ok, rounds, telemetry)``: ``decision`` commit (True)
    / abort (False), ``exec_step`` the iteration a txn completed at (its
    place in the serial order), ``retries`` its no-wait restarts —
    tensors on the state's device — and the host ints / bools ``iters``,
    ``all_done``, ``spins_ok`` (False: a spin hit ``max_rounds``, the
    results are invalid) and ``rounds`` (over all spins); ``telemetry``
    is the flat counter dict summed over every spin of the batch."""
    co.check_node_capacity(n_nodes)

    def spin(stt, nodes, lines, is_write, wdata):
        stt, _, data, r, ok, tl = run_rounds(
            stt, nodes, lines, is_write, wdata, n_nodes=n_nodes,
            max_rounds=max_rounds)
        return stt, data, r, ok, tl

    args = _as_ops(state, node_id, glines, rmask, wmask, ts)
    return _txn_loop(state, *args, algo=algo, max_iters=max_iters,
                     spin=spin,
                     tele=zero_flat_tele(state["words"].shape[0],
                                         args[1].device))


def run_txn_rounds_sharded(state, node_id, glines, rmask, wmask, ts, *,
                           algo: str, mesh, axis: str = "shards",
                           n_nodes: int, max_rounds: int = 64,
                           max_iters: int = 64,
                           bucket_cap: int | None = None):
    """Mesh mirror of :func:`run_txn_rounds`: the same scheduler, with
    txn slots block-distributed over the shards (B divisible by the
    shard count; pad with ``glines = -1`` rows) and every spin through
    :func:`~repro_torch.core.rounds.sharded.run_rounds_sharded` (each
    shard's bucket holds its own slot count unless ``bucket_cap`` says
    otherwise).  The reference gathers the wanted lines of every shard
    for the dedup; on one device they are the batch's own, in global
    slot order, so decisions equal the flat plane's.  Returns the flat
    contract with the sharded telemetry dict."""
    from .mesh import check_on_mesh, shards_of
    from .sharded import (_check_slots, _zero_tele, lines_of,
                          run_rounds_sharded)
    co.check_node_capacity(n_nodes)
    n_shards = shards_of(mesh, axis)
    check_on_mesh(state, mesh)

    def spin(stt, nodes, lines, is_write, wdata):
        stt, _, data, r, ok, tl = run_rounds_sharded(
            stt, nodes, lines, is_write, wdata, mesh=mesh, axis=axis,
            n_nodes=n_nodes, max_rounds=max_rounds, bucket_cap=bucket_cap)
        return stt, data, r, ok, tl

    args = _as_ops(state, node_id, glines, rmask, wmask, ts)
    b = args[1].shape[0]
    _check_slots(b, n_shards, "B")
    return _txn_loop(state, *args, algo=algo, max_iters=max_iters,
                     spin=spin,
                     tele=_zero_tele(n_shards, lines_of(state, mesh, axis),
                                     args[1].device))


def _txn_loop(state, node_id, glines, rmask, wmask, ts, *, algo: str,
              max_iters: int, spin, tele):
    """The scheduler over any plane: ``spin(state, nodes, lines,
    is_write, wdata) -> (state', data, rounds, ok, telemetry)`` drives
    one batch of ops to completion, ``tele`` is the zeroed telemetry
    accumulator."""
    b, g_n = glines.shape
    w_n = payload_width(state)
    dev = glines.device
    apply_fn = _APPLY[algo]
    nv = (glines >= 0).sum(dim=1, dtype=torch.int32)
    slot = torch.arange(b, dtype=torch.int32, device=dev)
    node_rep = node_id.repeat_interleave(g_n)
    g_idx = torch.arange(g_n, dtype=torch.int32, device=dev)[None, :]
    earlier = slot[None, :] < slot[:, None]

    k = torch.zeros(b, dtype=torch.int32, device=dev)
    done = nv < 0
    dec = torch.zeros(b, dtype=torch.bool, device=dev)
    estep = torch.zeros(b, dtype=torch.int32, device=dev)
    retr = torch.zeros(b, dtype=torch.int32, device=dev)
    lanes = torch.zeros((b, g_n, w_n), dtype=torch.int32, device=dev)
    it, ok, rounds = 0, True, 0
    while not bool(done.all()) and it < max_iters and ok:
        live = ~done
        kc = k.clamp(max=g_n - 1)
        has_next = live & (k < nv)
        want = torch.where(
            has_next, torch.gather(glines, 1, kc[:, None].long())[:, 0],
            -1)
        # dedup wanted lines: lowest slot presents, the rest retry
        eq = (want[:, None] == want[None, :]) & (want[None, :] >= 0)
        loser = (eq & earlier).any(dim=1)
        winner = has_next & ~loser
        # READ spin: lock word == 0 at read time means acquired
        lines_r = torch.where(winner, want, -1)
        state, rdata, r1, ok1, t1 = spin(state, node_id, lines_r,
                                         torch.zeros_like(lines_r), None)
        got = winner & (rdata[:, LOCK_LANE] == 0)
        failed = has_next & ~got
        # carry the freshly-read lanes at position k (immutable while
        # the lock is held)
        onehot = (g_idx == kc[:, None]) & got[:, None]
        lanes = torch.where(onehot[:, :, None], rdata[:, None, :], lanes)
        # ACQUIRE spin: publish the lock word
        wlock = rdata.clone()
        wlock[:, LOCK_LANE] = slot + 1
        lines_a = torch.where(got, want, -1)
        state, _, r2, ok2, t2 = spin(state, node_id, lines_a,
                                     torch.ones_like(lines_a), wlock)
        k2 = k + got.to(torch.int32)
        complete = live & (k2 >= nv)
        decision_new, new_lanes = apply_fn(lanes, glines, rmask, wmask,
                                           ts)
        # FINALIZE spin: completers publish+release all lines, no-wait
        # losers release their held prefix (lanes carried unchanged)
        fin_c = complete[:, None] & (glines >= 0)
        fin_f = failed[:, None] & (g_idx < k[:, None])
        fdata = torch.where(fin_c[:, :, None], new_lanes, lanes)
        fdata[:, :, LOCK_LANE] = 0
        flines = torch.where(fin_c | fin_f, glines, -1).reshape(b * g_n)
        state, _, r3, ok3, t3 = spin(state, node_rep, flines,
                                     torch.ones_like(flines),
                                     fdata.reshape(b * g_n, w_n))
        k = torch.where(failed, 0, k2)
        done = done | complete
        dec = torch.where(complete, decision_new, dec)
        estep = torch.where(complete, it, estep)
        retr = retr + failed.to(torch.int32)
        it += 1
        ok = ok and ok1 and ok2 and ok3
        rounds += r1 + r2 + r3
        tele = add_tele(tele, add_tele(t1, add_tele(t2, t3)))
    return (state, dec, estep, retr, it, bool(done.all()), ok, rounds,
            tele)


# ------------------------------------------------------ host-facing API

@dataclass(frozen=True)
class TxnBatchResult:
    """Host-side result of one txn batch.

    ``decision`` bool [B] (commit/abort), ``exec_step`` int [B] (the
    scheduler iteration each txn completed at — its position in the
    serial order), ``retries`` int [B] (no-wait restarts), ``iters``
    total scheduler iterations, ``rounds`` total coherence rounds
    across all spins.  ``telemetry`` is the
    :class:`~repro_torch.obs.PlaneTelemetry` record summed over every
    spin of the batch (:func:`run_txn_batch_host` leaves it None; its
    per-phase ``plane.ops`` dispatches each carry their own)."""

    decision: np.ndarray
    exec_step: np.ndarray
    retries: np.ndarray
    iters: int
    rounds: int
    telemetry: PlaneTelemetry | None = None


def run_txn_batch(plane, node_id, glines, rmask, wmask, ts, *,
                  algo: str, max_iters: int | None = None,
                  max_rounds: int | None = None) -> TxnBatchResult:
    """Drive one txn batch through ``plane`` (flat or sharded: a
    sharded plane pads B to its shard count) and normalize the result; the canonical-order contract (each row of ``glines`` sorted
    ascending, ``-1`` pads at the end) is validated here, where it's
    cheap."""
    if algo not in _APPLY:
        raise ValueError(f"unknown txn algo {algo!r} "
                         f"(have {sorted(_APPLY)})")
    glines = np.asarray(glines, np.int32)
    node_id = np.asarray(node_id, np.int32)
    rmask = np.asarray(rmask, np.int32)
    wmask = np.asarray(wmask, np.int32)
    ts = np.asarray(ts, np.int32)
    b = glines.shape[0]
    t_n = rmask.shape[2]
    need = txn_payload_width(t_n)
    if plane.payload_width != need:
        raise ValueError(
            f"plane payload_width={plane.payload_width} but "
            f"T={t_n} tuple headers need {need} lanes")
    valid = glines >= 0
    if (valid[:, 1:] & ~valid[:, :-1]).any():
        raise ValueError("glines pads (-1) must trail the valid lines")
    both = valid[:, 1:] & valid[:, :-1]
    if (both & (glines[:, 1:] <= glines[:, :-1])).any():
        raise ValueError("glines must be sorted strictly ascending "
                         "per txn (canonical latch order)")
    mr = plane.max_rounds if max_rounds is None else max_rounds
    mi = 4 * b + 16 if max_iters is None else max_iters
    if plane.sharded:
        pad = (-b) % plane.n_shards
        if pad:
            g_n = glines.shape[1]
            node_id = np.concatenate([node_id, np.zeros(pad, np.int32)])
            glines = np.concatenate(
                [glines, np.full((pad, g_n), -1, np.int32)])
            rmask = np.concatenate(
                [rmask, np.zeros((pad, g_n, t_n), np.int32)])
            wmask = np.concatenate(
                [wmask, np.zeros((pad, g_n, t_n), np.int32)])
            ts = np.concatenate([ts, np.zeros(pad, np.int32)])
        state, dec, estep, retr, it, alldone, ok, rounds, tele = \
            run_txn_rounds_sharded(
                plane.state, node_id, glines, rmask, wmask, ts,
                algo=algo, mesh=plane.mesh, axis=plane.axis,
                n_nodes=plane.n_nodes, max_rounds=mr, max_iters=mi,
                bucket_cap=plane.bucket_cap)
    else:
        state, dec, estep, retr, it, alldone, ok, rounds, tele = \
            run_txn_rounds(plane.state, node_id, glines, rmask, wmask,
                           ts, algo=algo, n_nodes=plane.n_nodes,
                           max_rounds=mr, max_iters=mi)
    plane.state = state
    telemetry = plane._telemetry(tele)
    if not ok:
        raise RuntimeError(f"txn coherence spin hit max_rounds={mr}")
    if not alldone:
        raise RuntimeError(
            f"txn batch not done after {mi} scheduler iterations "
            f"(livelock? raise max_iters)")
    return TxnBatchResult(dec[:b].cpu().numpy(), estep[:b].cpu().numpy(),
                          retr[:b].cpu().numpy(), it, rounds, telemetry)


def _apply_host_one(algo, lanes, glines, rmask, wmask, ts):
    """Python mirror of ``_APPLY[algo]`` for ONE txn's carried lanes —
    the host-driven reference scheduler applies per completing txn."""
    g_n, w_n = lanes.shape
    t_n = (w_n - HDR_LANES) // 2
    new = lanes.copy()
    if algo == "2pl":
        for g in range(g_n):
            if glines[g] >= 0 and wmask[g].any():
                new[g, WRITES_LANE] += 1
        return True, new
    for g in range(g_n):
        if glines[g] < 0:
            continue
        for t in range(t_n):
            r, w = bool(rmask[g, t]), bool(wmask[g, t])
            if not (r or w):
                continue
            rts = new[g, HDR_LANES + 2 * t]
            wts = new[g, HDR_LANES + 2 * t + 1]
            if w:
                if ts < rts or ts < wts:
                    return False, new
                new[g, HDR_LANES + 2 * t + 1] = ts
            else:
                if ts < wts:
                    return False, new
                new[g, HDR_LANES + 2 * t] = max(rts, ts)
    return True, new


def run_txn_batch_host(plane, node_id, glines, rmask, wmask, ts, *,
                       algo: str,
                       max_iters: int | None = None) -> TxnBatchResult:
    """The host-driven reference: the same txn scheduler, one
    ``plane.ops`` dispatch (with a host sync) per phase per iteration,
    dedup/apply/bookkeeping in numpy between dispatches.  Bit-identical
    decisions, exec order, retries and memory image to
    :func:`run_txn_batch` — its differential oracle."""
    if algo not in _APPLY:
        raise ValueError(f"unknown txn algo {algo!r}")
    glines = np.asarray(glines, np.int32)
    rmask = np.asarray(rmask, np.int32)
    wmask = np.asarray(wmask, np.int32)
    ts = np.asarray(ts, np.int32)
    b, g_n = glines.shape
    w_n = plane.payload_width
    node_id = np.broadcast_to(np.asarray(node_id, np.int32),
                              (b,)).astype(np.int32)
    nv = (glines >= 0).sum(axis=1)
    mi = 4 * b + 16 if max_iters is None else max_iters
    g_idx = np.arange(g_n)
    k = np.zeros(b, np.int64)
    done = nv == 0
    dec = np.zeros(b, bool)
    estep = np.zeros(b, np.int64)
    retr = np.zeros(b, np.int64)
    lanes = np.zeros((b, g_n, w_n), np.int32)
    rounds = it = 0
    while not done.all():
        if it >= mi:
            raise RuntimeError(
                f"txn batch not done after {mi} scheduler iterations "
                f"(livelock? raise max_iters)")
        live = ~done
        kc = np.minimum(k, g_n - 1)
        has_next = live & (k < nv)
        want = np.where(has_next, glines[np.arange(b), kc], -1)
        winner = np.zeros(b, bool)
        seen: set = set()
        for i in range(b):              # lowest slot wins, like device
            if want[i] >= 0 and want[i] not in seen:
                seen.add(int(want[i]))
                winner[i] = True
        res = plane.ops(node_id,
                        np.where(winner, want, -1).astype(np.int32),
                        np.zeros(b, np.int32))
        rounds += res.rounds
        rdata = np.asarray(res.data)
        got = winner & (rdata[:, LOCK_LANE] == 0)
        failed = has_next & ~got
        lanes[got, kc[got]] = rdata[got]
        wlock = rdata.copy()
        wlock[:, LOCK_LANE] = np.arange(b) + 1
        res = plane.ops(node_id,
                        np.where(got, want, -1).astype(np.int32),
                        np.ones(b, np.int32), wlock)
        rounds += res.rounds
        k2 = k + got
        complete = live & (k2 >= nv)
        fdata = lanes.copy()
        for i in np.flatnonzero(complete):
            dec[i], fdata[i] = _apply_host_one(
                algo, lanes[i], glines[i], rmask[i], wmask[i],
                int(ts[i]))
        fdata[:, :, LOCK_LANE] = 0
        fin = (complete[:, None] & (glines >= 0)) \
            | (failed[:, None] & (g_idx[None, :] < k[:, None]))
        res = plane.ops(np.repeat(node_id, g_n),
                        np.where(fin, glines, -1).reshape(b * g_n)
                        .astype(np.int32),
                        np.ones(b * g_n, np.int32),
                        fdata.reshape(b * g_n, w_n))
        rounds += res.rounds
        estep[complete] = it
        done = done | complete
        retr += failed
        k = np.where(failed, 0, k2)
        it += 1
    return TxnBatchResult(dec, estep.astype(np.int64),
                          retr.astype(np.int64), it, int(rounds))
