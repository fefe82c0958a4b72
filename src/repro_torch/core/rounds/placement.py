"""Host-side placement policies over the fused loops' telemetry.

Every plane verb reports per-line served-op counters
(``PlaneResult.telemetry.line_hits`` / ``.line_whits``) and per-home
congestion rows; this module turns them into placement decisions for
the two :class:`DevicePlane` knobs.  Both planners accept the raw
signal three ways — a :class:`~repro.obs.PlaneTelemetry`, a
``FlightRecorder``'s EWMA ``line_heat`` (float), or a plain count
array — so an online loop can drive placement straight off its
recorder with no stats plumbing:

* :func:`plan_rehome` — greedy move-hottest-to-coldest: while the load
  gap between the hottest and coldest home shard is worth closing, swap
  the hottest line on the hot shard with the coldest line on the cold
  shard.  Output feeds ``plane.rehome(lines, new_homes, victims)``
  verbatim.
* :func:`plan_replication` — pick the top read-mostly lines (high hit
  count, write fraction under a threshold) for ``plane.replicate``.

Both are plain numpy — policy runs between verb dispatches, where a
host decision is already paid for; the MECHANISM (directory exchange,
replica refresh) stays on device.  Greedy-by-hottest is the classic
first cut at skew-driven migration (MIND's in-network page placement
makes the same move in the switch); fancier policies drop in here
without touching the device plane.

A copy of ``repro/core/rounds/placement.py``; the planners also take
tensors on any device (``plane.state["home"]`` on the card), copied to
the host.
"""

from __future__ import annotations

import numpy as np


def _host(x):
    """numpy view of an array, or a host copy of a tensor."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return x


def _heat_array(signal, attr: str = "line_hits") -> np.ndarray:
    """Normalize a heat signal: PlaneTelemetry → its counter; anything
    else → float64 array (EWMA heat or raw counts)."""
    if hasattr(signal, attr):           # PlaneTelemetry (duck-typed)
        signal = getattr(signal, attr)
    return np.asarray(_host(signal), np.float64)


def plan_rehome(line_hits, perm, n_shards: int, *, max_moves: int = 8,
                min_gain: float = 1.0):
    """Greedy hottest-line-to-coldest-shard migration plan.

    ``line_hits`` [L] is the per-line serve signal — a
    :class:`~repro.obs.PlaneTelemetry` from a probe run, a recorder's
    EWMA ``line_heat``, or a plain count array; ``perm`` [L] the
    current home directory (``plane.state["home"]``).  Returns
    ``(lines, new_homes, victims)`` int32 arrays, possibly empty: move
    ``lines[i]`` to shard ``new_homes[i]``, swapping slots with
    ``victims[i]`` (the coldest line currently homed there).  Each step
    moves the single hottest line off the currently hottest shard;
    stops after ``max_moves``, when the swap's load transfer drops
    below ``min_gain``, or when a swap would overshoot (transfer >= the
    hot/cold load gap — moving it would just flip which shard is
    hot)."""
    hits = _heat_array(line_hits)
    perm = np.asarray(_host(perm), np.int64)
    l = hits.shape[0]
    if perm.shape[0] != l:
        raise ValueError("line_hits and perm must match in length")
    home = perm % n_shards
    loads = np.bincount(home, weights=hits, minlength=n_shards)
    used = np.zeros(l, bool)
    lines, homes, victims = [], [], []
    for _ in range(max_moves):
        hot = int(np.argmax(loads))
        cold = int(np.argmin(loads))
        if hot == cold:
            break
        gap = float(loads[hot] - loads[cold])
        # hottest movable line on the hot shard
        cand = np.flatnonzero((home == hot) & ~used)
        vict = np.flatnonzero((home == cold) & ~used)
        if cand.size == 0 or vict.size == 0:
            break
        a = int(cand[np.argmax(hits[cand])])
        b = int(vict[np.argmin(hits[vict])])
        transfer = float(hits[a] - hits[b])
        if transfer < min_gain or transfer >= gap:
            break
        used[a] = used[b] = True
        home[a], home[b] = cold, hot
        loads[hot] -= transfer
        loads[cold] += transfer
        lines.append(a)
        homes.append(cold)
        victims.append(b)
    return (np.asarray(lines, np.int32), np.asarray(homes, np.int32),
            np.asarray(victims, np.int32))


def plan_replication(line_hits, line_whits=None, *, top_k: int = 8,
                     max_write_frac: float = 0.05,
                     min_hits: float = 1.0):
    """Pick read-mostly lines worth replicating.

    ``line_hits`` is a :class:`~repro.obs.PlaneTelemetry` (its
    ``line_whits`` comes along for free and the second argument may be
    omitted) or a plain hit/heat array with ``line_whits`` passed
    alongside.  Eligible lines have at least ``min_hits`` served ops
    of which at most ``max_write_frac`` were writes (every write costs
    an invalidation plus a refresh, so hot WRITE lines must not
    replicate).  Returns up to ``top_k`` line ids, hottest first."""
    if line_whits is None:
        if not hasattr(line_hits, "line_whits"):
            raise ValueError("line_whits required unless line_hits "
                             "is a PlaneTelemetry")
        line_whits = line_hits.line_whits
    hits = _heat_array(line_hits)
    whits = np.asarray(_host(line_whits), np.float64)
    if whits.shape != hits.shape:
        raise ValueError("line_hits and line_whits must match in shape")
    ok = (hits >= min_hits) & (whits <= max_write_frac * hits)
    cand = np.flatnonzero(ok)
    order = cand[np.argsort(hits[cand])[::-1]]
    return order[:top_k].astype(np.int32)
