"""The continuous-batching serve loop over the rounds-plane KV pool.

Tick semantics (the engine's whole contract is in this ordering):

1. **expire** — queued requests past their deadline are dropped;
2. **admit** — FCFS from the queue into free slots while the pool can
   reserve each request's whole page budget (head-of-line blocking is
   deliberate: skipping ahead would starve large requests forever);
3. **prefill rows** — each PREFILL slot consumes up to the tick's
   remaining ``prefill_chunk`` budget of prompt tokens (all but the
   last prompt token; KV from ``model.prefill_kv``).  A slot whose
   prompt is consumed flips to DECODE with the last prompt token
   pending — prefill and decode are separated per SLOT, not per tick;
4. **decode step** — every DECODE slot consumes its pending token
   (``model.decode``), producing that token's KV and the next emitted
   token;
5. **ONE fused append** — all prefill + decode rows of the tick go
   through a single ``SELCCKVPool.append`` (one jitted ``run_rmw``
   coherence call), padded with ``page = -1`` rows to the fixed width
   ``prefill_chunk + n_slots`` so every tick shares one jit trace.
   Rows carry a PER-ROW replica (``slot.sid % n_replicas``); slot-
   private pages guarantee no two replicas touch one line per call;
6. **ONE fused attend** — one ``pool.attend`` over the fixed
   ``[n_slots, max_pages]`` grid (inactive slots masked with
   ``lens = 0``), serving decode attention straight from the plane's
   protocol-fresh ``mem_data`` image;
7. **complete/evict** — slots that emitted their ``max_new``-th token
   fire ``on_complete(req, slot)`` (pages still live — the hook can
   read them back through the plane), then their private pages return
   to the pool free list.

Threading model: ``tick()`` is synchronous and lock-protected;
``start()`` runs it on a daemon thread whenever there is work (the
MaxText/JetStream offline-engine shape), ``submit()`` is safe from any
thread, ``drain()`` blocks until queue + slots are empty.  One loop
owns one pool — the pool itself is NOT thread-safe.

The loop requires the pool's ROUNDS plane (``open_rounds_plane()``),
in write-through mode: the fused attend reads the plane's ``mem_data``
memory image, which under write-back lags dirty appenders by design.

A copy of ``repro/serve/loop.py`` with two changes: the attend output
comes back as a device tensor and is moved to the host explicitly, and
the flight-recorder hook (``recorder=``) waits for the recorder's port.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from ..obs import MetricsRegistry
from .model import DecodeView
from .request import QueueFull, RequestQueue, RequestState, ServeRequest
from .slots import Phase, SlotManager

__all__ = ["QueueFull", "ServeLoop", "ServeStats"]


@dataclass(frozen=True)
class ServeStats:
    """Immutable per-tick counter snapshot (satellite: engine counters).

    Totals are cumulative since construction; ``appended_tokens`` counts
    real (non-padding) rows through the fused append, and
    ``last_rounds`` is the coherence-round count the tick's fused
    ``run_rmw`` spun (0 on an idle tick).  ``queue_wait`` and ``tpot``
    are streaming-histogram snapshots (count/sum/min/max/mean/p50/p90/
    p99 dicts, None before any sample): submit→admit wall seconds per
    request, and per-slot inter-token wall seconds (time per output
    token, the serving-latency metric TTFT/TPOT dashboards plot)."""
    tick: int = 0
    queue_depth: int = 0
    active_slots: int = 0
    prefill_slots: int = 0
    decode_slots: int = 0
    admitted: int = 0
    completed: int = 0
    expired: int = 0
    rejected: int = 0
    pages_in_use: int = 0
    free_pages: int = 0
    appended_tokens: int = 0
    attend_calls: int = 0
    last_rounds: int = 0
    rounds_total: int = 0
    queue_wait: dict | None = None
    tpot: dict | None = None


class ServeLoop:
    """Continuous-batching engine over one rounds-plane
    :class:`~repro_torch.dsm.kvpool.SELCCKVPool`."""

    def __init__(self, pool, model, *, n_slots: int = 8,
                 max_pages: int = 16, prefill_chunk: int = 8,
                 queue_capacity: int = 64, on_complete=None):
        if pool.rounds_plane is None:
            raise ValueError(
                "ServeLoop serves the rounds plane: call "
                "pool.open_rounds_plane() first")
        if pool.rounds_plane.write_back:
            raise ValueError(
                "ServeLoop needs a write-through plane: the fused "
                "attend reads mem_data, which write-back lets lag "
                "behind dirty appenders")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} < 1")
        self.pool = pool
        self.model = model
        self.n_slots = int(n_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.queue = RequestQueue(queue_capacity)
        self.slots = SlotManager(pool, n_slots, max_pages)
        self.on_complete = on_complete
        # the registry carries the serving histograms
        self.registry = MetricsRegistry()
        self._h_qwait = self.registry.histogram(
            "serve_queue_wait_seconds",
            "submit to admit wall time per request")
        self._h_tpot = self.registry.histogram(
            "serve_tpot_seconds",
            "inter-token wall time per decoding slot")
        self._last_emit: dict[int, float] = {}
        self._lock = threading.RLock()
        self._tick = 0
        self._admitted = self._completed = 0
        self._expired = self._rejected = 0
        self._appended = self._attends = 0
        self._last_rounds = self._rounds_total = 0
        self._thread = None
        self._stop = threading.Event()

    # -------------------------------------------------------- admission
    def submit(self, prompt, max_new: int, *, shared_pages=(),
               shared_len: int = 0,
               deadline_tick: int | None = None) -> ServeRequest:
        """Enqueue one request.  Raises ``ValueError`` (REJECTED, can
        never fit) for oversize requests and :class:`QueueFull`
        (transient backpressure — retry after completions) at queue
        capacity."""
        req = ServeRequest(prompt=tuple(prompt), max_new=int(max_new),
                           shared_pages=tuple(shared_pages),
                           shared_len=int(shared_len),
                           deadline_tick=deadline_tick)
        with self._lock:
            try:
                self.slots.check_fits(req)
            except ValueError:
                self._rejected += 1
                raise
            return self.queue.submit(req, tick=self._tick)

    def has_work(self) -> bool:
        with self._lock:
            return bool(len(self.queue) or self.slots.active())

    # ------------------------------------------------------------- tick
    def tick(self) -> ServeStats:
        """One engine step: admit, ONE fused append, ONE fused attend,
        complete.  Returns the post-tick stats snapshot."""
        with self._lock:
            t = self._tick
            self._expired += len(self.queue.expire(t))

            while True:                          # FCFS admission
                slot = self.slots.free_slot()
                req = self.queue.peek()
                if slot is None or req is None:
                    break
                if not self.slots.can_reserve(req):
                    if not self.slots.active():
                        # nothing in flight will ever free pages: the
                        # head request is permanently unserveable
                        raise RuntimeError(
                            f"request {req.rid} needs "
                            f"{self.slots.pages_needed(req)} pages but "
                            f"only {self.pool.free_pages} exist free "
                            f"with no active slots to evict")
                    break                        # pool backpressure
                self.slots.admit(self.queue.pop(), slot, t)
                self._admitted += 1
                if req.submit_time:
                    self._h_qwait.observe(
                        time.perf_counter() - req.submit_time)

            # ---- prefill rows (global per-tick token budget) ----------
            ps = self.pool.cfg.page_size
            rows_page, rows_off, rows_k, rows_v, rows_rep = \
                [], [], [], [], []
            budget = self.prefill_chunk
            for slot in self.slots.prefilling():
                if budget == 0:
                    break
                req = slot.req
                take = min(budget, len(req.prompt) - 1 - slot.cursor)
                if take:
                    toks = req.prompt[slot.cursor:slot.cursor + take]
                    positions = range(slot.pos, slot.pos + take)
                    k, v = self.model.prefill_kv(req, toks, positions)
                    for i, p in enumerate(positions):
                        rows_page.append(slot.page_tbl[p // ps])
                        rows_off.append(p % ps)
                        rows_k.append(k[i])
                        rows_v.append(v[i])
                        rows_rep.append(slot.replica)
                    slot.cursor += take
                    slot.pos += take
                    budget -= take
                if slot.cursor == len(req.prompt) - 1:
                    slot.phase = Phase.DECODE
                    slot.pending = req.prompt[-1]
                    req.state = RequestState.DECODE

            # ---- decode step: consume every pending token -------------
            dslots = self.slots.decoding()
            views = [DecodeView(sid=s.sid, req=s.req, pending=s.pending,
                                pos=s.pos) for s in dslots]
            outs = self.model.decode(views) if views else []
            for slot, out in zip(dslots, outs):
                rows_page.append(slot.page_tbl[slot.pos // ps])
                rows_off.append(slot.pos % ps)
                rows_k.append(out.k)
                rows_v.append(out.v)
                rows_rep.append(slot.replica)

            # ---- ONE fused append for the whole tick ------------------
            n_rows = len(rows_page)
            self._last_rounds = 0
            if n_rows:
                width = self.prefill_chunk + self.n_slots
                kv_shape = (width, self.model.n_kv_heads,
                            self.model.head_dim)
                pages = np.full((width,), -1, np.int32)
                offs = np.zeros((width,), np.int32)
                reps = np.zeros((width,), np.int32)
                k_new = np.zeros(kv_shape, np.float32)
                v_new = np.zeros(kv_shape, np.float32)
                pages[:n_rows] = rows_page
                offs[:n_rows] = rows_off
                reps[:n_rows] = rows_rep
                k_new[:n_rows] = rows_k
                v_new[:n_rows] = rows_v
                self._last_rounds = int(self.pool.append(
                    pages, offs, k_new, v_new, replica=reps))
                self._rounds_total += self._last_rounds
                self._appended += n_rows

            # ---- advance decode slots + emit tokens -------------------
            emit_t = time.perf_counter()
            for slot, out in zip(dslots, outs):
                slot.pos += 1
                slot.pending = int(out.token)
                slot.req.generated.append(int(out.token))
                slot.stats_ticks += 1
                prev = self._last_emit.get(slot.sid)
                if prev is not None:
                    self._h_tpot.observe(emit_t - prev)
                self._last_emit[slot.sid] = emit_t

            # ---- ONE fused attend over the slot grid ------------------
            q_rows = [(s, o.q) for s, o in zip(dslots, outs)
                      if o.q is not None]
            if q_rows:
                hq, hd = self.model.n_q_heads, self.model.head_dim
                q = np.zeros((self.n_slots, hq, hd), np.float32)
                tbl = np.full((self.n_slots, self.slots.max_pages), -1,
                              np.int32)
                lens = np.zeros((self.n_slots,), np.int32)
                for slot, qr in q_rows:
                    q[slot.sid] = qr
                    tbl[slot.sid] = slot.page_tbl
                    lens[slot.sid] = slot.pos
                # the attend output lives on the pool's device
                attn = self.pool.attend(q, tbl, lens).cpu().numpy()
                self._attends += 1
                for slot, _ in q_rows:
                    slot.last_attn = attn[slot.sid]

            # ---- completions ------------------------------------------
            for slot in dslots:
                if len(slot.req.generated) >= slot.req.max_new:
                    if self.on_complete is not None:
                        self.on_complete(slot.req, slot)
                    self.slots.release(slot, t)
                    self._last_emit.pop(slot.sid, None)
                    self._completed += 1

            self._tick = t + 1
            return self.stats()

    def stats(self) -> ServeStats:
        with self._lock:
            return ServeStats(
                tick=self._tick, queue_depth=len(self.queue),
                active_slots=len(self.slots.active()),
                prefill_slots=len(self.slots.prefilling()),
                decode_slots=len(self.slots.decoding()),
                admitted=self._admitted, completed=self._completed,
                expired=self._expired, rejected=self._rejected,
                pages_in_use=self.pool.pages_in_use,
                free_pages=self.pool.free_pages,
                appended_tokens=self._appended,
                attend_calls=self._attends,
                last_rounds=self._last_rounds,
                rounds_total=self._rounds_total,
                queue_wait=(self._h_qwait.snapshot()
                            if self._h_qwait.count else None),
                tpot=(self._h_tpot.snapshot()
                      if self._h_tpot.count else None))

    def render_prom(self) -> str:
        """Prometheus text exposition of the loop's registry (the
        serving histograms)."""
        return self.registry.render_prom()

    # -------------------------------------------------- background loop
    def start(self) -> None:
        """Run ticks on a daemon thread whenever there is work."""
        if self._thread is not None:
            raise RuntimeError("serve loop already started")
        self._stop.clear()

        def _run():
            while not self._stop.is_set():
                if self.has_work():
                    self.tick()
                else:
                    time.sleep(1e-3)
        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="serve-loop")
        self._thread.start()

    def drain(self, timeout: float | None = None) -> bool:
        """Block until the queue and every slot are empty (True), or
        ``timeout`` seconds pass (False).  With no background thread
        running, ticks synchronously instead of waiting."""
        deadline = None if timeout is None else time.time() + timeout
        while self.has_work():
            if deadline is not None and time.time() > deadline:
                return False
            if self._thread is None:
                self.tick()
            else:
                time.sleep(1e-3)
        return True

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
