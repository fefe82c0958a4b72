"""Request vocabulary + admission queue for the serving engine.

A :class:`ServeRequest` is one sequence to serve: a prompt, a token
budget, and optionally a SHARED prefix already resident in pool pages
(the multi-replica system-prompt case of ``examples/serve_paged.py``).
KV positions follow the standard decode-loop convention — the slot
writes KV for every token it CONSUMES (prompt tokens plus all generated
tokens except the last, which is emitted but never fed back), so a
request occupies ``shared_len + len(prompt) + max_new - 1`` KV
positions, the first ``shared_len`` of them in the read-only shared
pages.

:class:`RequestQueue` is the engine's admission side: bounded (submit
past ``capacity`` raises :class:`QueueFull` — the caller-visible form
of backpressure), FCFS, with per-request deadlines expressed in engine
ticks (a request still QUEUED past its ``deadline_tick`` is EXPIRED and
dropped at the next tick, never silently served late).
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field


class RequestState(enum.Enum):
    QUEUED = "queued"        # submitted, waiting for a slot + pages
    PREFILL = "prefill"      # admitted; prompt KV streaming into pages
    DECODE = "decode"        # one token per engine tick
    DONE = "done"            # max_new tokens emitted; pages freed
    EXPIRED = "expired"      # deadline passed while still queued
    REJECTED = "rejected"    # can never fit a slot (oversize)


class QueueFull(RuntimeError):
    """Admission backpressure: the bounded request queue is at capacity."""


@dataclass
class ServeRequest:
    """One sequence through the engine (mutated in place as it moves
    through the lifecycle — the object handed back by ``submit`` IS the
    completion handle)."""

    prompt: tuple[int, ...]
    max_new: int
    shared_pages: tuple[int, ...] = ()
    shared_len: int = 0              # tokens resident in shared_pages
    deadline_tick: int | None = None
    rid: int = -1                    # assigned at submit
    state: RequestState = RequestState.QUEUED
    generated: list[int] = field(default_factory=list)
    submit_tick: int = -1
    admit_tick: int = -1
    done_tick: int = -1
    submit_time: float = 0.0         # perf_counter at submit (obs)

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        self.shared_pages = tuple(int(p) for p in self.shared_pages)
        if not self.prompt:
            raise ValueError("empty prompt: the engine needs at least "
                             "one token to consume")
        if self.max_new < 1:
            raise ValueError(f"max_new={self.max_new} < 1: a request "
                             f"must emit at least one token")

    @property
    def kv_len(self) -> int:
        """KV positions the sequence occupies at completion (consumed
        tokens): shared prefix + prompt + all generated but the last."""
        return self.shared_len + len(self.prompt) + self.max_new - 1

    @property
    def history(self) -> tuple[int, ...]:
        """Token history a deterministic model folds over (the shared
        prefix is identified by its pages, not re-tokenized here)."""
        return self.prompt + tuple(self.generated)


class RequestQueue:
    """Bounded FCFS admission queue (thread-safe: the client submits
    while the :class:`~repro_torch.serve.loop.ServeLoop` thread drains)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} < 1")
        self.capacity = int(capacity)
        self._q: list[ServeRequest] = []
        self._lock = threading.Lock()
        self._next_rid = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def depth(self) -> int:
        return len(self)

    def submit(self, req: ServeRequest, tick: int = 0) -> ServeRequest:
        """Enqueue; raises :class:`QueueFull` at capacity (backpressure
        is an explicit signal, not a silent drop)."""
        with self._lock:
            if len(self._q) >= self.capacity:
                raise QueueFull(
                    f"request queue at capacity ({self.capacity}); "
                    f"retry after completions drain it")
            req.rid = self._next_rid
            self._next_rid += 1
            req.state = RequestState.QUEUED
            req.submit_tick = tick
            req.submit_time = time.perf_counter()
            self._q.append(req)
            return req

    def expire(self, tick: int) -> list[ServeRequest]:
        """Drop (and return) queued requests whose deadline has passed
        — an expired request is never admitted late."""
        with self._lock:
            dead = [r for r in self._q
                    if r.deadline_tick is not None
                    and tick > r.deadline_tick]
            for r in dead:
                r.state = RequestState.EXPIRED
                self._q.remove(r)
            return dead

    def peek(self) -> ServeRequest | None:
        with self._lock:
            return self._q[0] if self._q else None

    def pop(self) -> ServeRequest | None:
        with self._lock:
            return self._q.pop(0) if self._q else None
