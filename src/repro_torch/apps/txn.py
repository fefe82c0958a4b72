"""Transaction counters shared by the host DES engine and the device
batch engine: a copy of ``TxnStats`` from ``repro/apps/txn.py`` over
the port's ``obs.StreamingHistogram`` (the DES engine itself is not
ported)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..obs import StreamingHistogram


@dataclass
class TxnStats:
    """Per-engine counters: commits, aborts by REASON ("nowait" — 2PL
    lock conflict, "ts" — TO timestamp check, "occ" — version
    validation), and the latency distribution (wall seconds on the
    device engine) as an ``obs.StreamingHistogram`` — bounded memory at
    any txn count, tail percentiles within the sketch's relative-error
    bound."""

    commits: int = 0
    aborts: int = 0
    latency_sum: float = 0.0
    abort_reasons: dict = field(default_factory=dict)
    latency: StreamingHistogram = field(
        default_factory=StreamingHistogram)

    def record(self, ok: bool, latency: float,
               reason: str | None = None) -> None:
        if ok:
            self.commits += 1
        else:
            self.aborts += 1
            if reason is not None:
                self.abort_reasons[reason] = \
                    self.abort_reasons.get(reason, 0) + 1
        self.latency_sum += latency
        self.latency.observe(latency)

    @property
    def p50(self) -> float:
        return self.latency.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.latency.quantile(0.99)
