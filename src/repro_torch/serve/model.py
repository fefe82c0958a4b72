"""The model side of the serving engine's tick.

The engine is model-agnostic: anything providing this (duck-typed)
surface can be served —

* ``n_q_heads`` / ``n_kv_heads`` / ``head_dim`` — the attention
  geometry (must match the pool's ``KVPoolConfig``);
* ``prefill_kv(req, tokens, positions) -> (k, v)`` — KV for a CHUNK of
  prompt tokens (``[n, Hkv, hd]`` each), consumed without emission;
* ``decode(views) -> [DecodeOut]`` — one decode step for a batch of
  slots: each view's ``pending`` token is consumed at KV position
  ``pos`` (its k/v land in the tick's fused append) and the next token
  is emitted.  ``DecodeOut.q`` feeds the tick's fused paged-attention
  call over the pool (return ``None`` to opt a slot out — e.g. a model
  that runs its own attention, like the ``examples/serve_paged.py``
  adapter around ``models.lm.decode_step``).

:class:`ToyLM` is the deterministic integer reference model used by the
tests and ``bench_serving``: next-token is a pure LCG fold of the token
history (bit-identical between the engine and the synchronous oracle —
no float in the token path to diverge), and KV/query values are small
multiples of 1/32, exactly representable in bf16 and fp32, so page
bytes round-trip the plane's int32 lanes bit-exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..dsm.kvpool import KVPoolConfig
from .request import ServeRequest

_MOD = 2**31 - 1


@dataclass(frozen=True)
class DecodeView:
    """One slot's decode-step input: consume ``pending`` at ``pos``."""
    sid: int
    req: ServeRequest
    pending: int                 # token whose KV this step writes
    pos: int                     # its global KV position


@dataclass
class DecodeOut:
    """One slot's decode-step result."""
    k: np.ndarray                # [Hkv, hd] KV of the consumed token
    v: np.ndarray
    token: int                   # emitted next token
    q: np.ndarray | None = None  # [Hq, hd] query for the fused attend


class ToyLM:
    """Deterministic toy LM over a :class:`KVPoolConfig` geometry."""

    def __init__(self, cfg: KVPoolConfig, vocab: int = 97,
                 n_q_heads: int | None = None):
        self.cfg = cfg
        self.vocab = int(vocab)
        self.n_kv_heads = cfg.n_kv_heads
        self.head_dim = cfg.head_dim
        self.n_q_heads = int(n_q_heads or cfg.n_kv_heads)
        if self.n_q_heads % self.n_kv_heads:
            raise ValueError(f"n_q_heads={self.n_q_heads} not a multiple "
                             f"of n_kv_heads={self.n_kv_heads}")

    # -------------------------------------------------- token path (int)
    def next_token(self, history) -> int:
        h = 0
        for t in history:
            h = (h * 131 + int(t) + 7) % _MOD
        return h % self.vocab

    # ----------------------------------------------- KV / query (float)
    def _grid(self, token: int, pos: int, heads: int, salt: int):
        h = np.arange(heads)[:, None]
        d = np.arange(self.head_dim)[None, :]
        vals = (int(token) * 1009 + int(pos) * 101 + h * 31 + d * 7
                + salt) % 61 - 30
        return (vals / 32.0).astype(np.float32)   # exact in bf16/fp32

    def kv(self, token: int, pos: int):
        return (self._grid(token, pos, self.n_kv_heads, 13),
                self._grid(token, pos, self.n_kv_heads, 29))

    def query(self, token: int, pos: int):
        return self._grid(token, pos, self.n_q_heads, 7)

    # -------------------------------------------------- engine surface
    def prefill_kv(self, req: ServeRequest, tokens, positions):
        ks, vs = zip(*(self.kv(t, p) for t, p in zip(tokens, positions)))
        return np.stack(ks), np.stack(vs)

    def decode(self, views: list[DecodeView]) -> list[DecodeOut]:
        outs = []
        for w in views:
            k, v = self.kv(w.pending, w.pos)
            outs.append(DecodeOut(
                k=k, v=v, token=self.next_token(w.req.history),
                q=self.query(w.pending, w.pos)))
        return outs

    # Pure-numpy oracle for a completed request's private page bytes —
    # what the plane must hand back bit-exactly at on_complete time.
    def expected_pages(self, req: ServeRequest):
        """-> (k_pages, v_pages, written) — [n_private, page, Hkv, hd]
        float32 expected bytes plus the [n_private, page] bool mask of
        positions the request actually wrote.  Only masked positions
        are comparable: a slot may be handed RECYCLED pages, and
        ``SELCCKVPool.free`` deliberately never scrubs — unwritten
        offsets keep the previous tenant's bytes."""
        ps = self.cfg.page_size
        consumed = list(req.prompt) + list(req.generated)[:-1]
        n_priv = -(-req.kv_len // ps) - len(req.shared_pages)
        shape = (n_priv, ps, self.n_kv_heads, self.head_dim)
        kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
        written = np.zeros((n_priv, ps), bool)
        for i, tok in enumerate(consumed):
            pos = req.shared_len + i
            pi = pos // ps - len(req.shared_pages)
            k, v = self.kv(tok, pos)
            kp[pi, pos % ps] = k
            vp[pi, pos % ps] = v
            written[pi, pos % ps] = True
        return kp, vp, written
