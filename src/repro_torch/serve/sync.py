"""Host-synced synchronous-batch baseline (and differential oracle).

A copy of ``repro/serve/sync.py`` on the port's ``encode_kv`` /
``decode_kv``.

:class:`SyncBatchServer` serves the SAME request semantics as
:class:`~repro_torch.serve.loop.ServeLoop` — identical KV positions, token
emission, page reservation and freeing — but the way serving engines
worked before continuous batching:

* **gang scheduling** — requests run in static batches of ``n_slots``;
  a finished sequence's slot sits idle until the WHOLE gang finishes,
  and no new request starts mid-gang;
* **host-synced appends** — every KV write is the pre-fuse two-phase
  path: one rounds call to read the page bytes, a numpy splice on the
  host, one rounds call to write them back — two device dispatches and
  a full host round trip where the engine's fused ``run_rmw`` spends
  one.

Because the semantics are bit-identical (same ``model``, same
deterministic token path, same positions), the differential test
replays one trace through both and asserts equal per-request outputs —
and the benchmark measures what continuous batching + the fused append
are worth end to end.

``write_pages`` is the shared-prefix bulk loader both servers use: it
seeds whole pages through ordinary coherent plane WRITE ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsm.kvpool import decode_kv, encode_kv, page_lanes
from .model import DecodeView
from .request import RequestState, ServeRequest
from .slots import Phase, Slot, SlotManager


def write_pages(pool, pages, k_pages, v_pages, replica: int = 0):
    """Seed whole pages (``[n, page, Hkv, hd]`` k/v) into the rounds
    plane via one fused batch of coherent write ops."""
    pages = np.asarray(pages, np.int32)
    wdata = encode_kv(torch.as_tensor(k_pages), torch.as_tensor(v_pages),
                      pool.cfg)
    node = np.full(pages.shape, replica, np.int32)
    pool._plane_ops(node, pages, np.ones_like(pages), wdata)


class SyncBatchServer:
    """Synchronous gang-batch server over a rounds-plane pool."""

    def __init__(self, pool, model, *, n_slots: int = 8,
                 max_pages: int = 16, on_complete=None):
        if pool.rounds_state is None:
            raise ValueError("SyncBatchServer serves the rounds plane: "
                             "call pool.open_rounds_plane() first")
        self.pool = pool
        self.model = model
        self.n_slots = int(n_slots)
        self.slots = SlotManager(pool, n_slots, max_pages)
        self.on_complete = on_complete
        self.plane_calls = 0             # device dispatches (appends)
        self.steps = 0

    # ---------------------------------------------- two-phase append
    def _append_two_phase(self, gang_rows):
        """The pre-fuse host loop: read rounds call -> numpy splice ->
        write rounds call.  ``gang_rows`` is [(page, off, k, v,
        replica)] with one row per slot, padded to ``n_slots``."""
        width = page_lanes(self.pool.cfg)
        b = self.n_slots
        pages = np.full((b,), -1, np.int32)
        offs = np.zeros((b,), np.int32)
        reps = np.zeros((b,), np.int32)
        kv_shape = (b, self.model.n_kv_heads, self.model.head_dim)
        k_new = np.zeros(kv_shape, np.float32)
        v_new = np.zeros(kv_shape, np.float32)
        for i, (p, o, k, v, r) in enumerate(gang_rows):
            pages[i], offs[i], reps[i] = p, o, r
            k_new[i], v_new[i] = k, v
        # phase 1: coherent read of the target pages (host sync)
        _, data = self.pool._plane_ops(
            reps, pages, np.zeros_like(pages),
            np.zeros((b, width), np.int32))
        # host-side splice
        k_pg, v_pg = (x.float().numpy()            # writable host copy
                      for x in decode_kv(torch.from_numpy(data),
                                         self.pool.cfg))
        for i in range(len(gang_rows)):
            if pages[i] >= 0:
                k_pg[i, offs[i]] = k_new[i]
                v_pg[i, offs[i]] = v_new[i]
        # phase 2: coherent write back (second dispatch + host sync)
        wdata = encode_kv(torch.from_numpy(k_pg), torch.from_numpy(v_pg),
                          self.pool.cfg)
        self.pool._plane_ops(reps, pages, np.ones_like(pages), wdata)
        self.plane_calls += 2

    # ----------------------------------------------------------- serve
    def serve(self, requests: list[ServeRequest]) -> list[ServeRequest]:
        """Serve to completion in FCFS gangs of ``n_slots``."""
        ps = self.pool.cfg.page_size
        queue = list(requests)
        for req in queue:
            self.slots.check_fits(req)
        done: list[ServeRequest] = []
        while queue:
            gang: list[Slot] = []
            while queue and len(gang) < self.n_slots \
                    and self.slots.can_reserve(queue[0]):
                slot = self.slots.free_slot()
                if slot is None:
                    break
                gang.append(self.slots.admit(queue.pop(0), slot, 0))
            if not gang:
                raise RuntimeError(
                    f"gang admission stuck: head request needs "
                    f"{self.slots.pages_needed(queue[0])} pages, "
                    f"{self.pool.free_pages} free")
            # ---- prefill: one token per slot per step, host-synced ----
            while any(s.phase == Phase.PREFILL for s in gang):
                rows = []
                for s in gang:
                    if s.phase != Phase.PREFILL:
                        continue
                    req = s.req
                    toks = (req.prompt[s.cursor],)
                    k, v = self.model.prefill_kv(req, toks, (s.pos,))
                    rows.append((s.page_tbl[s.pos // ps], s.pos % ps,
                                 k[0], v[0], s.replica))
                    s.cursor += 1
                    s.pos += 1
                    if s.cursor == len(req.prompt) - 1:
                        s.phase = Phase.DECODE
                        s.pending = req.prompt[-1]
                        req.state = RequestState.DECODE
                self._append_two_phase(rows)
                self.steps += 1
            # ---- decode: gang-locked steps until ALL slots finish -----
            while any(len(s.req.generated) < s.req.max_new for s in gang):
                live = [s for s in gang
                        if len(s.req.generated) < s.req.max_new]
                views = [DecodeView(sid=s.sid, req=s.req,
                                    pending=s.pending, pos=s.pos)
                         for s in live]
                outs = self.model.decode(views)
                rows = [(s.page_tbl[s.pos // ps], s.pos % ps, o.k, o.v,
                         s.replica) for s, o in zip(live, outs)]
                self._append_two_phase(rows)
                for s, o in zip(live, outs):
                    s.pos += 1
                    s.pending = int(o.token)
                    s.req.generated.append(int(o.token))
                # gang attend (idle slots masked), same fixed shape as
                # the engine's fused attend
                if any(o.q is not None for o in outs):
                    hq, hd = self.model.n_q_heads, self.model.head_dim
                    q = np.zeros((self.n_slots, hq, hd), np.float32)
                    tbl = np.full((self.n_slots, self.slots.max_pages),
                                  -1, np.int32)
                    lens = np.zeros((self.n_slots,), np.int32)
                    for s, o in zip(live, outs):
                        if o.q is None:
                            continue
                        q[s.sid] = o.q
                        tbl[s.sid] = s.page_tbl
                        lens[s.sid] = s.pos
                    attn = self.pool.attend(q, tbl, lens).cpu().numpy()
                    for s, o in zip(live, outs):
                        if o.q is not None:
                            s.last_attn = attn[s.sid]
                # per-request completion hook (pages still live until
                # the WHOLE gang finishes — that idle tail is the cost
                # this baseline exists to demonstrate)
                if self.on_complete is not None:
                    for s in live:
                        if len(s.req.generated) == s.req.max_new:
                            self.on_complete(s.req, s)
                self.steps += 1
            for s in gang:
                done.append(s.req)
                self.slots.release(s, 0)
        return done
