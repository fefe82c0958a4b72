"""The serving side of the port's serve tests, importing no JAX: the
small pool geometry, a pool's shared prefix, and ``_Side`` (one
package's pool and ``ServeLoop``, recording what each completion saw).
``mixed_trace`` is ``tests/test_serve.py``'s ``_mixed_trace``, copied so
that the ranks of ``tests/test_torch_ranks.py`` replay it without
importing the JAX package (that module holds the copy equal to it)."""

import numpy as np
import torch


GEOM = dict(n_pages=24, page_size=4, n_kv_heads=2, head_dim=4,
            n_replicas=2)


def mixed_trace(shared, n=9, seed=7):
    """[(prompt, max_new, shared_pages, shared_len)] — mixed prompt
    lengths, budgets, and shared-prefix usage."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = [int(x) for x in rng.integers(0, 97,
                                               int(rng.integers(1, 5)))]
        g = int(rng.integers(1, 6))
        if i % 3 == 0:
            out.append((prompt, g, tuple(shared), 4))
        else:
            out.append((prompt, g, (), 0))
    return out


def _shared_prefix(pool, serve, model, tokens):
    ps = pool.cfg.page_size
    pages = pool.allocate(len(tokens) // ps)
    shape = (len(pages), ps, model.n_kv_heads, model.head_dim)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for i, t in enumerate(tokens):
        kp[i // ps, i % ps], vp[i // ps, i % ps] = model.kv(t, i)
    serve.write_pages(pool, pages, kp, vp)
    return pages


def _host_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


class _Side:
    """One package's pool + loop, recording what each completion saw."""

    def __init__(self, serve, pool, prefix=True, recorder=None):
        self.pool = pool
        self.model = serve.ToyLM(pool.cfg, n_q_heads=4)
        self.shared = (_shared_prefix(pool, serve, self.model,
                                      list(range(pool.cfg.page_size)))
                       if prefix else ())
        self.attn, self.readback = {}, {}
        self.loop = serve.ServeLoop(pool, self.model, n_slots=3,
                                    max_pages=4, prefill_chunk=4,
                                    queue_capacity=16,
                                    on_complete=self._done,
                                    recorder=recorder)
        self.rounds = []

    def _done(self, req, slot):
        k, v, _ = self.pool.read(slot.replica,
                                 np.asarray(slot.pages, np.int32))
        self.readback[req.rid] = (_host_f32(k), _host_f32(v))
        self.attn[req.rid] = np.array(slot.last_attn)

    def submit(self, trace):
        """``trace`` rows are (prompt, max_new, shares_prefix,
        shared_len); a sharing row uses this side's prefix pages."""
        return [self.loop.submit(p, g, shared_pages=self.shared if sp
                                 else (), shared_len=sl if sp else 0)
                for p, g, sp, sl in trace]

    def tick(self):
        st = self.loop.tick()
        self.rounds.append(st.last_rounds)
