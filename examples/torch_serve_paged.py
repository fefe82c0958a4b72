"""End-to-end driver on the PyTorch port (the paper's kind = serving
infrastructure): multi-replica LLM serving over the SELCC-coherent
disaggregated KV pool, driven by the continuous-batching engine
(``repro_torch.serve``); the flow and the printed lines of
``examples/serve_paged.py``.

Two serving replicas share one disaggregated KV-page pool on the
rounds-plane coherence engine.  A batch of requests shares a
system-prompt prefix: it is prefilled ONCE into shared pages through
coherent plane writes; both replicas' requests then stream through
``serve.ServeLoop`` — one fused append per tick lands every slot's new
KV in the pool, with each slot's private tail pages keeping the
per-call atomicity contract.  The decode compute itself runs through the
SAME ``lm.decode_step`` callable as the hand-rolled reference loop kept
below, wrapped as a serve-model adapter, so the engine's outputs are
asserted TOKEN-FOR-TOKEN IDENTICAL to that loop.  A prefix update at
the end invalidates cached copies on every replica — the MSI walk of
Fig. 2 on real model state.  Everything runs on ``--device`` (``cuda``
unless ``--device cpu`` is given); on the card the smoke model's head
dim is the attention kernels' smallest, 64 (``configs.on_device``).

    PYTHONPATH=src python examples/torch_serve_paged.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_smoke_config, on_device  # noqa: E402
from repro_torch.dsm.kvpool import KVPoolConfig, SELCCKVPool  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.lm import NO_PARALLEL as CTX  # noqa: E402
from repro_torch.serve import DecodeOut, ServeLoop, write_pages  # noqa: E402

ARCH = "llava-next-mistral-7b"       # dense backbone, GQA
PAGE = 16
PREFIX_TOKENS = 64
GEN_TOKENS = 24
BATCH_PER_REPLICA = 4
N_REPLICAS = 2


def seeded_decode_cache(cfg, cache):
    """A decode cache holding the shared prefix KV at pos=PREFIX_TOKENS
    — both the reference loop and the engine adapter start from this
    exact state, per replica."""
    dev = cache["k"].device
    dc = lm.init_decode_cache(cfg, BATCH_PER_REPLICA,
                              PREFIX_TOKENS + GEN_TOKENS, device=dev)
    for name in ("k", "v"):
        dc[name][:, :, :PREFIX_TOKENS] = cache[name][:, 0:1, :PREFIX_TOKENS]
    dc["pos"] = torch.full((BATCH_PER_REPLICA,), PREFIX_TOKENS,
                           dtype=torch.int32, device=dev)
    return dc


class LMAdapter:
    """Serve-model surface around the SAME ``lm.decode_step`` callable
    the reference loop uses: per engine tick it steps each replica's
    gang with identical inputs, hands the engine the layer-0 KV of the
    consumed tokens (for the fused coherent append into pool pages), and
    emits the argmax next tokens.  ``q=None`` opts out of the engine's
    fused attend — this model runs its own attention inside
    ``decode_step``."""

    def __init__(self, params, cfg, step, cache):
        self.params, self.cfg, self.step = params, cfg, step
        self.n_kv_heads = cfg.n_kv_heads
        self.head_dim = cfg.hd
        self.n_q_heads = cfg.n_heads
        self._dc = [seeded_decode_cache(cfg, cache)
                    for _ in range(N_REPLICAS)]

    def prefill_kv(self, req, tokens, positions):
        raise NotImplementedError("single-token prompts never prefill")

    def decode(self, views):
        outs = {}
        for rep in range(N_REPLICAS):
            gang = [w for w in views if w.sid % N_REPLICAS == rep]
            if not gang:
                continue
            gang.sort(key=lambda w: w.sid)
            assert len(gang) == BATCH_PER_REPLICA, \
                "this demo admits whole replica gangs up front"
            dc = self._dc[rep]
            toks = torch.tensor([[w.pending] for w in gang],
                                dtype=torch.int32, device=dc["pos"].device)
            pos = int(dc["pos"][0])
            logits, dc = self.step(self.params, dc, toks)
            self._dc[rep] = dc
            nxt = logits.argmax(-1).cpu().numpy()
            k = dc["k"][0, :, pos].float().cpu().numpy()
            v = dc["v"][0, :, pos].float().cpu().numpy()
            for b, w in enumerate(gang):
                outs[w.sid] = DecodeOut(k=k[b], v=v[b],
                                        token=int(nxt[b]), q=None)
        return [outs[w.sid] for w in views]


def run(device=None, say=print):
    """The example's flow, its lines through ``say``; returns the
    engine's stats, the tokens of both loops and the coherence reads."""
    dev = resolve_device(device)
    cfg = on_device(get_smoke_config(ARCH).replace(n_patches=0), dev)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)

    def step(p, c, t):
        return lm.decode_step(p, c, t, cfg, CTX)

    rng = np.random.default_rng(0)
    prefix = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, PREFIX_TOKENS)).astype(np.int32)).to(dev)

    # ---- the shared prefix, prefilled once -------------------------------
    t0 = time.time()
    _, cache = lm.prefill(params, {"tokens": prefix, "labels": prefix},
                          cfg, CTX)
    say(f"[prefill] shared prefix ({PREFIX_TOKENS} tokens) computed "
        f"in {time.time()-t0:.1f}s")

    # per-replica initial tokens, drawn exactly as the reference did
    toks0 = [torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH_PER_REPLICA, 1)).astype(np.int32)).to(dev)
        for _ in range(N_REPLICAS)]

    # ---- REFERENCE: the pre-engine hand-rolled decode loop ---------------
    ref_tokens = {}                  # (replica, seq) -> [GEN_TOKENS]
    for replica in range(N_REPLICAS):
        toks = toks0[replica]
        dc = seeded_decode_cache(cfg, cache)
        t0 = time.time()
        for _ in range(GEN_TOKENS):
            logits, dc = step(params, dc, toks)
            toks = logits.argmax(-1)[:, None].to(torch.int32)
            got = toks[:, 0].cpu().tolist()
            for b in range(BATCH_PER_REPLICA):
                ref_tokens.setdefault((replica, b), []).append(got[b])
        dt = time.time() - t0
        say(f"[reference r{replica}] {GEN_TOKENS} tokens x "
            f"{BATCH_PER_REPLICA} seqs in {dt:.1f}s "
            f"({BATCH_PER_REPLICA*GEN_TOKENS/dt:.0f} tok/s)")

    # ---- ENGINE: the same workload through serve.ServeLoop ---------------
    pool_cfg = KVPoolConfig(
        n_pages=64, page_size=PAGE, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, n_replicas=N_REPLICAS, cache_slots=32)
    pool = SELCCKVPool(pool_cfg, device=dev)
    pool.open_rounds_plane()

    # shared prefix -> shared pool pages via coherent plane writes
    prefix_pages = pool.allocate(PREFIX_TOKENS // PAGE)
    kp = cache["k"][0, 0].float().cpu().reshape(
        -1, PAGE, cfg.n_kv_heads, cfg.hd)
    vp = cache["v"][0, 0].float().cpu().reshape(
        -1, PAGE, cfg.n_kv_heads, cfg.hd)
    write_pages(pool, prefix_pages, kp, vp)

    adapter = LMAdapter(params, cfg, step, cache)
    loop = ServeLoop(pool, adapter, n_slots=N_REPLICAS * BATCH_PER_REPLICA,
                     max_pages=(PREFIX_TOKENS + 1 + GEN_TOKENS - 1
                                + PAGE - 1) // PAGE,
                     prefill_chunk=1,
                     queue_capacity=N_REPLICAS * BATCH_PER_REPLICA)
    reqs = {}
    for b in range(BATCH_PER_REPLICA):       # slot 2b+r -> replica r
        for replica in range(N_REPLICAS):
            reqs[(replica, b)] = loop.submit(
                [int(toks0[replica][b, 0])], GEN_TOKENS,
                shared_pages=tuple(int(p) for p in prefix_pages),
                shared_len=PREFIX_TOKENS)
    t0 = time.time()
    loop.start()
    assert loop.drain(timeout=600), "engine failed to drain"
    loop.stop()
    dt = time.time() - t0
    st = loop.stats()
    total = N_REPLICAS * BATCH_PER_REPLICA * GEN_TOKENS
    say(f"[engine] {total} tokens across {st.completed} requests in "
        f"{dt:.1f}s ({total/dt:.0f} tok/s), {st.tick} ticks, "
        f"{st.appended_tokens} KV rows through "
        f"{st.rounds_total} coherence rounds, "
        f"pool pages in use after evict: {st.pages_in_use}")

    # ---- the engine must reproduce the reference TOKEN FOR TOKEN ---------
    for key, ref in sorted(ref_tokens.items()):
        got = reqs[key].generated
        assert got == ref, f"replica/seq {key}: {got} != {ref}"
    say(f"[check] engine outputs identical to the hand-rolled "
        f"reference for all {len(ref_tokens)} sequences")
    assert st.pages_in_use == len(prefix_pages), "leaked slot pages"

    # ---- prefix UPDATE: writer invalidates every cached copy --------------
    page0 = np.asarray([prefix_pages[0]], np.int32)
    _, _, h0 = pool.read(0, page0)
    _, _, h1 = pool.read(1, page0)
    _, _, h0b = pool.read(0, page0)
    say(f"[coherence] prefix page reads: first={bool(h0[0])}/"
        f"{bool(h1[0])} then hit={bool(h0b[0])}")
    zeros = np.zeros((1, cfg.n_kv_heads, cfg.hd), np.float32)
    pool.append(page0, np.array([0]), zeros, zeros, replica=0)
    _, _, h0c = pool.read(0, page0)
    _, _, h1c = pool.read(1, page0)
    say(f"[coherence] after prefix update by r0: reader re-reads "
        f"hit={bool(h0c[0])}/{bool(h1c[0])} (r1's stale copy was "
        f"invalidated)")
    return {"stats": st, "ref_tokens": ref_tokens,
            "engine_tokens": {k: r.generated for k, r in reqs.items()},
            "reads": [bool(h0[0]), bool(h1[0]), bool(h0b[0]),
                      bool(h0c[0]), bool(h1c[0])]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
