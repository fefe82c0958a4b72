"""Serve step builder; port of ``repro.train.step.build_serve_step``.

There is no mesh: the port runs on one device, and the sharded stack
waits for ROADMAP.md queue 1 item 9.  The training half of the JAX
module (``build_train_step`` and its optimizer wiring) waits for
ROADMAP.md queue 1 item 4.
"""

from __future__ import annotations

from .. import resolve_device
from ..models import lm
from ..models.config import LMConfig


def build_serve_step(cfg: LMConfig, device=None):
    """Returns ``(serve_step, serve_prefill, ctx)`` for ``cfg`` on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for).  Token ids, and a
    prefill's ``patch_embeds`` and ``enc_embeds``, are moved to the
    device; parameters and caches must already live there.
    """
    dev = resolve_device(device)
    ctx = lm.NO_PARALLEL

    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cache, tokens.to(dev), cfg, ctx)

    def serve_prefill(params, batch):
        batch = {k: v.to(dev) if k in ("tokens", "patch_embeds",
                                        "enc_embeds") else v
                 for k, v in batch.items()}
        return lm.prefill(params, batch, cfg, ctx)

    return serve_step, serve_prefill, ctx
