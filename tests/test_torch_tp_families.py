"""Tensor parallelism's reach into every family, in one process.

A model rank's code asks its own leaves whether it holds them as its
block (``ParallelCtx.at`` and ``split``): the hybrid family's blocks are
a list of per-layer dicts (``attn``, ``rec``, ``ffn``), the encdec
family's stacks are ``enc_blocks`` and ``dec_blocks`` with the decoder's
cross-attention ``x_`` leaves.  Held, on a mesh without ranks whose
context carries the model dims (as ``chip_smoke.tp_witness`` builds it),
with the smoke configs:

* the context of every layer and sub-block names the leaves the
  reference's specs shard over ``model`` (a walk that stopped at the
  hybrid's list answered "whole" for every one of its leaves);
* the hybrid family's embedding keeps its sqrt(d_model) scaling on the
  vocab-parallel path (it returned before the scaling);
* the whole model (train loss, prefill, decode) on the tensor-parallel
  path with no ranks equals the model without the model dims: every
  family, 1e-6 of the scale in fp32.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import _one_thread  # noqa: E402,F401

ARCHS = ("qwen3-1.7b", "deepseek-moe-16b", "mamba2-2.7b",
         "recurrentgemma-2b", "llava-next-mistral-7b", "seamless-m4t-medium")
TOL = 1e-6            # x the scale, fp32: the same function, sums reordered


def _tp_ctx(cfg):
    """The production mesh's context with the model dims set, no ranks:
    every tensor-parallel branch taken, every collective the identity."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as shard
    mesh = make_production_mesh(device="cpu")
    ctx = shard.make_ctx(mesh, cfg)
    assert ctx.tp is None
    return ctx, dataclasses.replace(ctx, tp=shard.model_dims(mesh, cfg))


def _cfg(arch):
    """The fp32 smoke config (a moe one with an expert a model shard of
    the production mesh)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch).replace(dtype="float32")
    return cfg.replace(n_experts=16) if cfg.family == "moe" else cfg


def test_layer_contexts_follow_lists_and_cross_leaves():
    """``ctx.at("blocks", i)`` walks into the hybrid's i-th layer (its
    ``attn`` or ``rec`` and ``ffn`` leaves), ``at("dec_blocks")`` and
    ``lm._xattn_ctx`` into the decoder's cross-attention; a path past a
    list's end or into a leaf names nothing."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("recurrentgemma-2b").replace(n_layers=3)
    _, ctx = _tp_ctx(cfg)
    rec, attn = ctx.at("blocks", 0), ctx.at("blocks", 2)
    assert all(rec.split("rec", k) for k in ("w_x", "w_r", "lam", "w_out"))
    assert rec.at("ffn").split("wd") and not rec.split("attn", "wq")
    assert attn.at("attn").split("wq") and attn.at("attn").split("wo")
    assert not ctx.split("blocks", 3, "attn", "wq")
    assert not ctx.split("blocks", 2, "attn", "wq", "more")
    cfg = get_config("seamless-m4t-medium").replace(n_layers=2,
                                                    n_enc_layers=2)
    _, ctx = _tp_ctx(cfg)
    dec = ctx.at("dec_blocks")
    assert ctx.at("enc_blocks").split("wq") and dec.split("wo")
    xctx = lm._xattn_ctx(dec)
    assert all(xctx.split(k) for k in ("wq", "wk", "wv", "wo", "bq"))
    assert not xctx.split("ln3")


def test_hybrid_embedding_keeps_its_scale_on_the_vocab_parallel_path():
    """recurrentgemma's embedding on the vocab-parallel path (the masked
    lookup, summed) is the plain lookup times sqrt(d_model), bit for
    bit."""
    from repro_torch.models import lm
    cfg = _cfg("recurrentgemma-2b")
    plain, ctx = _tp_ctx(cfg)
    assert ctx.split("embed")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    want = lm.embed_tokens(params, toks, cfg, plain)
    assert torch.equal(lm.embed_tokens(params, toks, cfg, ctx), want)
    assert torch.equal(want, params["embed"][toks] * cfg.d_model ** 0.5)


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_path_without_ranks_is_the_model(arch):
    """Every family's train loss, prefill logits and one decode step's
    logits on the tensor-parallel path with no ranks equal the plain
    path's within 1e-6 of their scale (Mamba2's gated norm takes its
    mean as a sum over d_inner there)."""
    from repro_torch.launch.serve import grow_cache
    from repro_torch.launch.train import frontend_stand_ins
    from repro_torch.models import lm
    cfg = _cfg(arch)
    plain, ctx = _tp_ctx(cfg)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=gen)
    extra = {k: v.float() for k, v in frontend_stand_ins(
        cfg, 16, 2, torch.device("cpu")).items()}
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **extra}
    with torch.no_grad():
        losses = [lm.train_loss(params, batch, cfg, c, remat=False,
                                loss_chunk=16) for c in (plain, ctx)]
        _close(losses[1], losses[0], "loss")
        outs = []
        for c in (plain, ctx):
            logits, cache = lm.prefill(params, {"tokens": toks[:, :16],
                                                **extra}, cfg, c)
            cache = grow_cache(cfg, cache, cache["pos"][0].item() + 1)
            step, _ = lm.decode_step(params, cache, toks[:, 16:], cfg, c)
            outs.append((logits, step))
        _close(outs[1][0], outs[0][0], "prefill")
        _close(outs[1][1], outs[0][1], "decode")
