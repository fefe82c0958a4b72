"""The port's copy of the HLO analyzer against the reference's.

``repro_torch.launch.hloparse.analyze`` must return the very dict of
``repro.launch.hloparse.analyze`` (equal exactly, floats included) on:

* hand-written HLO texts: every collective kind (sync and async
  ``-start`` / ``-done`` forms, iota and explicit replica groups, a
  group of one), a ``while`` with ``known_trip_count`` nesting a
  fusion with a dot, nested calls, a conditional, a custom-call;
* HLO that XLA compiles in process on one CPU device from the
  reference's smoke models: a dense prefill, a scanned train loss and
  its gradient (the layer scan's ``while``), and an ssm prefill.

``ring_traffic`` is the per-op ring model both use.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch import hloparse as jhlo  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.launch import hloparse as thlo  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


COLLECTIVES = """\
HloModule collectives

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (p0: f32[8,16], p1: bf16[4,32]) -> f32[8,16] {
  %p0 = f32[8,16]{1,0} parameter(0)
  %p1 = bf16[4,32]{1,0} parameter(1)
  %ag = f32[32,16]{1,0} all-gather(f32[8,16]{1,0} %p0), channel_id=1, replica_groups=[2,4]<=[8], dimensions={0}
  %ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p0), channel_id=2, replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %rs = f32[2,16]{1,0} reduce-scatter(f32[8,16]{1,0} %p0), channel_id=3, replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add
  %a2a = bf16[4,32]{1,0} all-to-all(bf16[4,32]{1,0} %p1), channel_id=4, replica_groups={{0,1},{2,3},{4,5},{6,7}}, dimensions={0}
  %cp = f32[8,16]{1,0} collective-permute(f32[8,16]{1,0} %p0), channel_id=5, source_target_pairs={{0,1},{1,0}}
  %ars = f32[8,16]{1,0} all-reduce-start(f32[8,16]{1,0} %p0), channel_id=6, replica_groups=[1,8]<=[8], to_apply=%add
  %ard = f32[8,16]{1,0} all-reduce-done(f32[8,16]{1,0} %ars)
  %ags = (bf16[4,32]{1,0}, bf16[16,32]{1,0}) all-gather-start(bf16[4,32]{1,0} %p1), channel_id=7, replica_groups=[2,4]<=[8], dimensions={0}
  %agd = bf16[16,32]{1,0} all-gather-done((bf16[4,32]{1,0}, bf16[16,32]{1,0}) %ags)
  %one = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p0), channel_id=8, replica_groups={{0},{1}}, to_apply=%add
  ROOT %out = f32[8,16]{1,0} add(f32[8,16]{1,0} %ar, f32[8,16]{1,0} %ard)
}
"""

LOOPS = """\
HloModule loops

%fused_dot (f0: f32[4,8], f1: f32[8,2]) -> f32[4,2] {
  %f0 = f32[4,8]{1,0} parameter(0)
  %f1 = f32[8,2]{1,0} parameter(1)
  ROOT %d = f32[4,2]{1,0} dot(f32[4,8]{1,0} %f0, f32[8,2]{1,0} %f1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%inner (i0: f32[4,8]) -> f32[4,8] {
  %i0 = f32[4,8]{1,0} parameter(0)
  %w = f32[8,8]{1,0} constant({...})
  ROOT %d2 = f32[4,8]{1,0} dot(f32[4,8]{1,0} %i0, f32[8,8]{1,0} %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%outer (o0: f32[4,8]) -> f32[4,8] {
  %o0 = f32[4,8]{1,0} parameter(0)
  %c1 = f32[4,8]{1,0} call(f32[4,8]{1,0} %o0), to_apply=%inner
  ROOT %c2 = f32[4,8]{1,0} call(f32[4,8]{1,0} %c1), to_apply=%inner
}

%body (t: (s32[], f32[4,8], f32[8,2])) -> (s32[], f32[4,8], f32[8,2]) {
  %t = (s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) %t), index=0
  %x = f32[4,8]{1,0} get-tuple-element((s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) %t), index=1
  %w = f32[8,2]{1,0} get-tuple-element((s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) %t), index=2
  %f = f32[4,2]{1,0} fusion(f32[4,8]{1,0} %x, f32[8,2]{1,0} %w), kind=kOutput, calls=%fused_dot
  %ar = f32[4,2]{1,0} all-reduce(f32[4,2]{1,0} %f), channel_id=1, replica_groups=[4,2]<=[8], to_apply=%outer
  %y = f32[4,8]{1,0} call(f32[4,8]{1,0} %x), to_apply=%outer
  %one = s32[] constant(1)
  %n = s32[] add(s32[] %i, s32[] %one)
  ROOT %r = (s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) tuple(s32[] %n, f32[4,8]{1,0} %y, f32[8,2]{1,0} %w)
}

%cond (ct: (s32[], f32[4,8], f32[8,2])) -> pred[] {
  %ct = (s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) parameter(0)
  %ci = s32[] get-tuple-element((s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) %ct), index=0
  %lim = s32[] constant(12)
  ROOT %lt = pred[] compare(s32[] %ci, s32[] %lim), direction=LT
}

%br_a (ba: f32[4,8]) -> f32[4,8] {
  %ba = f32[4,8]{1,0} parameter(0)
  ROOT %ea = f32[4,8]{1,0} exponential(f32[4,8]{1,0} %ba)
}

%br_b (bb: f32[4,8]) -> f32[4,8] {
  %bb = f32[4,8]{1,0} parameter(0)
  ROOT %cb = f32[4,8]{1,0} call(f32[4,8]{1,0} %bb), to_apply=%inner
}

ENTRY %main (a: f32[4,8], b: f32[8,2], k: s32[]) -> f32[4,8] {
  %a = f32[4,8]{1,0} parameter(0)
  %b = f32[8,2]{1,0} parameter(1)
  %k = s32[] parameter(2)
  %z = s32[] constant(0)
  %init = (s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) tuple(s32[] %z, f32[4,8]{1,0} %a, f32[8,2]{1,0} %b)
  %loop = (s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) while((s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) %init), condition=%cond, body=%body, backend_config={"known_trip_count":{"n":"12"}}
  %res = f32[4,8]{1,0} get-tuple-element((s32[], f32[4,8]{1,0}, f32[8,2]{1,0}) %loop), index=1
  %sel = f32[4,8]{1,0} conditional(s32[] %k, f32[4,8]{1,0} %res, f32[4,8]{1,0} %res), branch_computations={%br_a, %br_b}
  %cc = f32[4,8]{1,0} custom-call(f32[4,8]{1,0} %sel), custom_call_target="Sharding"
  ROOT %t = f32[4,8]{1,0} transpose(f32[4,8]{1,0} %cc), dimensions={0,1}
}
"""

NO_ENTRY = """\
%first (x: f32[2,2]) -> f32[2,2] {
  %x = f32[2,2]{1,0} parameter(0)
  ROOT %d = f32[2,2]{1,0} dot(f32[2,2]{1,0} %x, f32[2,2]{1,0} %x), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""


TEXTS = {"collectives": COLLECTIVES, "loops": LOOPS,
         "no_entry": NO_ENTRY, "empty": ""}


@pytest.mark.parametrize("name", list(TEXTS))
def test_analyze_matches_reference_on_hand_written_hlo(name):
    text = TEXTS[name]
    want = jhlo.analyze(text)
    got = thlo.analyze(text)
    assert got == want
    if name == "collectives":
        assert set(got["collectives"]) == {"all-gather", "all-reduce",
                                           "reduce-scatter", "all-to-all"}
        assert got["collectives"]["all-reduce"]["count"] == 2
    if name == "loops":
        # the while body's dots count 12 times: the fusion's, and twice
        # the two nested calls of %outer (a call, and the all-reduce's
        # reduction region); the conditional's branch call once
        inner = 2 * 4 * 8 * 8
        assert got["flops_per_device"] == 12 * (2 * 4 * 2 * 8
                                                + 2 * 2 * inner) + inner
        assert got["collectives"]["all-reduce"]["count"] == 12


def _smoke_hlo(kind):
    cfg = get_smoke_config({"prefill": "qwen3-1.7b",
                            "ssm_prefill": "mamba2-2.7b",
                            "train": "qwen3-1.7b"}[kind])
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    toks = jnp.zeros((2, 64), jnp.int32)
    ctx = jlm.NO_PARALLEL
    if kind.endswith("prefill"):
        def fn(p, t):
            return jlm.prefill(p, {"tokens": t}, cfg, ctx)
        lowered = jax.jit(fn).lower(params, toks)
    else:
        batch = {"tokens": toks, "labels": toks}
        lowered = jax.jit(jax.value_and_grad(
            lambda p: jlm.train_loss(p, batch, cfg, ctx, remat=True))
        ).lower(params)
    return lowered.compile().as_text()


@pytest.mark.parametrize("kind", ["prefill", "train", "ssm_prefill"])
def test_analyze_matches_reference_on_xla_hlo(kind):
    text = _smoke_hlo(kind)
    want = jhlo.analyze(text)
    got = thlo.analyze(text)
    assert got == want
    assert got["flops_per_device"] > 0
    if kind == "train":
        assert "while" in text and "known_trip_count" in text


@pytest.mark.parametrize("op,g", [("all-gather", 4), ("all-reduce", 8),
                                  ("reduce-scatter", 2),
                                  ("all-to-all", 16),
                                  ("collective-permute", 2)])
def test_ring_traffic_is_the_analyzers_model(op, g):
    r = 3 * 4096
    want = {"all-gather": r * (g - 1) / g, "all-reduce": 2.0 * r * (g - 1) / g,
            "reduce-scatter": r * (g - 1), "all-to-all": r * (g - 1) / g,
            "collective-permute": float(r)}[op]
    assert thlo.ring_traffic(op, r, g) == want
