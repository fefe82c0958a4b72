"""The port's sharded LM stack against the JAX package's.

* The specs, in process, with no devices (the reference's spec rules
  read only ``mesh.shape`` and ``mesh.axis_names``): ``param_specs``,
  ``cache_specs``, ``batch_specs``, ``state_specs`` (fp32 and int8 m
  and v) and the guarded activation spec of every ``constrain`` kind
  equal JAX's as tuples, for every arch's full config (shapes only:
  ``jax.eval_shape`` there, fake tensors here), on the meshes (16, 16),
  (2, 16, 16), (4, 2), (3, 2) and (1, 1), under the default policy,
  ``tp_enable=False`` and ``replicate_embed=True``; ``make_ctx``'s axes
  and EP degree; ``resolve_micro`` over a grid of batches and meshes.
* Against the reference run in one subprocess on an ``Auto`` mesh of 8
  CPU devices (``jax.sharding.Mesh``: ``jax.make_mesh``'s ``Explicit``
  axes make ``with_sharding_constraint`` raise under jax 0.9), its
  outputs written once to an ``.npz``: expert-parallel ``moe_ffn`` on
  (2, 4), (1, 4) and (4, 2) for the deepseek and dbrx smoke configs in
  fp32 (and in bf16 on (1, 4)), keep masks, experts and slots equal
  shard by shard;
  the moe smoke model in fp32 on (2, 4): prefill and decode logits and
  one train step's loss and gradients; the elastic chain of
  ``tests/test_elastic_e2e.py`` (train on (4, 2), checkpoint, plan,
  remesh to (3, 2), restore with the new shardings, two more steps).
* In process: ``make_local_mesh()`` leaves a smoke serve and a 3-step
  train bit for bit what the port computes with no mesh; a replicated
  axis computed once equals the replicated run; gradients reach every
  leaf through the expert exchange; the meshes, specs and placements
  refuse what JAX refuses.
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import all_arch_ids  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.parallel import sharding as jshard  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch import tree as pt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.rounds import Mesh  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.specs import train_inputs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel import sharding as tshard  # noqa: E402
from repro_torch.runtime import FailureDetector, plan_elastic_mesh  # noqa
from repro_torch.train import step as tstep  # noqa: E402

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (4, 2): ("data", "model"), (3, 2): ("data", "model"),
          (1, 1): ("data", "model")}
POLICIES = {"default": {}, "no_tp": {"tp_enable": False},
            "replicate_embed": {"replicate_embed": True}}
KINDS = ("resid", "resid_decode", "ffn_in", "ffn_out", "attn_q", "attn_kv",
         "attn_out", "logits", "ssd_L", "no_such_kind")
EP_MESHES = ((2, 4), (1, 4), (4, 2))
MOE_ARCHS = ("deepseek-moe-16b", "dbrx-132b")
# tokens [B, S] of the EP cases: both axes sharded, and a decode-like
# step replicated along the model axis (and along data on (4, 2)); the
# replicated layout does not depend on the dtype, so it runs in fp32
EP_SHAPES = {"prefill": (4, 16), "decode": (2, 1)}
EP_CASES = [("prefill", "float32"), ("prefill", "bfloat16"),
            ("decode", "float32")]
# the fp32 cases hold masks, experts and slots on every mesh; bf16 adds
# its rounding, which the mesh does not change, so it runs on one
EP_MESHES_OF = {"float32": EP_MESHES, "bfloat16": ((1, 4),)}


class StubMesh:
    """What the reference's spec rules read of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


from _torch_threads import _one_thread  # noqa: E402,F401


def _meshes():
    for shape, axes in MESHES.items():
        yield shape, StubMesh(shape, axes), Mesh(dict(zip(axes, shape)),
                                                 "cpu")


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for x in node:
                walk(x)
        else:
            assert isinstance(node, tshard.P), node
            out.append(tuple(node))
    walk(tree)
    return out


def _tcfgs():
    return {"fp32": ({}, {}),
            "int8": ({"m_dtype": "int8", "v_mode": "int8"},
                     {"m_dtype": "int8", "v_mode": "int8"})}


_SHAPES = {}


def _shapes(arch, state):
    """(JAX's eval_shape, the port's fake tensors) of the full config's
    train state under the ``state`` tiers; cached per arch."""
    key = (arch, state)
    if key not in _SHAPES:
        jo, to = _tcfgs()[state]
        jt = jstep.TrainConfig(opt=JAdamWConfig(**jo))
        tt = tstep.TrainConfig(opt=AdamWConfig(**to))
        js = jax.eval_shape(lambda: jstep.init_train_state(
            jax.random.PRNGKey(0), jax_config(arch), jt))
        ts = tstep.state_shapes(configs.get_config(arch), tt)
        _SHAPES[key] = (js, ts, jt, tt)
    return _SHAPES[key]


@pytest.mark.parametrize("arch", all_arch_ids())
def test_param_specs_match_jax(arch):
    js, ts, _, _ = _shapes(arch, "fp32")
    for shape, jm, tm in _meshes():
        for name, kw in POLICIES.items():
            want = _jax_specs(jshard.param_specs(
                jm, js["params"], jshard.ShardingPolicy(**kw)))
            got = _port_specs(tshard.param_specs(
                tm, ts["params"], tshard.ShardingPolicy(**kw)))
            assert got == want, (shape, name)


@pytest.mark.parametrize("state", ["fp32", "int8"])
@pytest.mark.parametrize("arch", all_arch_ids())
def test_state_specs_match_jax(arch, state):
    js, ts, jt, tt = _shapes(arch, state)
    assert [tuple(x.shape) for x in pt.leaves(ts)] == \
        [tuple(x.shape) for x in jax.tree.leaves(js)]
    for shape, jm, tm in _meshes():
        for name, kw in POLICIES.items():
            want = _jax_specs(jstep.state_specs(
                jm, js, jt, jshard.ShardingPolicy(**kw)))
            got = _port_specs(tstep.state_specs(
                tm, ts, tt, tshard.ShardingPolicy(**kw)))
            assert got == want, (shape, name)


@pytest.mark.parametrize("arch", all_arch_ids())
def test_cache_and_batch_specs_match_jax(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    jcfg, tcfg = jax_config(arch), configs.get_config(arch)
    for b, s in ((1, 128), (32, 4096)):
        jc = jax.eval_shape(lambda: jlm.init_decode_cache(jcfg, b, s))
        with FakeTensorMode():
            tc = tlm.init_decode_cache(tcfg, b, s, device="cpu")
        seq = s + (jcfg.n_patches if jcfg.family == "vlm" else 0)
        jb = jspecs.train_inputs(jcfg, seq, b)
        tb = train_inputs(tcfg, seq, b)
        for shape, jm, tm in _meshes():
            for name, kw in POLICIES.items():
                jp, tp = (jshard.ShardingPolicy(**kw),
                          tshard.ShardingPolicy(**kw))
                assert _port_specs(tshard.cache_specs(tm, tc, tp)) == \
                    _jax_specs(jshard.cache_specs(jm, jc, jp)), \
                    (b, s, shape, name)
                assert _port_specs(tshard.batch_specs(tm, tb, tp)) == \
                    _jax_specs(jshard.batch_specs(jm, jb, jp)), \
                    (b, s, shape, name)


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_constrain_specs_and_ctx_match_jax(family, monkeypatch):
    """Every kind's guarded spec at shapes that divide and shapes that do
    not, and ranks the rule does not fit: what the reference hands
    ``with_sharding_constraint`` (recorded), the port's
    ``activation_spec``; the port's context returns the tensor itself.
    ``make_ctx``'s axes and EP degree equal JAX's."""
    seen = []
    monkeypatch.setattr(jshard, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda t, spec: seen.append(tuple(spec)) or t)
    arch = "deepseek-moe-16b" if family == "moe" else "qwen3-1.7b"
    jcfg, tcfg = jax_config(arch), configs.get_config(arch)
    shapes = [(b, s, w) for b in (1, 6, 32) for s in (1, 48, 512)
              for w in (16, 2048)] + [(32, 512, 16, 128), (3, 7, 5, 5),
                                      (32, 64, 1, 16, 256), (4,)]
    for shape, jm, tm in _meshes():
        for name, kw in POLICIES.items():
            jctx = jshard.make_ctx(jm, jcfg, jshard.ShardingPolicy(**kw))
            tpol = tshard.ShardingPolicy(**kw)
            tctx = tshard.make_ctx(tm, tcfg, tpol)
            assert (tctx.dp_axis, tctx.tp_axis, tctx.ep, tctx.ep_axis) == \
                (jctx.dp_axis, jctx.tp_axis, jctx.ep, jctx.ep_axis), \
                (shape, name)
            for kind in KINDS:
                for sh in shapes:
                    seen.clear()
                    jctx.c(jax.ShapeDtypeStruct(sh, jnp.float32), kind)
                    got = tshard.activation_spec(tm, tpol, kind, sh)
                    assert (tuple(got) if got is not None else None) == \
                        (seen[0] if seen else None), (shape, name, kind, sh)
    t = torch.zeros((4, 16, 8))
    view = t[:, ::2]                             # not contiguous
    tctx = tshard.make_ctx(Mesh({"data": 2, "model": 4}, "cpu"), tcfg)
    assert tctx.c(view, "resid") is view and tctx.c(t, "attn_q") is t


@pytest.mark.parametrize("shape", list(MESHES))
def test_resolve_micro_matches_jax(shape):
    jm, tm = StubMesh(shape, MESHES[shape]), Mesh(
        dict(zip(MESHES[shape], shape)), "cpu")
    for kw in POLICIES.values():
        for micro in (None, 3):
            jt = jstep.TrainConfig(micro_batches=micro)
            tt = tstep.TrainConfig(micro_batches=micro)
            for batch in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 256,
                          512, 1000):
                assert tstep.resolve_micro(
                    tt, tm, batch, tshard.ShardingPolicy(**kw)) == \
                    jstep.resolve_micro(jt, jm, batch,
                                        jshard.ShardingPolicy(**kw)), \
                    (shape, kw, micro, batch)


def test_meshes_keep_the_reference_axes_and_errors():
    prod = tmesh.make_production_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16} and prod.n_shards == 256
    assert prod.axis_names == ("data", "model")
    pod = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    local = tmesh.make_local_mesh("cpu")
    assert local.shape == {"data": 1, "model": 1} and local.n_shards == 1
    ids = [0, 1, 4, 5, 6, 7, 2, 3]
    m = tmesh.make_mesh_from_devices(ids, data=3, model=2, device="cpu")
    assert m.shape == {"data": 3, "model": 2}
    np.testing.assert_array_equal(m.devices, [[0, 1], [4, 5], [6, 7]])
    assert m != tmesh.make_mesh_from_devices(list(range(6)), data=3,
                                             model=2, device="cpu")
    m3 = tmesh.make_mesh_from_devices(list(range(8)), data=2, model=2,
                                      pod=2, device="cpu")
    assert m3.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="need 8 devices, have 6"):
        tmesh.make_mesh_from_devices(list(range(6)), data=4, model=2,
                                     device="cpu")
    # the sharded plane's one-axis mesh is unchanged
    assert Mesh(4, device="cpu").axis_names == ("shards",)
    assert repr(Mesh(4, device="cpu")) == "Mesh(4, device='cpu')"
    assert Mesh(4, device="cpu") == Mesh(4, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        Mesh({"data": 0}, device="cpu")
    assert tshard.P(("data",), None) == ("data", None)
    assert tshard.P(("pod", "data"), "model") == (("pod", "data"), "model")


def test_placement_refuses_a_spec_that_does_not_divide(tmp_path):
    """``device_put`` and ``restore(shardings=)`` refuse a spec that does
    not divide its leaf, as JAX's placement does; a fitting one places
    each leaf on the mesh's device."""
    mesh = Mesh({"data": 3, "model": 2}, "cpu")
    tree = {"a": torch.arange(12.).reshape(6, 2), "b": torch.zeros(4)}
    ok = tshard.to_named(mesh, {"a": tshard.P("data", "model"),
                                "b": tshard.P("model")})
    put = tshard.device_put(tree, ok)
    assert put["a"] is tree["a"]
    bad = tshard.to_named(mesh, {"a": tshard.P("data", "model"),
                                 "b": tshard.P("data")})
    with pytest.raises(ValueError, match="does not divide"):
        tshard.device_put(tree, bad)
    mgr = CheckpointManager(tmp_path, async_=False)
    mgr.save(tree, 0)
    got, step = mgr.restore(tree, shardings=ok)
    assert step == 0 and torch.equal(got["a"], tree["a"])
    with pytest.raises(ValueError, match="does not divide"):
        mgr.restore(tree, shardings=bad)


# ------------------------------------------- the reference, once, 8 devices

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import get_smoke_config
    from repro.models import lm, moe
    from repro.parallel.sharding import make_ctx

    out_path, ckpt_dir = sys.argv[1], sys.argv[2]
    spec = __SPEC__
    out = {}

    def keep_params(prefix, params):
        # bf16 as its uint16 bits, which convert.lm_params_to_torch reads
        for path, v in jax.tree_util.tree_leaves_with_path(params):
            v = np.asarray(v)
            out[prefix + "/".join(k.key for k in path)] = (
                v.view(np.uint16) if v.dtype == jnp.bfloat16 else v)

    def mesh_of(shape):
        devs = np.array(jax.devices()[:int(np.prod(shape))])
        return Mesh(devs.reshape(shape), ("data", "model"))

    def routes(x, router, cfg, ctx):
        # the reference's shard_map split of moe_ffn (its b_ax and s_ax
        # rule), each shard's _dispatch as _moe_local calls it
        mesh, axis, n, dp = ctx.mesh, ctx.ep_axis, ctx.ep, ctx.dp_axis
        b_ax = dp if x.shape[0] % mesh.shape[dp] == 0 else None
        s_ax = axis if x.shape[1] % n == 0 else None

        def body(x_l, r):
            b_l, s_l, d = x_l.shape
            t = b_l * s_l
            xt = x_l.reshape(t, d)
            cap = moe._capacity(t, cfg.top_k, cfg.n_experts,
                                cfg.capacity_factor)
            logits = xt.astype(jnp.float32) @ r.astype(jnp.float32)
            _, (_, e, s, _, keep), _ = moe._dispatch(
                xt, logits, cfg.top_k, cfg.n_experts, cap)
            return e[None], s[None], keep[None]
        every = P(tuple(mesh.axis_names))
        return shard_map(body, mesh=mesh, in_specs=(P(b_ax, s_ax, None), P()),
                         out_specs=(every,) * 3, check_vma=False)(x, router)

    # ---- expert-parallel moe_ffn: one program a (arch, mesh) for every
    # case (a compile costs more than the cases' arithmetic)
    for arch in spec["moe_archs"]:
        cfg = get_smoke_config(arch)
        ps, xs = {}, {}
        for dt in ("float32", "bfloat16"):
            jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
            ps[dt] = moe.init_moe(jax.random.PRNGKey(1), cfg, jdt)
            for k, v in ps[dt].items():
                out[f"moe/{arch}/{dt}/p/{k}"] = np.asarray(v, np.float32)
            rng = np.random.default_rng(5)
            common = 3.0 * rng.normal(size=(cfg.d_model,))
            for tag, (b, s) in spec["ep_shapes"].items():
                x = jnp.asarray(rng.normal(size=(b, s, cfg.d_model))
                                + common, jdt)
                if [tag, dt] in spec["ep_cases"]:
                    xs[(tag, dt)] = x
                    out[f"moe/{arch}/{dt}/{tag}/x"] = np.asarray(
                        x, np.float32)
        for shape in spec["ep_meshes"]:
            ctx = make_ctx(mesh_of(tuple(shape)), cfg)
            cases = [c for c in sorted(xs)
                     if shape in spec["meshes_of"][c[1]]]

            def every(xs, ps):
                return [moe.moe_ffn(x, ps[dt], cfg, ctx)
                        + routes(x, ps[dt]["router"], cfg, ctx)
                        for (tag, dt), x in zip(cases, xs)]
            res = jax.jit(every)([xs[c] for c in cases], ps)
            for (tag, dt), (y, aux, e, sl, keep) in zip(cases, res):
                key = f"moe/{arch}/{dt}/{tag}/{shape[0]}x{shape[1]}"
                out[key + "/y"] = np.asarray(y, np.float32)
                out[key + "/aux"] = np.asarray(aux)
                out[key + "/e"] = np.asarray(e)
                out[key + "/s"] = np.asarray(sl)
                out[key + "/keep"] = np.asarray(keep)

    # ---- the moe smoke model in fp32 on (2, 4)
    cfg = get_smoke_config("deepseek-moe-16b").replace(dtype="float32")
    ctx = make_ctx(mesh_of((2, 4)), cfg)
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    keep_params("model/params/", params)
    rng = np.random.default_rng(11)
    b, s, n_dec = 4, 16, 2
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (n_dec, b, 1)).astype(np.int32)
    out["model/toks"], out["model/dec"] = toks, dec
    logits, cache = jax.jit(lambda p, t: lm.prefill(p, {"tokens": t}, cfg,
                                                    ctx))(
        params, jnp.asarray(toks[:, :-1]))
    out["model/prefill"] = np.asarray(logits)
    full = lm.init_decode_cache(cfg, b, s + n_dec)
    for k in cache:
        if k != "pos":
            full[k] = full[k].at[tuple(slice(0, n) for n in
                                       cache[k].shape)].set(cache[k])
        else:
            full[k] = cache[k]
    step = jax.jit(lambda p, c, t: lm.decode_step(p, c, t, cfg, ctx))
    for i in range(n_dec):
        logits, full = step(params, full, jnp.asarray(dec[i]))
        out[f"model/decode{i}"] = np.asarray(logits)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: lm.train_loss(p, batch, cfg, ctx, remat=False,
                                loss_chunk=16)))(params)
    out["model/loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"model/grad{i}"] = np.asarray(g)

    # ---- the elastic chain of tests/test_elastic_e2e.py, its losses kept
    from repro.checkpoint import CheckpointManager
    from repro.data import DataConfig, SyntheticLM
    from repro.launch.mesh import make_mesh_from_devices
    from repro.optim import AdamWConfig
    from repro.runtime import FailureDetector, plan_elastic_mesh
    from repro.train import TrainConfig, build_train_step, init_train_state
    from repro.train.step import state_specs
    cfg = get_smoke_config("qwen3-1.7b")
    tcfg = TrainConfig(remat=False, opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                                    total_steps=10))
    devices = jax.devices()

    def named(mesh, specs):
        return jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                            specs, is_leaf=lambda x: isinstance(x, P))

    losses = []
    mesh = make_mesh_from_devices(devices, data=4, model=2)
    step_fn, _, n1 = build_train_step(cfg, mesh, tcfg, global_batch=8)
    state = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    keep_params("elastic/params/", state["params"])
    sspecs = state_specs(mesh, jax.eval_shape(lambda: state), tcfg)
    state = jax.device_put(state, named(mesh, sspecs))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=8, seq_len=64))
    jit_step = jax.jit(step_fn, donate_argnums=(0,))
    with mesh:
        for i in range(3):
            bt = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
            state, m = jit_step(state, bt)
            losses.append(float(m["loss"]))
    mgr = CheckpointManager(ckpt_dir, keep=2)
    mgr.save(state, 2)
    mgr.wait()
    fd = FailureDetector(["h0", "h1", "h2", "h3"], suspect_after=1,
                         dead_after=2)
    fd.last_beat["h1"] -= 100
    assert fd.sweep()[2] == ["h1"]
    plan = plan_elastic_mesh(4, 2, dead_hosts=["h1"],
                             host_of_device=lambda d, m: f"h{d}")
    surv = [d for i, d in enumerate(devices[:8]) if i // 2 != 1][:6]
    mesh2 = make_mesh_from_devices(surv, data=plan.new_data_size, model=2)
    sspecs2 = state_specs(mesh2, jax.eval_shape(lambda: state), tcfg)
    state2, at = mgr.restore(jax.eval_shape(lambda: state),
                             shardings=named(mesh2, sspecs2))
    step_fn2, _, n2 = build_train_step(cfg, mesh2, tcfg, global_batch=6)
    jit2 = jax.jit(step_fn2, donate_argnums=(0,))
    data2 = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=6, seq_len=64))
    with mesh2:
        for i in range(3, 5):
            bt = {k: jnp.asarray(v) for k, v in data2.batch_at(i).items()}
            state2, m = jit2(state2, bt)
            losses.append(float(m["loss"]))
    out["elastic/losses"] = np.asarray(losses)
    out["elastic/n_micro"] = np.asarray([n1, n2, at])
    np.savez(out_path, **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_ref")
    spec = {"moe_archs": list(MOE_ARCHS), "ep_shapes": EP_SHAPES,
            "ep_cases": [list(c) for c in EP_CASES],
            "ep_meshes": [list(m) for m in EP_MESHES],
            "meshes_of": {dt: [list(m) for m in ms]
                          for dt, ms in EP_MESHES_OF.items()}}
    code = REFERENCE.replace("__SPEC__", json.dumps(spec))
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code, str(d / "ref.npz"),
                          str(d / "ckpt")], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    return dict(np.load(d / "ref.npz"))


def _moe_inputs(ref, arch, dt):
    tcfg = configs.get_smoke_config(arch).replace(dtype=dt)
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    pre = f"moe/{arch}/{dt}/p/"
    p = {k[len(pre):]: torch.from_numpy(v).to(tdt if k[len(pre):] !=
                                               "router" else torch.float32)
         for k, v in ref.items() if k.startswith(pre)}
    return tcfg, tdt, p


@pytest.mark.parametrize("tag,dt", EP_CASES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_moe_ffn_matches_jax(ref, arch, dt, tag):
    """Each mesh's EP ``moe_ffn`` against the reference's ``shard_map``:
    keep masks, experts and slots equal shard by shard (a shard
    replicated along an axis against the port's one computation of
    it), the output within 1e-5 (fp32) or 2e-2 of the output's scale
    (bf16: the tokens share a large common direction, and the bf16 sum
    of routed and shared experts rounds at that scale; the flat path
    differs from JAX's by 0.125 at scale 28 on these tokens), aux within
    1e-5 relative; some assignment drops."""
    tcfg, tdt, p = _moe_inputs(ref, arch, dt)
    x = torch.from_numpy(ref[f"moe/{arch}/{dt}/{tag}/x"]).to(tdt)
    routed = {k: v for k, v in p.items() if not k.startswith("s_")}
    drops = 0
    for shape in EP_MESHES_OF[dt]:
        key = f"moe/{arch}/{dt}/{tag}/{shape[0]}x{shape[1]}"
        ctx = tshard.make_ctx(Mesh({"data": shape[0], "model": shape[1]},
                                   "cpu"), tcfg)
        assert ctx.ep == shape[1]
        y, aux = tmoe.moe_ffn(x, p, tcfg, ctx)
        _, _, route = tmoe._moe_ep(x, routed, tcfg, ctx)
        nb, ns, n = tmoe.ep_layout(x.shape, ctx)
        for r in range(shape[0] * shape[1]):
            i, j = divmod(r, shape[1])
            g = (i if nb > 1 else 0) * ns + (j if ns > 1 else 0)
            for name, got in (("e", route[1]), ("s", route[2]),
                              ("keep", route[4])):
                np.testing.assert_array_equal(
                    got[g].numpy(), ref[f"{key}/{name}"][r],
                    err_msg=f"{shape} shard {r} {name}")
        drops += int((~ref[f"{key}/keep"]).sum())
        want = ref[f"{key}/y"]
        err = np.abs(_np(y) - want)
        if dt == "bfloat16":
            assert err.max() < 2e-2 * np.abs(want).max(), shape
        else:
            assert err.max() < 1e-5, shape
        assert float(aux) == pytest.approx(float(ref[f"{key}/aux"]),
                                           rel=1e-5), shape
    if tag == "prefill":
        assert drops > 0


def test_replicated_axis_computed_once_equals_the_replicated_run():
    """Tokens replicated along the model axis (S not a multiple of ep)
    are routed once; the reference routes them on every model shard.
    Laying the same tokens out as ep copies along a sharded sequence
    axis makes the port run the replicated computation itself: every
    copy's output and the aux equal the once-computed ones bit for
    bit.  The same holds along the data axis."""
    tcfg = configs.get_smoke_config("deepseek-moe-16b").replace(
        dtype="float32")
    p = tmoe.init_moe(torch.Generator().manual_seed(2), tcfg, torch.float32)
    gen = torch.Generator().manual_seed(3)
    ctx = tshard.make_ctx(Mesh({"data": 2, "model": 4}, "cpu"), tcfg)
    x = torch.randn((4, 1, tcfg.d_model), generator=gen) \
        + 3.0 * torch.randn((tcfg.d_model,), generator=gen)
    y, aux = tmoe.moe_ffn(x, p, tcfg, ctx)
    assert tmoe.ep_layout(x.shape, ctx) == (2, 1, 4)
    rep = x.expand(4, 4, tcfg.d_model).contiguous()   # S 4: one copy a shard
    assert tmoe.ep_layout(rep.shape, ctx) == (2, 4, 4)
    y_rep, aux_rep = tmoe.moe_ffn(rep, p, tcfg, ctx)
    for j in range(4):
        assert torch.equal(y_rep[:, j], y[:, 0])
    assert torch.equal(aux_rep, aux)
    # along data: B 3 on 2 data rows replicates; two copies of the batch
    x3 = torch.randn((3, 4, tcfg.d_model), generator=gen)
    y3, aux3 = tmoe.moe_ffn(x3, p, tcfg, ctx)
    assert tmoe.ep_layout(x3.shape, ctx) == (1, 4, 4)
    y6, aux6 = tmoe.moe_ffn(torch.cat([x3, x3]), p, tcfg, ctx)
    assert tmoe.ep_layout(y6.shape, ctx) == (2, 4, 4)
    assert torch.equal(y6[:3], y3) and torch.equal(y6[3:], y3)
    assert torch.equal(aux6, aux3)


def test_expert_exchange_carries_every_gradient():
    """``value_and_grad`` of a loss through EP ``moe_ffn`` (the index
    moves of both exchanges included) reaches every leaf."""
    tcfg = configs.get_smoke_config("dbrx-132b").replace(dtype="float32")
    p = tmoe.init_moe(torch.Generator().manual_seed(4), tcfg, torch.float32)
    ctx = tshard.make_ctx(Mesh({"data": 2, "model": 4}, "cpu"), tcfg)
    x = torch.randn((4, 8, tcfg.d_model),
                    generator=torch.Generator().manual_seed(5))

    def loss(p, x):
        y, aux = tmoe.moe_ffn(x, p, tcfg, ctx)
        return y.square().mean() + aux
    _, grads, missing = tstep.value_and_grad(loss, p, x)
    assert missing == 0
    assert all(float(g.abs().sum()) > 0 for g in pt.leaves(grads))


def _ref_params(ref, prefix):
    """The reference's initial parameters, kept in its ``.npz``."""
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = v
    return convert.lm_params_to_torch(tree, "cpu")


def _moe_model(ref):
    tcfg = configs.get_smoke_config("deepseek-moe-16b").replace(
        dtype="float32")
    return tcfg, _ref_params(ref, "model/params/")


def test_moe_model_prefill_and_decode_match_jax_on_2x4(ref):
    """The fp32 moe smoke model served on (2, 4): prefill and two decode
    steps' logits within 1e-4 of their scale (``test_torch_lm``'s fp32
    tolerance)."""
    tcfg, tparams = _moe_model(ref)
    step, prefill, ctx = tstep.build_serve_step(
        tcfg, Mesh({"data": 2, "model": 4}, "cpu"))
    assert ctx.ep == 4
    toks, dec = ref["model/toks"], ref["model/dec"]
    logits, cache = prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :-1]).long()})
    cache = tserve.grow_cache(tcfg, cache, toks.shape[1] - 1 + len(dec))
    for name, got in [("prefill", logits)] + [
            (f"decode{i}", None) for i in range(len(dec))]:
        if got is None:
            i = int(name[-1])
            got, cache = step(tparams, cache, torch.from_numpy(dec[i]).long())
        want = ref[f"model/{name}"]
        scale = float(np.abs(want).max())
        assert np.abs(_np(got) - want).max() < 1e-4 * scale, name


def test_moe_model_train_step_matches_jax_on_2x4(ref):
    """One train step's loss (1e-5 relative) and every gradient leaf
    (2e-4 of its largest magnitude + 1e-6, ``test_torch_train``'s fp32
    tolerances) on (2, 4); no leaf misses its gradient."""
    tcfg, tparams = _moe_model(ref)
    ctx = tshard.make_ctx(Mesh({"data": 2, "model": 4}, "cpu"), tcfg)
    toks = ref["model/toks"]
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()}
    loss, grads, missing = tstep.value_and_grad(
        lambda p, b: tlm.train_loss(p, b, tcfg, ctx, remat=False,
                                    loss_chunk=16), tparams, batch)
    assert missing == 0
    want = float(ref["model/loss"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    got = pt.leaves(grads)
    assert len(got) == sum(k.startswith("model/grad") for k in ref)
    for i, g in enumerate(got):
        w = ref[f"model/grad{i}"]
        err = float(np.abs(_np(g) - w).max())
        assert err <= 2e-4 * float(np.abs(w).max()) + 1e-6, (i, err)


def test_elastic_chain_matches_jax(ref, tmp_path):
    """``tests/test_elastic_e2e.py``'s chain in the port from JAX's
    initial parameters: three steps on (4, 2) (2 micro-batches of 4),
    an async checkpoint, the failure detector's verdict and the elastic
    plan, a remesh over the surviving shard ids to (3, 2), ``restore``
    with the new mesh's shardings and two more steps at batch 6: every
    loss within rtol 2e-2 of the JAX chain's."""
    cfg = configs.get_smoke_config("qwen3-1.7b")
    tcfg = tstep.TrainConfig(remat=False, opt=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=10))
    params = _ref_params(ref, "elastic/params/")
    state = {"params": params, "opt": adamw_init(params, tcfg.opt)}
    shard_ids = list(range(8))
    mesh = tmesh.make_mesh_from_devices(shard_ids, data=4, model=2,
                                        device="cpu")
    step_fn, _, n1 = tstep.build_train_step(cfg, mesh, tcfg,
                                            global_batch=8)
    state = tshard.device_put(state, tshard.to_named(
        mesh, tstep.state_specs(mesh, state, tcfg)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=8, seq_len=64))
    losses = []
    for i in range(3):
        state, m = step_fn(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    mgr.save(state, 2)
    mgr.wait()
    fd = FailureDetector(["h0", "h1", "h2", "h3"], suspect_after=1,
                         dead_after=2)
    fd.last_beat["h1"] -= 100
    assert fd.sweep()[2] == ["h1"]
    plan = plan_elastic_mesh(4, 2, dead_hosts=["h1"],
                             host_of_device=lambda d, m: f"h{d}")
    assert plan.new_data_size == 3 and plan.lost_rows == [1]
    surv = [d for i, d in enumerate(shard_ids) if i // 2 != 1][:6]
    mesh2 = tmesh.make_mesh_from_devices(surv, data=3, model=2,
                                         device="cpu")
    shapes = tstep.state_shapes(cfg, tcfg)
    state2, at = mgr.restore(shapes, shardings=tshard.to_named(
        mesh2, tstep.state_specs(mesh2, shapes, tcfg)))
    step_fn2, _, n2 = tstep.build_train_step(cfg, mesh2, tcfg,
                                             global_batch=6)
    data2 = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=6, seq_len=64))
    for i in range(3, 5):
        state2, m = step_fn2(state2, data2.batch_at(i))
        losses.append(float(m["loss"]))
    assert [n1, n2, at] == ref["elastic/n_micro"].tolist()
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref["elastic/losses"], rtol=2e-2)


def _patched_ctx(monkeypatch):
    """The port before the mesh: every context ``NO_PARALLEL``."""
    monkeypatch.setattr(tshard, "make_ctx",
                        lambda mesh, cfg, policy=None: tlm.NO_PARALLEL)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-1.7b"])
def test_local_mesh_serves_bit_for_bit(arch, monkeypatch):
    """A smoke serve (prefill, grown cache, 4 decode steps) through
    ``build_serve_step`` on ``make_local_mesh()`` gives the logits and
    cache of the port with no mesh, bit for bit."""
    cfg = configs.get_smoke_config(arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))

    def run():
        step, prefill, _ = tstep.build_serve_step(
            cfg, tmesh.make_local_mesh("cpu"))
        out = []
        logits, cache = prefill(params, {"tokens": toks})
        cache = tserve.grow_cache(cfg, cache, 20)
        out.append(logits)
        nxt = logits.argmax(-1)[:, None]
        for _ in range(4):
            logits, cache = step(params, cache, nxt)
            out.append(logits)
            nxt = logits.argmax(-1)[:, None]
        return out + [cache["k"], cache["v"]]
    got = run()
    with monkeypatch.context() as mp:
        _patched_ctx(mp)
        want = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-1.7b"])
def test_local_mesh_trains_bit_for_bit(arch, monkeypatch):
    """Three train steps (two micro-batches, remat) on
    ``make_local_mesh()`` give the losses and every state leaf of the
    port with no mesh, bit for bit."""
    cfg = configs.get_smoke_config(arch)
    tcfg = tstep.TrainConfig(micro_batches=2, opt=AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=3))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=2, seq_len=8))

    def run():
        step, _, _ = tstep.build_train_step(
            cfg, tmesh.make_local_mesh("cpu"), tcfg, global_batch=2)
        state = tstep.init_train_state(
            cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
        losses = []
        for i in range(3):
            state, m = step(state, data.batch_at(i))
            losses.append(m["loss"])
        return losses + pt.leaves(state)
    got = run()
    with monkeypatch.context() as mp:
        _patched_ctx(mp)
        want = run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_drivers_run_the_production_mesh_on_the_cpu():
    """``--production-mesh`` at a smoke config: the serve's (16, 16) mesh
    and its tokens, on the CPU."""
    res = tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                       "--production-mesh", "--requests", "2",
                       "--prompt-len", "16", "--gen", "2"])
    assert res["mesh"] == {"data": 16, "model": 16} and res["ep"] == 1
    assert res["tokens"] == 4 and res["finite"]
