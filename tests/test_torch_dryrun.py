"""The port's dry-run tooling against the reference's.

* ``launch.specs.input_specs`` equals the reference's for every arch x
  shape: each leaf's shape and dtype (the decode cache leaf by leaf), and
  the skip reasons.
* One reference subprocess on an ``Auto`` mesh of 8 CPU devices
  (``jax.sharding.Mesh`` (2, 4): ``jax.make_mesh``'s ``Explicit`` axes
  make the reference's ``with_sharding_constraint`` raise under jax
  0.9), where the reference's ``lower_cell`` runs with its config
  lookup patched to the smoke configs and small shapes (dense, moe and
  ssm x train, prefill and decode; and under ``tp_enable=False``), and
  returns ``memory_analysis().argument_size_in_bytes`` and
  ``hloparse.analyze`` of the compiled HLO; it also returns its
  ``hillclimb.VARIANTS``.  The port's ``dryrun.measure`` of the same
  cells on the port's (2, 4) mesh must give:

  - argument bytes a device equal exactly (an argument no op reads is
    dropped on both sides: XLA prunes a prefill's labels);
  - FLOPs a device within :data:`FLOP_TOL` of the reference's after the
    named differences, each computed here term by term:
    the port checkpoints each cross-entropy chunk (``models/lm.py``
    ``xent_loss``), so its head product runs once more a micro-batch
    (:func:`xent_recompute`); the reference routes a decode step's
    replicated tokens on every model shard, the port once
    (:func:`ep_replication`); what remains is the ssm block's gradient
    (JAX's VJP of its three-operand einsums against autograd of the
    port's products: 0.35 % of the ssm train cell) and nothing else.
    Under ``tp_enable=False`` the FLOPs are compared on the train cells
    only: with a replicated batch XLA still splits the products against
    data-sharded weights over the data axis, which the model's work
    split does not follow (PERF.md records the ratios);
  - the collective op kinds present or absent as the reference's HLO
    shows them, up to the named differences of :func:`kind_diffs`.

* The dry-run's FLOPs equal ``FlopCounterMode`` over the real step on
  the CPU (smoke configs of every family, on ``make_local_mesh``): the
  kernel stand-ins and the once-a-signature count change no number.
* The attention term's rules: a backward is twice its forward on the
  dense route, and a long block-wise call counts as the pairs scale a
  short one.
* ``hillclimb.VARIANTS`` equals the reference's field by field; one
  variant runs through ``run_cell`` on a smoke config; skip and error
  records, and ``main``'s exit code.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import all_arch_ids  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.models.config import shape_applicable  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.rounds import Mesh  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import hillclimb  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.parallel.sharding import ShardingPolicy  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


from _torch_threads import _one_thread  # noqa: E402,F401


ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"train_s": (64, 8, "train"), "prefill_s": (64, 4, "prefill"),
          "decode_s": (64, 4, "decode")}
ARCHS = ("qwen3-1.7b", "deepseek-moe-16b", "mamba2-2.7b")
NO_TP = {"tp_enable": False}
CELLS = [(a, s, {}) for a in ARCHS for s in SHAPES] + \
    [("qwen3-1.7b", s, NO_TP) for s in SHAPES] + \
    [("mamba2-2.7b", "train_s", NO_TP)]
MESH = (2, 4)
FLOP_TOL = 0.01     # after the named terms, of the reference's FLOPs


def _key(arch, shape, pol):
    return f"{arch}/{shape}/{json.dumps(pol, sort_keys=True)}"


# ---------------------------------------------------------------- specs

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", all_arch_ids())
def test_input_specs_match_jax(arch, shape):
    try:
        jkind, jtree = jspecs.input_specs(arch, shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tspecs.input_specs(arch, shape)
        assert str(got.value) == str(e)
        return
    tkind, ttree = tspecs.input_specs(arch, shape)
    assert tkind == jkind
    want = [(p, s, str(np.dtype(d)) if d != "bfloat16" else d)
            for p, s, d in _leaves(jtree)]
    assert list(_leaves(ttree)) == want
    if jkind == "decode":
        assert "/cache/pos" in {p for p, _, _ in want}


# ---------------------------------------------------------------- reference

REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import repro.launch.dryrun as jd
    # the reference's dry-run sets 512 devices on import; the backend is
    # not up yet, so 8 still wins
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from repro.configs import get_smoke_config
    from repro.launch import specs as jspecs
    from repro.launch.hillclimb import VARIANTS
    from repro.launch.hloparse import analyze
    from repro.models import config as jcfg
    from repro.parallel.sharding import ShardingPolicy
    spec = json.loads(sys.argv[1])
    shapes = {k: jcfg.ShapeSpec(k, *v) for k, v in spec["shapes"].items()}
    jd.get_config = jspecs.get_config = get_smoke_config
    jd.SHAPES = jspecs.SHAPES = shapes
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:8]).reshape(spec["mesh"]),
        ("data", "model"))
    out = {"cells": {}, "variants": {}}
    for arch, shape, pol in spec["cells"]:
        with mesh:
            lowered, meta = jd.lower_cell(arch, shape, mesh,
                                          policy=ShardingPolicy(**pol))
            comp = lowered.compile()
        key = arch + "/" + shape + "/" + json.dumps(pol, sort_keys=True)
        out["cells"][key] = {
            "argument_bytes": comp.memory_analysis().argument_size_in_bytes,
            "analyze": analyze(comp.as_text()), "meta": meta}
    for name, (arch, shape, policy, tcfg) in VARIANTS.items():
        out["variants"][name] = [
            arch, shape, dataclasses.asdict(policy),
            None if tcfg is None else dataclasses.asdict(tcfg)]
    json.dump(out, open(sys.argv[2], "w"))
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ref")
    spec = {"shapes": SHAPES, "cells": CELLS, "mesh": MESH}
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(spec),
                          str(d / "ref.json")], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    return json.loads((d / "ref.json").read_text())


_PORT = {}


def port(arch, shape, pol):
    """The port's count of a cell (memoized: several tests read it)."""
    key = _key(arch, shape, pol)
    if key not in _PORT:
        mesh = Mesh(dict(zip(("data", "model"), MESH)), "cpu")
        _PORT[key] = dr.measure(configs.get_smoke_config(arch),
                                ShapeSpec(shape, *SHAPES[shape]), mesh,
                                policy=ShardingPolicy(**pol))
    return _PORT[key]


def xent_recompute(arch, shape, got) -> float:
    """FLOPs a device of the head products the port's checkpointed
    cross-entropy chunks recompute (one a micro-batch): 2 x rows x S x d
    x V_padded each, over the shards that split the work."""
    cfg = configs.get_smoke_config(arch)
    seq, batch, kind = SHAPES[shape]
    if kind != "train":
        return 0.0
    split = got["count"]["shard_split"]
    return (2.0 * batch * seq * cfg.d_model * cfg.vocab_padded
            / (split["data"] * split["model"]))


def ep_replication(arch, shape, got) -> float:
    """FLOPs a device that the reference's expert-parallel decode adds by
    routing replicated tokens on every model shard: the routed work R
    (router and experts, every layer) costs R / (nb x ns) a device there,
    where nb x ns shards hold distinct tokens, and R / (D x M) in the
    port's split."""
    cfg = configs.get_smoke_config(arch)
    seq, batch, kind = SHAPES[shape]
    if cfg.family != "moe" or kind != "decode":
        return 0.0
    from repro_torch.models import moe
    d, m = MESH
    s = 1
    ctx = dr.shard.make_ctx(Mesh({"data": d, "model": m}, "cpu"), cfg)
    nb, ns, _ = moe.ep_layout((batch, s, cfg.d_model), ctx)
    t = batch * s // (nb * ns)
    cap = moe._capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    mults = 3 if cfg.ffn_type in ("swiglu", "geglu") else 2
    routed = cfg.n_layers * (
        2 * batch * s * cfg.d_model * cfg.n_experts
        + mults * 2 * cfg.n_experts * nb * ns * cap * cfg.d_model * cfg.d_ff)
    return routed * (1 / (nb * ns) - 1 / (d * m))


@pytest.mark.parametrize("arch,shape,pol", CELLS)
def test_argument_bytes_match_jax_exactly(ref, arch, shape, pol):
    want = ref["cells"][_key(arch, shape, pol)]["argument_bytes"]
    assert port(arch, shape, pol)["count"]["memory"]["argument_bytes"] \
        == want


@pytest.mark.parametrize("arch,shape,pol",
                         [c for c in CELLS if not c[2]
                          or SHAPES[c[1]][2] == "train"])
def test_flops_per_device_match_jax_up_to_named_terms(ref, arch, shape,
                                                      pol):
    r = ref["cells"][_key(arch, shape, pol)]
    want = r["analyze"]["flops_per_device"]
    got = port(arch, shape, pol)
    assert got["meta"].get("n_micro", 1) == r["meta"].get("n_micro", 1)
    named = got["count"]["flops_per_device"] \
        - xent_recompute(arch, shape, got) + ep_replication(arch, shape, got)
    assert abs(named - want) <= FLOP_TOL * want, (named, want)
    if arch != "mamba2-2.7b" or SHAPES[shape][2] != "train":
        assert named == want         # every other difference is named


def kind_diffs(arch, shape, pol):
    """(kinds only the model has, kinds only XLA's HLO has).  The
    model's FSDP gradient reduce-scatter is an all-reduce in XLA's CPU
    HLO, which holds no reduce-scatter; XLA re-lays tensors with
    all-to-alls the model does not predict (the smoke widths' heads over
    the model axis, and in training); with tensor parallelism off and a
    replicated batch, XLA splits the products of data-sharded weights
    over the data axis and sums them with an all-reduce, where the model
    gathers the weights."""
    cfg = configs.get_smoke_config(arch)
    kind = SHAPES[shape][2]
    only_model = {"reduce-scatter"} if kind == "train" else set()
    if pol.get("tp_enable", True):
        only_xla = set() if cfg.family == "moe" else {"all-to-all"}
    else:
        only_xla = {"all-to-all"} if kind == "train" else {"all-reduce"}
    return only_model, only_xla


@pytest.mark.parametrize("arch,shape,pol", CELLS)
def test_collective_kinds_match_jax_up_to_named_differences(ref, arch,
                                                            shape, pol):
    xla = set(ref["cells"][_key(arch, shape, pol)]["analyze"]["collectives"])
    got = port(arch, shape, pol)["count"]
    model = set(got["collectives"])
    assert "reduce-scatter" not in xla
    assert (model - xla, xla - model) == kind_diffs(arch, shape, pol)
    assert got["collective_traffic_per_device"] == pytest.approx(
        sum(v["traffic"] for v in got["collectives"].values()))


def test_variants_match_jax(ref):
    want = ref["variants"]
    assert list(hillclimb.VARIANTS) == list(want)
    for name, (arch, shape, policy, tcfg) in hillclimb.VARIANTS.items():
        assert [arch, shape, dataclasses.asdict(policy),
                None if tcfg is None else dataclasses.asdict(tcfg)] \
            == want[name], name


# ---------------------------------------------------------------- the count

FAMILY_CELLS = [("qwen3-1.7b", "train"), ("qwen3-1.7b", "prefill"),
                ("qwen3-1.7b", "decode"), ("deepseek-moe-16b", "train"),
                ("mamba2-2.7b", "train"), ("mamba2-2.7b", "prefill"),
                ("recurrentgemma-2b", "train"),
                ("llava-next-mistral-7b", "train"),
                ("seamless-m4t-medium", "train"),
                ("seamless-m4t-medium", "decode")]


@pytest.mark.parametrize("arch,kind", FAMILY_CELLS)
def test_count_equals_flop_counter_over_the_real_cpu_step(arch, kind):
    """The dry-run on fake tensors against ``FlopCounterMode`` over the
    same step run on real CPU tensors (its attention and SSD on their
    plain routes, inside the step)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = configs.get_smoke_config(arch)
    sh = ShapeSpec("s", 64, 2, kind)
    mesh = make_local_mesh("cpu")
    want = dr.measure(cfg, sh, mesh)["count"]
    gen = torch.Generator().manual_seed(0)
    if kind == "train":
        tcfg = dr.TRAIN_OVERRIDES.get(cfg.name, tstep.TrainConfig())
        step, _, _ = tstep.build_train_step(cfg, mesh, tcfg,
                                            global_batch=2)
        state = tstep.init_train_state(cfg, tcfg, gen, "cpu")
        batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in
                 tspecs.train_inputs(cfg, 64, 2).items()}
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
    else:
        serve, prefill, _ = tstep.build_serve_step(cfg, mesh)
        params = lm.init_params(cfg, gen, "cpu")
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            if kind == "prefill":
                prefill(params, {k: torch.zeros(s.shape, dtype=s.dtype)
                                 for k, s in tspecs.prefill_inputs(
                                     cfg, 64, 2).items()})
            else:
                serve(params, lm.init_decode_cache(cfg, 2, 64,
                                                   device="cpu"),
                      torch.zeros((2, 1), dtype=torch.int32))
    assert fc.get_total_flops() == want["flops"]
    assert want["flops"] == want["outside_flops"] + want["attention_flops"] \
        + want["ssd_flops"]
    if kind != "decode" and cfg.family != "ssm" and cfg.family != "hybrid":
        assert want["attention_flops"] > 0


def test_attention_backward_is_twice_its_forward_on_the_dense_route():
    for shapes, kw in ((((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)),
                        (("causal", True), ("window", None),
                         ("q_offset", 0))),
                       (((2, 32, 4, 16), (2, 8, 4, 16), (2, 8, 4, 16)),
                        (("causal", False), ("window", None),
                         ("q_offset", 0)))):
        c = dr._term_counts(("attention", shapes, torch.bfloat16,
                             (True, True, True), kw))
        assert c["bwd"] == tuple(2 * n for n in c["fwd"])


def test_long_blockwise_call_scales_a_short_one(monkeypatch):
    s = 3 * dr._PROXY_LEN // 2
    sig = ("attention", ((1, s, 2, 16), (1, s, 1, 16), (1, s, 1, 16)),
           torch.bfloat16, (True, True, True),
           (("causal", True), ("window", None), ("q_offset", 0)))
    assert dr._blockwise_proxy(sig) is not None
    scaled = dr._term_counts(sig)
    dr._TERM_CACHE.pop(sig)
    monkeypatch.setattr(dr, "_blockwise_proxy", lambda sig: None)
    assert dr._term_counts(sig) == scaled
    dr._TERM_CACHE.pop(sig)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 3, 8, 40])
def test_visible_pairs_closed_form_counts_every_row(causal, window):
    """K4's pair count (summed piece by piece) against a row-by-row
    count, over lengths and offsets on both sides of every kink."""
    from repro_torch.kernels.flash_attention import visible_pairs
    for sq in range(0, 20):
        for sk in range(1, 20):
            for off in range(0, 24, 3):
                rows = [max(0, (min(sk, p + 1) if causal else sk)
                            - (max(0, p - window + 1) if window else 0))
                        for p in range(off, off + sq)]
                assert visible_pairs(sq, sk, causal, off, window) == \
                    sum(rows)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b"])
def test_kernel_terms_are_the_kernels_own_counts(arch):
    """The card terms of a train step: K4's and K5's ``kernel_flops`` at
    the launches ``lm.train_launches`` says a micro-batch makes, times
    the micro-batches, and the CPU route's count beside them."""
    from repro_torch.kernels.flash_attention import kernel_flops as k4
    from repro_torch.kernels.ssd_intra import kernel_flops as k5
    cfg = configs.get_smoke_config(arch)
    sh = ShapeSpec("s", 64, 2, "train")
    c = dr.measure(cfg, sh, make_local_mesh("cpu"))["count"]
    cell, _ = dr.lower_cell(cfg, sh, make_local_mesh("cpu"))
    rec = []
    with cell.mode, dr.kernel_stand_ins(rec):
        cell.step.grads_of(cell.args["state"], cell.args["batch"], n_run=1)
    n = lm.train_launches(cfg)
    (name, _, sig), = set(r[:1] + (None,) + r[2:] for r in rec)
    if name == "attention":
        (b, sq, hq, hd), (_, sk, _, _), _ = sig[1]
        args = (b, hq, sq, sk, hd, True, None, 0)
        want = n["flash_attention"] * k4(*args) \
            + n["flash_attention_bwd"] * k4(*args, backward=True)
        term, other = "attention", "ssd"
    else:
        (b, q, _), _, (_, _, h, p) = sig[1]
        want = n["ssd_intra"] * k5(b, q, h, p) \
            + n["ssd_intra_bwd"] * k5(b, q, h, p, backward=True)
        term, other = "ssd", "attention"
    assert len(rec) == sum(n.values())
    assert c[f"{term}_kernel_flops"] == cell.n_micro * want
    assert c[f"{other}_kernel_flops"] == 0
    assert c["term_calls"][term] == cell.n_micro * len(rec)
    # the CPU route also multiplies the masked half of every block
    assert c[f"{term}_flops"] > c[f"{term}_kernel_flops"] / 2
    assert c["card_bytes_per_device"] < c["bytes_dot_per_device"]


def test_roofline_fields_and_h100_constants():
    got = dr.measure(configs.get_smoke_config("qwen3-1.7b"),
                     ShapeSpec("s", 64, 2, "train"), make_local_mesh("cpu"))
    rl, c = got["roofline"], got["count"]
    assert set(rl) >= {"t_compute_s", "t_memory_s", "t_collective_s",
                       "dominant", "model_flops", "useful_flops_ratio",
                       "roofline_fraction", "tokens_per_step"}
    # the card's step: K4 counted as the kernel does it
    assert rl["t_compute_s"] == c["card_flops_per_device"] / 989e12
    assert c["card_flops"] == c["outside_flops"] \
        + c["attention_kernel_flops"] + c["ssd_kernel_flops"]
    assert rl["t_memory_s"] == (c["card_bytes_per_device"]
                                + c["memory"]["argument_bytes"]
                                + c["memory"]["output_bytes"]) / 3.35e12
    cfg = configs.get_smoke_config("qwen3-1.7b")
    assert rl["model_flops"] == 6 * cfg.active_param_count() * 128
    assert c["collective_traffic_per_device"] == 0.0    # one shard
    assert rl["dominant"] in ("compute", "memory")
    mem = c["memory"]
    assert mem["per_device_total"] == mem["argument_bytes"] \
        + mem["temp_bytes"] and mem["fits_80GB"]


# ---------------------------------------------------------------- records

def test_a_variant_runs_through_run_cell(tmp_path, capsys, monkeypatch):
    arch, shape, policy, tcfg = hillclimb.VARIANTS["qwen_v1_notp"]
    smoke = configs.get_smoke_config(arch)
    monkeypatch.setattr(dr, "get_config", lambda name: smoke)
    monkeypatch.setattr(dr, "SHAPES", {shape: ShapeSpec(shape, 64, 512,
                                                         "train")})
    monkeypatch.setattr(hillclimb, "VARIANTS", {
        "qwen_v1_notp": (arch, shape, policy, tcfg)})
    monkeypatch.setattr(hillclimb, "RESULTS", tmp_path)
    hillclimb.main(["--cell", "qwen_v1_notp"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("qwen_v1_notp: tc=") and "dom=" in line
    rec = json.loads((tmp_path / f"{smoke.name}__{shape}__pod16x16__"
                      "qwen_v1_notp.json").read_text())
    assert rec["status"] == "ok" and rec["tag"] == "qwen_v1_notp"
    # tensor parallelism off: the model axis is data-parallel
    assert rec["meta"]["shard_split"] == {"data": 256, "model": 1}
    assert "tp_all_reduce" not in rec["count_analysis"]["by_term"]


def test_skip_and_error_records(tmp_path, monkeypatch):
    rec = dr.run_cell("llama3-405b", "long_500k", False, tmp_path)
    ok, why = shape_applicable(jspecs.get_config("llama3-405b"),
                               "long_500k")
    assert rec["status"] == "skipped" and rec["reason"] == why and not ok
    smoke = configs.get_smoke_config("mamba2-2.7b")
    monkeypatch.setattr(dr, "get_config", lambda name: smoke)
    # 40 positions are no whole number of the ssm's 32-position chunks
    monkeypatch.setattr(dr, "SHAPES", {"bad": ShapeSpec("bad", 40, 2,
                                                         "prefill")})
    with pytest.raises(SystemExit) as e:
        dr.main(["--arch", "mamba2-2.7b", "--shape", "bad", "--mesh", "pod",
                 "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "mamba2-2.7b__bad__pod16x16.json")
                     .read_text())
    assert rec["status"] == "error" and "AssertionError" in rec["error"]
    assert "ssd_chunked" in rec["traceback"]
    # a record already there is read back without --force
    again = dr.run_cell("mamba2-2.7b", "bad", False, tmp_path)
    assert again == rec
