"""Dry-run: count every (arch x shape x mesh) cell's step on fake tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The port's counterpart of ``repro.launch.dryrun``.  The reference lowers
and compiles each cell for 512 fake CPU devices and reads XLA's memory
analysis and HLO; the port has no compiler to ask, so it runs the step
it would run, on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage), and counts what that step does.  Nothing is allocated and no
card is needed: the dry-run takes no ``--device`` and runs anywhere.

Per cell (``lower_cell`` builds it, ``count_cell`` counts it):

* **The step.**  The port's own builders on the reference's mesh
  (``launch.mesh.make_production_mesh``): ``build_train_step`` with the
  train state of ``state_shapes`` and its ``state_specs`` and the batch's
  ``batch_specs``, or ``build_serve_step`` with ``param_specs`` and
  ``cache_specs``; :data:`TRAIN_OVERRIDES` as in the reference.  Fake
  tensors live on the CPU, so every op takes the CPU route, the
  reference's own decomposition: ``models/attention.py`` picks dense or
  blockwise attention at the reference's thresholds, and SSD runs
  ``ssd_intra_plain``.  The step computes every shard's work on one
  device, as the port's mesh does.
* **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode`` over
  the step, backward and ``torch.utils.checkpoint``'s recompute
  included.  A train step loops its micro-batches in Python: one
  micro-batch's loss and gradient is counted and multiplied by
  ``n_micro``, and the update added once (hloparse's trip-count
  multiplication).  Attention and the SSD intra-chunk product, the two
  places where the card runs kernels K4 and K5, are counted apart
  (``attention_flops``, ``ssd_flops``): the step calls a stand-in there
  that allocates and saves what the card's kernel allocates and saves,
  and each distinct call (shapes, mask, direction) is counted twice,
  and multiplied by its calls: once through the CPU route under
  ``FlopCounterMode``, the products the reference's HLO holds (the
  score blocks of every visited block pair, the plain SSD einsum over
  the whole chunk), and once as the card's kernel does it
  (``attention_kernel_flops``, ``ssd_kernel_flops``: K4's and K5's own
  ``kernel_flops``, over the visible pairs and the causal triangle).
  ``outside_flops`` is everything else, the very products that
  ``FlopCounterMode`` sees on the card.  ``flops`` is outside + the CPU
  route's terms, ``card_flops`` outside + the kernels'.
  ``flops_per_device`` (and ``card_flops_per_device``) is the
  step's count over the shards that split its work: the data axes where
  they divide the batch, the model axis where tensor parallelism is on
  (``shard_split``); a mesh axis that splits nothing replicates the
  work, and the record says so (``replication``).
* **Bytes.**  ``argument_bytes`` and ``output_bytes`` a device are exact:
  each leaf's bytes over the product of the mesh axes its spec shards
  it along.  ``bytes_dot_per_device`` is the operand and result bytes of
  every counted product (a ``TorchDispatchMode`` beside the FLOP
  counter), split as the FLOPs are, attention and SSD on the CPU route;
  ``card_bytes_per_device`` takes K4's and K5's instead as each input
  read once and each output written once (the kernels keep their
  scores and probabilities on chip).  The peak is a fake-tensor memory
  count: every storage the step makes is added when an op returns it
  and taken away when it dies; ``temp_bytes`` is the peak above the
  arguments, split over ``shard_split`` (a model), and
  ``per_device_total`` = argument + temp bytes, held against the H100's
  80 GB (``fits_80GB``).
* **Collective bytes** are a model: the port has no HLO.  Per op kind,
  under hloparse's ring formulas (:func:`hloparse.ring_traffic`: for R
  the result's bytes a device and g the group, all-gather R(g-1)/g,
  all-reduce 2R(g-1)/g, reduce-scatter R(g-1), all-to-all R(g-1)/g),
  from the policy and the specs, with D and M the data and model axes'
  sizes, B the rows a device, S the positions and d the width:

  - FSDP all-gather: each parameter leaf sharded along ``data`` is
    gathered over D before use, R = its bytes over its other axes;
    once a serve step, once a micro-batch's forward and once more for
    its recompute under remat.
  - Gradient reduction (train): each leaf's gradient (the parameter's
    dtype) is reduce-scattered over D where its spec holds ``data``, a
    micro-batch at a time (ZeRO-3's order), R = its shard; what the
    batch's other data-parallel axes (the pod, and the model axis when
    ``tp_enable=False``) share is then all-reduced once a step over
    them; a leaf not sharded along ``data`` is all-reduced over every
    data-parallel axis once a step.
  - Tensor-parallel all-reduce (``tp_enable`` and M > 1): each
    row-parallel output, [B, S, d] in the model's dtype, over M: two a
    dense, vlm or encoder layer (attention, FFN), three a decoder layer
    of the encdec family (self, cross, FFN), attention plus the shared
    experts' FFN a moe layer, one an ssm layer, two a hybrid layer; and
    the vocab-parallel embedding's lookup once a forward.  A train pass
    runs them three times (forward, recompute, backward; twice without
    remat); the vocab-parallel cross-entropy adds two [B, S] fp32
    reductions a forward pass (max, sum) and the head input's fp32
    gradient once; a serve step all-gathers its [B, V] fp32 logits.
  - Expert-parallel all-to-all (moe, EP > 1): two a layer and pass
    (dispatch, return), R = the shard's [E, C, d] slot buffer
    (``models/moe.py:_moe_ep``), three passes a train micro-batch.
  - Decode KV sequence-shard reductions (the cache's position axis
    sharded over M by ``cache_specs``): a gather of the step's [B, Hq,
    hd] queries and an all-reduce of the fp32 partial outputs [B, Hq,
    hd] and softmax statistics 2 x [B, Hq], each attention layer.

  Every link is priced at NVLink 4's rate, a lower bound where a mesh
  spans hosts.
* **Roofline** of the step the card runs (``card_flops_per_device``;
  ``card_bytes_per_device`` + argument + output bytes; the collective
  model) at H100 SXM constants: bf16 dense 989e12 FLOP/s
  (:data:`PEAK_FLOPS`), HBM3 3.35e12 B/s (:data:`HBM_BW`), NVLink 4
  450e9 B/s a direction a GPU (:data:`LINK_BW`); the reference's fields
  (``t_compute_s``, ``t_memory_s``, ``t_collective_s``, ``dominant``,
  ``model_flops`` = 6 (train) or 2 x ``cfg.active_param_count()`` x
  tokens, ``useful_flops_ratio``, ``roofline_fraction``,
  ``tokens_per_step``).  No TPU constant and no correction of XLA's
  bf16 promotion carry over: the port counts its real dtypes.

Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
(git-ignored); a cell already there is read back unless ``--force``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import inspect
import json
import math
import time
import traceback
import weakref
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import tree as pt
from ..configs import all_arch_ids, get_config
from ..kernels.flash_attention import bwd_buffers as k4_bwd_buffers
from ..kernels.flash_attention import fwd_buffers as k4_fwd_buffers
from ..kernels.flash_attention import kernel_flops as k4_flops
from ..kernels.ssd_intra import bwd_buffers as k5_bwd_buffers
from ..kernels.ssd_intra import kernel_flops as k5_flops
from ..kernels.ssd_intra import ssd_intra_plain
from ..models import attention as attn_mod
from ..models import lm, moe, ssm
from ..models.config import SHAPES, LMConfig, ShapeSpec, shape_applicable
from ..optim import AdamWConfig
from ..parallel import sharding as shard
from ..train import step as train_step_mod
from ..train.step import TrainConfig
from . import specs as ispecs
from .hloparse import ring_traffic
from .mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 B/s
LINK_BW = 450e9              # NVLink 4, B/s a direction a GPU
HBM_BYTES = 80e9             # H100 80GB

# per-arch training overrides: memory tiering for the big ones, as the
# reference's
TRAIN_OVERRIDES = {
    "llama3-405b": TrainConfig(
        opt=AdamWConfig(m_dtype="bfloat16", v_mode="int8"),
        accum_dtype="bfloat16"),
    "command-r-plus-104b": TrainConfig(
        opt=AdamWConfig(m_dtype="float32", v_mode="int8")),
    "dbrx-132b": TrainConfig(
        opt=AdamWConfig(m_dtype="float32", v_mode="int8")),
}


# ------------------------------------------------------------ counting

def _nbytes(t) -> int:
    return math.prod(t.shape) * t.dtype.itemsize


class _Tally(torch.utils._python_dispatch.TorchDispatchMode):
    """Operand and result bytes of every product ``FlopCounterMode``
    counts, the bytes of the live storages (the peak kept) and the
    storages some op read."""

    def __init__(self):
        super().__init__()
        self.dot_bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self.read = WeakIdKeyDictionary()

    def track(self, tree) -> None:
        for t in pt.leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)

    def _add(self, t) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pt.leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in pt.leaves((args, kwargs or {}))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            self.read[t.untyped_storage()] = True
        if func.overloadpacket in _FLOP_OPS:
            self.dot_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._add(t)
        return out


def _flop_ops():
    from torch.utils.flop_counter import flop_registry
    return frozenset(flop_registry)


_FLOP_OPS = _flop_ops()


@contextlib.contextmanager
def _counting():
    """(FlopCounterMode, _Tally) over the block."""
    from torch.utils.flop_counter import FlopCounterMode
    tally = _Tally()
    with FlopCounterMode(display=False) as fc, tally:
        yield fc, tally


# ------------------------------------------------------------ stand-ins

_TERM_CACHE: dict = {}
_CPU_ROUTE = {"attention": attn_mod.attention, "ssd": ssd_intra_plain}

# attention's CPU route is dense up to this many positions, block-wise
# beyond, over blocks of these sizes (``models/attention.py:attention``)
_ATTN_DEFAULTS = {k: v.default for k, v in inspect.signature(
    attn_mod.attention).parameters.items()}
DENSE_THRESHOLD = _ATTN_DEFAULTS["dense_threshold"]
_BLOCK_Q, _BLOCK_K = _ATTN_DEFAULTS["block_q"], _ATTN_DEFAULTS["block_k"]
_PROXY_LEN = 2 * DENSE_THRESHOLD       # the shortest block-wise call used


def _pairs(sig) -> int:
    """Block pairs the CPU route's block-wise attention visits."""
    (qs, ks, _), kw = sig[1], dict(sig[4])
    return len(attn_mod._block_pairs(
        qs[1] // _BLOCK_Q, ks[1] // _BLOCK_K, _BLOCK_Q, _BLOCK_K,
        kw["causal"], kw["window"], kw["q_offset"]))


def _blockwise_proxy(sig):
    """A shorter self-attention call with the same blocks whose count
    scales to ``sig``'s, or None where ``sig`` is counted directly."""
    name, shapes, dtype, grads, kw = sig
    if name != "attention":
        return None
    (qs, ks, _), opts = shapes, dict(kw)
    s = qs[1]
    if ks[1] != s or opts["q_offset"] or s <= _PROXY_LEN or s % _BLOCK_K:
        return None
    short = tuple(sh[:1] + (_PROXY_LEN,) + sh[2:] for sh in shapes)
    return (name, short, dtype, grads, kw)


def _term_counts(sig) -> dict:
    """{"fwd"/"bwd": (flops, dot bytes)} of one kernel call through the
    CPU route, on fresh fake tensors (memoized by signature).  The
    backward is autograd's, except where the CPU route is block-wise
    attention, whose in-place accumulators autograd cannot differentiate:
    there it is twice the forward's products (the gradient of a product
    is two products of its size, which is what autograd counts on the
    dense route)."""
    if sig in _TERM_CACHE:
        return _TERM_CACHE[sig]
    from torch._subclasses.fake_tensor import FakeTensorMode
    name, shapes, dtype, grads, kw = sig
    small = _blockwise_proxy(sig)
    if small is not None:
        # every visited block pair costs the same products: count a
        # shorter call with the same blocks, scaled by the pairs
        ratio = _pairs(sig) / _pairs(small)
        out = {d: tuple(round(n * ratio) for n in v)
               for d, v in _term_counts(small).items()}
        _TERM_CACHE[sig] = out
        return out
    out = {}
    with FakeTensorMode():
        xs = [torch.empty(s, dtype=dtype).requires_grad_(g)
              for s, g in zip(shapes, grads)]
        with torch.enable_grad(), _counting() as (fc, tally):
            y = _CPU_ROUTE[name](*xs, **dict(kw))
        out["fwd"] = (fc.get_total_flops(), tally.dot_bytes)
        blockwise = name == "attention" and \
            max(shapes[0][1], shapes[1][1]) > DENSE_THRESHOLD
        if any(grads) and blockwise:
            out["bwd"] = tuple(2 * n for n in out["fwd"])
        elif any(grads):
            need = [x for x in xs if x.requires_grad]
            with _counting() as (fc, tally):
                torch.autograd.grad(y, need, torch.empty_like(y))
            out["bwd"] = (fc.get_total_flops(), tally.dot_bytes)
    _TERM_CACHE[sig] = out
    return out


def _heads_first(*ts):
    """The model's [B, S, H, hd] tensors as K4's [B, H, S, hd] views."""
    return tuple(t.transpose(1, 2) for t in ts)


class _AttentionStandIn(torch.autograd.Function):
    """K4 where the card runs it: allocates and saves what
    ``kernels.flash_attention._FlashAttentionFn`` does, through the
    kernel module's own ``fwd_buffers`` and ``bwd_buffers``, and records
    the call.  Takes and returns K4's [B, H, S, hd] views."""

    @staticmethod
    def forward(ctx, q, k, v, rec, sig):
        rec.append(("attention", "fwd", sig))
        out, lse = k4_fwd_buffers(q, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.rec, ctx.sig = rec, sig
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _, _ = ctx.saved_tensors
        ctx.rec.append(("attention", "bwd", ctx.sig))
        dq, dk, dv, delta = k4_bwd_buffers(q, k, v)
        del delta
        return dq, dk, dv, None, None


class _SsdStandIn(torch.autograd.Function):
    """K5 where the card runs it: allocates and saves what
    ``kernels.ssd_intra._SsdIntraFn`` does (the output; in the backward
    the kernel module's ``bwd_buffers``) and records the call."""

    @staticmethod
    def forward(ctx, cb, cs, win, rec, sig):
        rec.append(("ssd", "fwd", sig))
        out = torch.empty_like(win)
        ctx.save_for_backward(cb, cs, win, out)
        ctx.rec, ctx.sig = rec, sig
        return out

    @staticmethod
    def backward(ctx, dy):
        cb, cs, win, _ = ctx.saved_tensors
        ctx.rec.append(("ssd", "bwd", ctx.sig))
        dcb, dcs, dwin, part = k5_bwd_buffers(cb, cs, win)
        del part
        return dcb, dcs, dwin, None, None


def _grad_flags(ts):
    return tuple(bool(torch.is_grad_enabled() and t.requires_grad)
                 for t in ts)


@contextlib.contextmanager
def kernel_stand_ins(rec: list):
    """The model's two kernel call sites (``attention`` in
    ``models/lm.py``, ``ssd_intra`` in ``models/ssm.py``) routed to the
    stand-ins for the block, each call appended to ``rec`` as (term,
    direction, signature)."""
    def attention(q, k, v, causal=True, window=None, q_offset=0):
        grads = _grad_flags((q, k, v))
        sig = ("attention", (tuple(q.shape), tuple(k.shape),
                             tuple(v.shape)), q.dtype, grads,
               (("causal", causal), ("window", window),
                ("q_offset", q_offset)))
        if any(grads):
            out = _AttentionStandIn.apply(*_heads_first(q, k, v), rec, sig)
        else:
            rec.append(("attention", "fwd", sig))
            out = k4_fwd_buffers(*_heads_first(q), False)[0]
        return out.transpose(1, 2)

    def ssd_intra(cb, cs, win):
        grads = _grad_flags((cb, cs, win))
        sig = ("ssd", (tuple(cb.shape), tuple(cs.shape), tuple(win.shape)),
               win.dtype, grads, ())
        if any(grads):
            return _SsdStandIn.apply(cb, cs, win, rec, sig)
        rec.append(("ssd", "fwd", sig))
        return torch.empty_like(win)

    real = lm.attention, ssm.ssd_intra
    lm.attention, ssm.ssd_intra = attention, ssd_intra
    try:
        yield
    finally:
        lm.attention, ssm.ssd_intra = real


def kernel_counts(sig, direction) -> tuple:
    """(operations, bytes) of the card's kernel for one stand-in call:
    K4's or K5's own ``kernel_flops``, and each input read once and each
    output written once (the kernels keep scores, probabilities and the
    decay matrix on chip)."""
    name, shapes, dtype, grads, kw = sig
    bwd = direction == "bwd"
    if name == "attention":
        (b, sq, hq, hd), (_, sk, hkv, _), _ = shapes
        opts = dict(kw)
        flops = k4_flops(b, hq, sq, sk, hd, opts["causal"], opts["window"],
                         opts["q_offset"], backward=bwd)
        qb, kb = b * sq * hq * hd * dtype.itemsize, \
            b * sk * hkv * hd * dtype.itemsize
        lse = b * hq * sq * 4
        # forward: q, k, v in, the output (and, where a gradient
        # follows, the log-sum-exp) out; backward: q, k, v, the output,
        # its gradient and the log-sum-exp in, dq, dk, dv out
        nbytes = 4 * qb + 4 * kb + lse if bwd else \
            2 * qb + 2 * kb + (lse if any(grads) else 0)
        return flops, nbytes
    (b, q, _), _, (_, _, h, p) = shapes
    cb, cs, win = (math.prod(s) * dtype.itemsize for s in shapes)
    # forward: cb, cs, win in, the output out; backward: cb, cs, win, the
    # output and its gradient in, dcb, dcs, dwin out
    nbytes = 2 * cb + 2 * cs + 4 * win if bwd else cb + cs + 2 * win
    return k5_flops(b, q, h, p, backward=bwd), nbytes


def term_counts(calls) -> dict:
    """{"attention"/"ssd": {"flops", "dot_bytes", "kernel_flops",
    "kernel_bytes", "calls"}} of a list of stand-in calls: each
    signature counted once through the CPU route (what the reference's
    HLO holds) and by the card's kernel (:func:`kernel_counts`)."""
    keys = ("flops", "dot_bytes", "kernel_flops", "kernel_bytes", "calls")
    out = {n: dict.fromkeys(keys, 0) for n in ("attention", "ssd")}
    for (name, direction, sig), n in collections.Counter(calls).items():
        got = (*_term_counts(sig)[direction], *kernel_counts(sig, direction),
               1)
        for k, v in zip(keys, got):
            out[name][k] += n * v
    return out


# ------------------------------------------------------------ cells

def _shard_factor(mesh, spec) -> int:
    return math.prod(shard._axis_size(mesh, ax) for ax in spec)


def spec_bytes(mesh, tree, specs, keep=None) -> int:
    """Bytes a device of ``tree``'s tensor leaves laid out by ``specs``
    (those ``keep(leaf)`` accepts, when given): each leaf's bytes over
    the product of its sharded axes' sizes."""
    return sum(_nbytes(t) // _shard_factor(mesh, sp)
               for _, t, sp in _leaves_with_specs(tree, specs)
               if isinstance(t, torch.Tensor) and (keep is None or keep(t)))


def _leaves_with_specs(tree, specs) -> list:
    """(key, leaf, spec) of every leaf of ``tree`` (a spec is a leaf of
    ``specs``, though a tuple)."""
    out = []
    shard._map(lambda key, t, sp: out.append((key, t, sp)), tree, specs)
    return out


@dataclass
class Cell:
    """One (arch x shape x mesh) cell, built on fake tensors."""
    cfg: LMConfig
    shape: ShapeSpec
    mesh: object
    policy: shard.ShardingPolicy
    kind: str
    mode: object                 # the FakeTensorMode the tensors live in
    args: dict                   # name -> fake tensor tree
    arg_specs: dict              # name -> spec tree
    n_micro: int = 1
    tcfg: TrainConfig = None
    step: object = None
    ctx: object = None


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _cfg(arch) -> LMConfig:
    return get_config(arch) if isinstance(arch, str) else arch


def _batch_fakes(structs):
    return {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in
            structs.items()}


def lower_cell(arch_or_cfg, shape, mesh, policy=None,
               tcfg: TrainConfig | None = None) -> tuple:
    """Returns (cell, meta): the cell's step built with the port's
    builders on ``mesh``, its arguments as fake tensors.  ``arch_or_cfg``
    is an arch name or an :class:`LMConfig`, ``shape`` a name of
    :data:`SHAPES` or a :class:`ShapeSpec`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = _cfg(arch_or_cfg)
    sh = _shape(shape)
    policy = policy or shard.ShardingPolicy()
    ok, why = shape_applicable(cfg, sh.name)
    if not ok:
        raise ValueError(f"{cfg.name} x {sh.name} skipped: {why}")
    kind = sh.kind
    mode = FakeTensorMode()
    gen = torch.Generator(device="cpu")
    meta = {"kind": kind}
    if kind == "train":
        tcfg = tcfg or TRAIN_OVERRIDES.get(cfg.name, TrainConfig())
        step_fn, ctx, n_micro = train_step_mod.build_train_step(
            cfg, mesh, tcfg, policy, global_batch=sh.global_batch)
        with mode:
            state = train_step_mod.init_train_state(cfg, tcfg, gen, "cpu")
            batch = _batch_fakes(ispecs.train_inputs(cfg, sh.seq_len,
                                                     sh.global_batch))
        sspecs = train_step_mod.state_specs(mesh, state, tcfg, policy)
        bspecs = shard.batch_specs(mesh, batch, policy)
        cell = Cell(cfg, sh, mesh, policy, kind, mode,
                    {"state": state, "batch": batch},
                    {"state": sspecs, "batch": bspecs}, n_micro=n_micro,
                    tcfg=tcfg, step=step_fn, ctx=ctx)
        meta["n_micro"] = n_micro
        return cell, meta
    serve_fn, prefill_fn, ctx = train_step_mod.build_serve_step(cfg, mesh,
                                                                policy)
    with mode:
        params = lm.init_params(cfg, gen, "cpu")
        if kind == "prefill":
            inputs = {"batch": _batch_fakes(ispecs.prefill_inputs(
                cfg, sh.seq_len, sh.global_batch))}
        else:
            inputs = {"cache": lm.init_decode_cache(
                cfg, sh.global_batch, sh.seq_len, device="cpu"),
                "tokens": torch.zeros((sh.global_batch, 1),
                                      dtype=torch.int32)}
    specs = {"params": shard.param_specs(mesh, params, policy)}
    if kind == "prefill":
        specs["batch"] = shard.batch_specs(mesh, inputs["batch"], policy)
    else:
        specs["cache"] = shard.cache_specs(mesh, inputs["cache"], policy)
        specs["tokens"] = shard.batch_specs(
            mesh, {"t": inputs["tokens"]}, policy)["t"]
    cell = Cell(cfg, sh, mesh, policy, kind, mode,
                dict(params=params, **inputs), specs,
                step=prefill_fn if kind == "prefill" else serve_fn, ctx=ctx)
    return cell, meta


def _run(cell: Cell) -> dict:
    """The cell's step under the counters: FLOPs, dot bytes, the memory
    peak and the stand-ins' calls, by phase (a train step: one
    micro-batch, then the update)."""
    # checkpoint imports torch._dynamo on its first call, and that import
    # leaves a reference cycle holding the calling frames (and so the
    # step's activations) until the cyclic collector runs: import it here
    import torch._dynamo  # noqa: F401
    rec = []
    phases = {}
    with cell.mode, kernel_stand_ins(rec), _counting() as (fc, tally):
        tally.track(cell.args)
        base = tally.live
        marks = []

        def mark(name):
            marks.append((name, fc.get_total_flops(), tally.dot_bytes,
                          len(rec)))

        mark("start")
        if cell.kind == "train":
            state = cell.args["state"]
            loss, grads, missing = cell.step.grads_of(
                state, cell.args["batch"], n_run=1)
            mark("micro")
            new_state, _ = cell.step.apply_grads(state, grads, loss, missing)
            del grads, new_state
            mark("update")
            outs = ()
        else:
            with torch.no_grad():
                if cell.kind == "prefill":
                    outs = cell.step(cell.args["params"],
                                     cell.args["batch"])
                else:
                    outs = cell.step(cell.args["params"],
                                     cell.args["cache"],
                                     cell.args["tokens"])
            mark("step")
        peak = tally.peak
    for (_, f0, b0, c0), (name, f1, b1, c1) in zip(marks, marks[1:]):
        terms = term_counts(rec[c0:c1])
        phases[name] = {"outside_flops": f1 - f0,
                        "outside_dot_bytes": b1 - b0, "terms": terms}
    return {"phases": phases, "peak_bytes": peak, "arg_bytes": base,
            "outs": outs, "read": tally.read}


def _work_split(cell: Cell) -> tuple:
    """(data shards, model shards) that split the step's work: the data
    axes where the batch spec shards the (micro-)batch's rows, the model
    axis where tensor parallelism is on."""
    mesh = cell.mesh
    rows = cell.shape.global_batch // cell.n_micro
    dp_axes, tp = shard._axes(mesh, cell.policy)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    d_split = dp if rows % dp == 0 else 1
    m_split = mesh.shape[tp] if tp and tp in mesh.axis_names else 1
    return d_split, m_split


def _out_specs(cell: Cell, outs):
    """Specs of a serve step's outputs: the logits' rows as the batch's,
    the cache by ``cache_specs``."""
    logits, cache = outs
    return ({"logits": logits, "cache": cache},
            {"logits": shard.batch_specs(cell.mesh, {"l": logits},
                                         cell.policy)["l"],
             "cache": shard.cache_specs(cell.mesh, cache, cell.policy)})


# ------------------------------------------------------------ collectives

def collective_model(cell: Cell) -> dict:
    """Per-device bytes of the collectives the cell's step would run
    across cards, by op kind and by term (the module docstring derives
    each term); a model, not a measurement."""
    cfg, mesh, policy = cell.cfg, cell.mesh, cell.policy
    size = dict(mesh.shape)
    D = size.get("data", 1)
    dp_axes, tp = shard._axes(mesh, policy)
    M = size[tp] if tp else 1
    kinds = collections.defaultdict(lambda: {"count": 0, "traffic": 0.0})
    terms = collections.defaultdict(float)

    def add(term, op, r_bytes, g, count=1):
        if g <= 1 or count <= 0:
            return
        t = ring_traffic(op, r_bytes, g) * count
        kinds[op]["count"] += count
        kinds[op]["traffic"] += t
        terms[term] += t

    d_split, m_split = _work_split(cell)
    rows = cell.shape.global_batch // cell.n_micro // d_split
    act = 2 if cfg.dtype == "bfloat16" else 4
    kind = cell.kind
    if kind == "train":
        params = cell.args["state"]["params"]
        pspecs = cell.arg_specs["state"]["params"]
        s = cell.shape.seq_len
    else:
        params = cell.args["params"]
        pspecs = cell.arg_specs["params"]
        s = cell.shape.seq_len if kind == "prefill" else 1
    remat = kind == "train" and cell.tcfg.remat
    passes = (3 if remat else 2) if kind == "train" else 1
    n_micro = cell.n_micro

    # FSDP gathers and the gradient reduction
    for _, leaf, spec in _leaves_with_specs(params, pspecs):
        axes = [a for ax in spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        full = _nbytes(leaf)
        if "data" in axes and D > 1:
            other = math.prod(size[a] for a in axes if a != "data")
            uses = n_micro * (2 if remat else 1) if kind == "train" else 1
            add("fsdp_all_gather", "all-gather", full / other, D, uses)
        if kind != "train" or d_split == 1:
            continue
        shard_bytes = full / _shard_factor(mesh, spec)
        red = [a for a in dp_axes if a not in axes]
        if "data" in axes and D > 1:
            add("grad_reduce_scatter", "reduce-scatter", shard_bytes, D,
                n_micro)
        g = math.prod(size[a] for a in red)
        add("grad_all_reduce", "all-reduce", shard_bytes, g)

    # tensor parallelism
    if tp and M > 1:
        per_layer = {"dense": 2, "vlm": 2, "ssm": 1,
                     "moe": 1 + (1 if cfg.n_shared_experts else 0)}
        if cfg.family == "hybrid":
            n_ar = 2 * cfg.n_layers
        elif cfg.family == "encdec":
            n_ar = 3 * cfg.n_layers
        else:
            n_ar = per_layer[cfg.family] * cfg.n_layers
        resid = rows * s * cfg.d_model * act
        emb = _shard_factor(mesh, pspecs["embed"][:1]) > 1
        count = (n_ar + (1 if emb else 0)) * passes * \
            (n_micro if kind == "train" else 1)
        add("tp_all_reduce", "all-reduce", resid, M, count)
        if cfg.family == "encdec":
            se = max(1, s // cfg.enc_ratio) if kind != "decode" else 0
            add("tp_all_reduce", "all-reduce",
                rows * se * cfg.d_model * act, M,
                2 * cfg.n_enc_layers * passes
                * (n_micro if kind == "train" else 1))
        head = pspecs.get("head", pspecs["embed"])
        vocab_tp = any(ax == tp for ax in head)
        if vocab_tp and kind == "train":
            fwd = 2 if remat else 1
            add("tp_all_reduce", "all-reduce", rows * s * 4, M,
                2 * fwd * n_micro)
            add("tp_all_reduce", "all-reduce", rows * s * cfg.d_model * 4,
                M, n_micro)
        elif vocab_tp:
            add("logits_all_gather", "all-gather",
                rows * cfg.vocab_padded * 4, M)

    # expert parallelism
    if cfg.family == "moe" and cell.ctx.ep > 1:
        n = cell.ctx.ep
        b_rows = cell.shape.global_batch // n_micro
        nb, ns, _ = moe.ep_layout((b_rows, s, cfg.d_model), cell.ctx)
        t = (b_rows // nb) * (s // ns)
        cap = moe._capacity(t, cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor)
        r = cfg.n_experts * cap * cfg.d_model * act
        add("ep_all_to_all", "all-to-all", r, n,
            2 * cfg.n_layers * passes * (n_micro if kind == "train" else 1))

    # decode: the cache's position axis sharded over the model axis
    if kind == "decode" and tp and M > 1 and "k" in cell.arg_specs["cache"]:
        kspec = cell.arg_specs["cache"]["k"]
        if len(kspec) > 2 and kspec[2] == tp:
            n_attn = cfg.n_layers if cfg.family != "hybrid" else sum(
                cfg.pattern_at(i) == "a" for i in range(cfg.n_layers))
            qb = rows * cfg.n_heads * cfg.hd
            add("kv_seq", "all-gather", qb * act, M, n_attn)
            add("kv_seq", "all-reduce", qb * 4, M, n_attn)
            add("kv_seq", "all-reduce", 2 * rows * cfg.n_heads * 4, M,
                n_attn)

    return {"collectives": {k: dict(v) for k, v in kinds.items()},
            "by_term": dict(terms),
            "collective_traffic_per_device": sum(terms.values())}


# ------------------------------------------------------------ the count

def count_cell(cell: Cell) -> dict:
    """Counts one built cell: FLOPs, bytes, memory and the collective
    model, per device (see the module docstring).  ``flops`` and
    ``bytes_dot_per_device`` hold attention and SSD as the CPU route
    computes them (the reference's HLO does the same); the ``card_*``
    counts hold them as K4 and K5 do (:func:`kernel_counts`), and the
    roofline reads those."""
    res = _run(cell)
    phases = res["phases"]
    mult = {"micro": cell.n_micro}
    outside = outside_dot = 0
    terms = {t: collections.Counter() for t in ("attention", "ssd")}
    for name, ph in phases.items():
        m = mult.get(name, 1)
        outside += m * ph["outside_flops"]
        outside_dot += m * ph["outside_dot_bytes"]
        for t, c in terms.items():
            c.update({k: m * v for k, v in ph["terms"][t].items()})
    attn, ssd = terms["attention"], terms["ssd"]
    total = outside + attn["flops"] + ssd["flops"]
    dot = outside_dot + attn["dot_bytes"] + ssd["dot_bytes"]
    card = outside + attn["kernel_flops"] + ssd["kernel_flops"]
    card_bytes = outside_dot + attn["kernel_bytes"] + ssd["kernel_bytes"]
    d_split, m_split = _work_split(cell)
    split = d_split * m_split
    n_shards = math.prod(cell.mesh.shape.values())

    mesh = cell.mesh
    # the arguments some op reads: jit drops an unread one (keep_unused)
    arg_bytes = sum(spec_bytes(mesh, cell.args[k], cell.arg_specs[k],
                               keep=lambda t: t.untyped_storage()
                               in res["read"])
                    for k in cell.args)
    if cell.kind == "train":
        out_bytes = spec_bytes(mesh, cell.args["state"],
                               cell.arg_specs["state"])
        alias = out_bytes
    else:
        outs, ospecs = _out_specs(cell, res["outs"])
        out_bytes = spec_bytes(mesh, outs, ospecs)
        alias = spec_bytes(mesh, cell.args["cache"],
                           cell.arg_specs["cache"]) \
            if cell.kind == "decode" else 0
    temp = (res["peak_bytes"] - res["arg_bytes"]) / split
    per_dev = arg_bytes + temp
    coll = collective_model(cell)
    return {
        "flops": total, "outside_flops": outside,
        "attention_flops": attn["flops"], "ssd_flops": ssd["flops"],
        "term_calls": {"attention": attn["calls"], "ssd": ssd["calls"]},
        "flops_per_device": total / split,
        "bytes_dot_per_device": dot / split,
        "attention_kernel_flops": attn["kernel_flops"],
        "ssd_kernel_flops": ssd["kernel_flops"], "card_flops": card,
        "card_flops_per_device": card / split,
        "card_bytes_per_device": card_bytes / split,
        "shard_split": {"data": d_split, "model": m_split},
        "replication": n_shards / split,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": temp, "alias_bytes": alias,
                   "per_device_total": per_dev,
                   "fits_80GB": bool(per_dev < HBM_BYTES),
                   "peak_bytes_one_device": res["peak_bytes"],
                   "arg_bytes_one_device": res["arg_bytes"]},
        **coll,
        "phases": {k: {"outside_flops": v["outside_flops"],
                       "attention_flops": v["terms"]["attention"]["flops"],
                       "ssd_flops": v["terms"]["ssd"]["flops"],
                       "attention_kernel_flops":
                       v["terms"]["attention"]["kernel_flops"],
                       "ssd_kernel_flops": v["terms"]["ssd"]["kernel_flops"]}
                   for k, v in phases.items()},
    }


def roofline(cfg, shape, count: dict, n_chips: int, kind: str) -> dict:
    """The reference's roofline fields at H100 SXM constants, of the step
    the card runs: its products outside the kernels and K4's and K5's own
    operations and bytes (``card_flops_per_device``,
    ``card_bytes_per_device``), plus the arguments read and the outputs
    written."""
    sh = _shape(shape)
    f = count["card_flops_per_device"]
    mem = count["memory"]
    b = count["card_bytes_per_device"] + mem["argument_bytes"] \
        + mem["output_bytes"]
    c = count["collective_traffic_per_device"]
    t_compute = f / PEAK_FLOPS
    t_mem = b / HBM_BW
    t_coll = c / LINK_BW
    tokens = sh.global_batch * (sh.seq_len if kind in ("train", "prefill")
                                else 1)
    mult = 6 if kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    per_chip = model_flops / n_chips
    dominant = max((("compute", t_compute), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_mem, t_coll)
    return {"t_compute_s": t_compute, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "dominant": dominant,
            "bound_s": bound, "model_flops": model_flops,
            "useful_flops_ratio": per_chip / f if f else 0.0,
            "roofline_fraction": (per_chip / PEAK_FLOPS) / bound
            if bound else 0.0,
            "tokens_per_step": tokens}


def measure(arch_or_cfg, shape, mesh, policy=None, tcfg=None) -> dict:
    """``lower_cell`` then ``count_cell`` and the roofline: the record's
    numbers for one cell on ``mesh``."""
    cell, meta = lower_cell(arch_or_cfg, shape, mesh, policy=policy,
                            tcfg=tcfg)
    count = count_cell(cell)
    n_chips = math.prod(mesh.shape.values())
    rl = roofline(cell.cfg, cell.shape, count, n_chips, cell.kind)
    return {"meta": meta, "count": count, "roofline": rl}


def run_cell(arch, shape_name, multi_pod: bool, out_dir: Path,
             force: bool = False, tag: str = "", policy=None,
             tcfg=None) -> dict:
    """One cell on ``make_production_mesh(multi_pod=)``, its record
    written to ``out_dir`` (read back if there unless ``force``);
    ``arch`` a name or an :class:`LMConfig`, ``shape_name`` a name or a
    :class:`ShapeSpec`.  A skipped cell records ``shape_applicable``'s
    reason, a failed one its traceback."""
    cfg = _cfg(arch)
    sh = _shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{cfg.name}__{sh.name}__{mesh_name}" + (f"__{tag}" if tag
                                                     else "")
    out_dir = Path(out_dir)
    out_path = out_dir / f"{name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    ok, why = shape_applicable(cfg, sh.name)
    rec = {"arch": cfg.name, "shape": sh.name, "mesh": mesh_name,
           "tag": tag, "ok": False}
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    if not ok:
        rec.update(status="skipped", reason=why, ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        got = measure(cfg, sh, mesh, policy=policy, tcfg=tcfg)
        count = got["count"]
        rec.update(
            status="ok", ok=True, meta=dict(
                got["meta"], n_shards=math.prod(mesh.shape.values()),
                shard_split=count["shard_split"],
                replication=count["replication"],
                collectives="a model (module docstring), not measured"),
            memory_analysis=count["memory"],
            flop_count={k: count[k] for k in (
                "flops", "outside_flops", "attention_flops", "ssd_flops",
                "term_calls", "flops_per_device", "attention_kernel_flops",
                "ssd_kernel_flops", "card_flops", "card_flops_per_device",
                "phases")},
            count_analysis={k: count[k] for k in (
                "flops_per_device", "bytes_dot_per_device",
                "card_flops_per_device", "card_bytes_per_device",
                "collective_traffic_per_device", "collectives",
                "by_term")},
            roofline=got["roofline"])
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    out_path.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {name}: {rec['status']} ({rec['wall_s']}s)",
          flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else all_arch_ids()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape_name, mp, out_dir,
                               force=args.force, tag=args.tag)
                if rec.get("status") == "error":
                    failures += 1
    print(f"[dryrun] done, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
