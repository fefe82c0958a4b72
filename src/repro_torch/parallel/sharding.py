"""Sharding policy: parameter / activation / cache partition specs; port
of ``repro.parallel.sharding``.

Baseline layout (Megatron-style 2D = FSDP('data') x TP('model'), pure DP
over 'pod'), as the reference's:

  embed [V, d]            -> (model, data)       vocab-parallel
  attn  wq/wk/wv [.,d,H*hd]-> (., data, model)    column-parallel heads
        wo [., H*hd, d]   -> (., model, data)    row-parallel
  ffn   wg/wu [., d, ff]  -> (., data, model)
        wd [., ff, d]     -> (., model, data)
  moe   we_* [., E, d, ff]-> (., model=EP, data, .)
  ssm   w_in [., d, proj] -> (., data, model)    etc.
  caches k/v [L,B,S,Hkv,hd]-> (., dp, model, ., .)  sequence-sharded KV

Every dim rule is divisibility-guarded: a dim that an axis does not
divide is replicated along it.

On the port's mesh every shard lives on one device and a tensor keeps
its global layout, so a spec is a record, not a placement, until a
process group splits an axis over ranks: a rank then holds its block of
every leaf whose spec names a ranked axis (:func:`rank_dims`; along the
model axis that is tensor parallelism, for every family, and expert
parallelism's routed experts).  :class:`P`
is JAX's ``PartitionSpec`` as a tuple (a one-axis tuple entry is
normalised to the axis, as JAX normalises it), :class:`NamedSharding`
pairs it with a mesh and checks that it divides a shape, and the
context constrains no activation, since ``with_sharding_constraint``
leaves values unchanged (:func:`activation_spec` is the spec it would
be given, after the reference's rank and divisibility guard).  Where
the sharding changes what is computed — expert parallelism's routing
per shard — the model does it itself
(:func:`repro_torch.models.moe.moe_ffn`).  The specs take any tree of
dicts and lists whose leaves have a ``shape`` (tensors,
:class:`repro_torch.launch.specs.TensorSpec`, the fake tensors of
:func:`repro_torch.train.step.state_shapes`).
"""

from __future__ import annotations

import functools
import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any

from .. import tree as pt
from ..convert import EXPERT_LEAVES
from ..models.lm import ParallelCtx


class P(tuple):
    """A partition spec: one entry per leading dim (the rest replicate),
    each None, an axis name, or a tuple of axis names."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self)).replace(",)", ")")


class RankDims(Mapping):
    """A leaf's ``{axis: dim}``: the dim a rank holds as its block along
    each ranked axis that splits the leaf (empty for a leaf every rank
    holds whole).  A mapping, not a dict, so the tree walks take it for
    a leaf."""

    __slots__ = ("_d",)

    def __init__(self, dims=()):
        self._d = dict(dims)

    def __getitem__(self, axis):
        return self._d[axis]

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __hash__(self) -> int:
        return hash(tuple(self._d.items()))

    def __repr__(self) -> str:
        return f"RankDims({self._d!r})"


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``).  ``rank_dims`` (a
    :class:`RankDims`) names the dim that a rank of a ranked mesh holds
    as its block along each ranked axis (the leaf's blocks in the axis's
    rank order), empty or None for a leaf every rank holds whole;
    :func:`to_named` sets it from :func:`rank_dims`."""
    mesh: Any
    spec: P
    rank_dims: RankDims | None = None

    @property
    def device(self):
        return self.mesh.device

    def global_shape(self, shape) -> tuple:
        """The whole leaf's shape from this rank's: the block times the
        axis's ranks along each of ``rank_dims``."""
        shape = list(shape)
        for axis, d in (self.rank_dims or {}).items():
            shape[d] *= self.mesh.n_ranks(axis)
        return tuple(shape)

    def block(self, x):
        """This rank's block of the whole leaf ``x`` (a tensor or numpy
        array; ``x`` itself for a leaf every rank holds whole)."""
        for axis, d in (self.rank_dims or {}).items():
            n = x.shape[d] // self.mesh.n_ranks(axis)
            c = self.mesh.coord(axis)
            x = x[(slice(None),) * d + (slice(c * n, (c + 1) * n),)]
        return x

    def check(self, shape) -> None:
        """``ValueError`` unless the spec fits this rank's leaf of
        ``shape``: no more entries than dims, and every sharded dim of
        the whole leaf (:meth:`global_shape`) a multiple of its axes'
        size (what JAX's placement refuses)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dims")
        shape = self.global_shape(shape)
        for size, ax in zip(shape, self.spec):
            n = _axis_size(self.mesh, ax)
            if size % n:
                raise ValueError(f"spec {self.spec} does not divide shape "
                                 f"{tuple(shape)}: {size} over {ax!r} "
                                 f"of {n} shards")


@dataclass(frozen=True)
class ShardingPolicy:
    """Tunable knobs (the reference's hillclimb flips these)."""
    fsdp_params: bool = True        # shard the non-TP weight dim over 'data'
    seq_shard_resid: bool = False   # sequence-shard residual activations
    shard_logits: bool = True
    kv_seq_axis: str = "model"      # decode KV cache: shard seq over...
    tp_enable: bool = True          # False: 'model' axis becomes extra DP
    replicate_embed: bool = False   # small models: replicated embed/head


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    return math.prod(mesh.shape[a] for a in
                     (axis if isinstance(axis, tuple) else (axis,)))


def _axes(mesh, policy: "ShardingPolicy | None" = None):
    names = mesh.axis_names
    dp = tuple(n for n in names if n in ("pod", "data"))
    if policy is not None and not policy.tp_enable:
        return dp + ("model",), None
    return dp, "model"


def _div(mesh, dim: int, axis) -> Any:
    """Use ``axis`` for this dim only if it divides evenly."""
    if axis is None or dim <= 0:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _is_node(x) -> bool:
    return isinstance(x, dict) or (isinstance(x, (list, tuple))
                                   and not isinstance(x, P))


def _map(fn, tree, *rest, key=None):
    """``fn(key, leaf, *other leaves)`` over a tree of dicts and lists
    (a :class:`P` is a leaf); ``key`` is the nearest dict key above the
    leaf, as the reference's rules read ``DictKey``s."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), key=str(k))
                for k in tree}
    if _is_node(tree):
        out = [_map(fn, t, *(r[i] for r in rest), key=key)
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(key, tree, *rest)


# the leaves an expert-parallel rank draws as its share of the experts
# (``lm.init_params(experts=)``), not cut from the whole draw
RANKED_KEYS = EXPERT_LEAVES
EP_AXIS = "model"


def param_specs(mesh, params, policy: ShardingPolicy | None = None):
    """A tree of specs matching ``params``, the whole leaves (they need
    only a shape: on a ranked mesh :func:`repro_torch.train.step.
    state_shapes` gives them); :func:`rank_dims` says which dims a rank
    holds as its block."""
    policy = policy or ShardingPolicy()
    dp, tp = _axes(mesh, policy)
    fs = "data" if (policy.fsdp_params and "data" in mesh.axis_names) \
        else None

    def rule(key, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)

        def spec(*dims):
            """dims for the TRAILING len(dims) axes; leading axes (layer
            stacking) replicate."""
            lead = (None,) * (nd - len(dims))
            return P(*(lead + tuple(_div(mesh, size, ax) for size, ax in
                                    zip(shape[nd - len(dims):], dims))))

        if key in ("embed",):
            return P() if policy.replicate_embed else spec(tp, fs)
        if key in ("head",):
            return P() if policy.replicate_embed else spec(fs, tp)
        if key and key.startswith("x_"):
            key = key[2:]
        if key in ("wq", "wk", "wv", "w_in", "wg", "wu", "w_x", "w_gate",
                   "w_r", "w_i", "s_wg", "s_wu"):
            return spec(fs, tp)
        if key in ("wo", "wd", "w_out", "s_wd"):
            return spec(tp, fs)
        if key in ("bq", "bk", "bv", "bu", "b_r", "b_i", "lam", "s_bu"):
            return spec(tp)
        if key in ("we_g", "we_u"):                     # [., E, d, ff]
            return spec(tp, fs, None)
        if key in ("we_d",):                            # [., E, ff, d]
            return spec(tp, None, fs)
        if key in ("router",):
            return spec(None, None)
        if key in ("w_conv",):                          # [., K, C]
            return spec(None, tp)
        if key in ("a_log", "dt_bias", "d_skip"):       # [., H]
            return spec(tp)
        if key in ("norm",):                            # [., d_in]
            return spec(tp)
        return P()                                       # norms, biases

    return _map(rule, params)


def batch_specs(mesh, batch, policy: ShardingPolicy | None = None):
    dp, _ = _axes(mesh, policy)

    def rule(key, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        return P(_div(mesh, shape[0], dp), *((None,) * (len(shape) - 1)))

    return _map(rule, batch)


def cache_specs(mesh, cache, policy: ShardingPolicy | None = None):
    """Decode caches: [L, B, S|W, ...] -> (., dp, kv_seq_axis, ., .);
    ssm state [L, B, H, P, N] -> (., dp, model, ., .)."""
    policy = policy or ShardingPolicy()
    dp, tp = _axes(mesh, policy)

    def rule(key, leaf):
        shape = tuple(leaf.shape)
        if key == "pos":
            return P(_div(mesh, shape[0], dp))
        if key in ("k", "v", "cross_k", "cross_v"):      # [L,B,S,Hkv,hd]
            return P(None, _div(mesh, shape[1], dp),
                     _div(mesh, shape[2], tp), None, None)
        if key == "state":                               # [L,B,H,P,N]
            return P(None, _div(mesh, shape[1], dp),
                     _div(mesh, shape[2], tp), None, None)
        if key == "conv":                                # [L,B,K-1,C]
            return P(None, _div(mesh, shape[1], dp), None,
                     _div(mesh, shape[3], tp))
        if key == "hrec":                                # [Lr,B,W]
            return P(None, _div(mesh, shape[1], dp),
                     _div(mesh, shape[2], tp))
        return P()

    return _map(rule, cache)


def activation_rules(mesh, policy: ShardingPolicy):
    dp, tp = _axes(mesh, policy)
    seq = tp if policy.seq_shard_resid else None
    logits_tp = tp if policy.shard_logits else None
    return {
        "resid": P(dp, seq, None),
        "resid_decode": P(dp, None, None),
        "ffn_in": P(dp, seq, None),
        "ffn_out": P(dp, seq, None),
        "attn_q": P(dp, None, tp, None),
        "attn_kv": P(dp, None, None, None),
        "attn_out": P(dp, None, tp, None),
        "logits": P(dp, None, logits_tp),
        "ssd_L": P(dp, None, None, None, tp),
    }


def activation_spec(mesh, policy: ShardingPolicy | None, kind, shape):
    """The spec the reference's ``make_ctx`` hands
    ``with_sharding_constraint`` for a ``kind`` activation of ``shape``
    after its rank and divisibility guard, or None where it leaves the
    tensor unconstrained."""
    rule = activation_rules(mesh, policy or ShardingPolicy()).get(kind)
    if rule is None or mesh is None or len(rule) != len(shape):
        return None                        # guard rank
    return P(*(_div(mesh, size, ax) for size, ax in zip(shape, rule)))


def make_ctx(mesh, cfg, policy: ShardingPolicy | None = None) -> ParallelCtx:
    """The model's context on ``mesh``: the data and model axes, the
    expert-parallel degree (the model axis's size for the moe family)
    and, where ranks split the model axis, the parameters' model dims
    (:func:`model_dims`: the model then computes each rank's block of
    every layer, tensor parallelism).  It
    constrains nothing: on the one device a sharding constraint leaves
    every value as it is (the spec the reference would apply is
    :func:`activation_spec`)."""
    policy = policy or ShardingPolicy()
    dp, tp = _axes(mesh, policy)
    ep = mesh.shape[tp] if (cfg.family == "moe" and tp is not None
                            and tp in mesh.axis_names) else 1
    dims = None
    if (tp is not None and getattr(mesh, "ranked", False)
            and mesh.n_ranks(tp) > 1):
        dims = model_dims(mesh, cfg, policy)
    return ParallelCtx(mesh=mesh, dp_axis=dp if len(dp) > 1 else dp[0],
                       tp_axis=tp or "model", ep=ep, tp=dims)


@functools.lru_cache(maxsize=16)
def _model_dims(cfg, axes, policy):
    from ..train.step import TrainConfig, state_shapes
    shapes = state_shapes(cfg, TrainConfig())["params"]
    specs = param_specs(_AxesOnly(dict(axes)), shapes, policy)

    def dim(_, spec):
        for i, ax in enumerate(spec):
            if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
                return i
        return None
    return _map(dim, specs)


class _AxesOnly:
    """A mesh's axis sizes, all that the specs read."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def model_dims(mesh, cfg, policy: ShardingPolicy | None = None):
    """A tree matching ``cfg``'s parameters of each leaf's model dim
    (None where the spec leaves it whole along ``model``), from the
    specs of the whole shapes on ``mesh``'s axes: what
    :attr:`ParallelCtx.tp` holds.  Shared (cached): read, never
    change."""
    return _model_dims(cfg, tuple(mesh.shape.items()),
                       policy or ShardingPolicy())


def expert_block(cfg, ctx):
    """``(first, stop)``: the routed experts a rank of ``ctx``'s ranked
    mesh holds under expert parallelism (``E / n`` of them, its model
    shards' experts, by its coordinate along the model axis's ``n``
    ranks), or None where it holds them all (no ranks, or no expert
    parallelism) — the ``experts`` argument of ``lm.init_params`` and
    ``train.init_train_state``."""
    mesh = ctx.mesh
    if not getattr(mesh, "ranked", False) or ctx.ep <= 1:
        return None
    per = cfg.n_experts // mesh.n_ranks(EP_AXIS)
    c = mesh.coord(EP_AXIS)
    return c * per, (c + 1) * per


def data_rows(mesh, batch_size: int, n_micro: int = 1,
              policy: ShardingPolicy | None = None):
    """This rank's rows of a global batch of ``batch_size`` (a numpy
    index array, in order): where :func:`batch_specs` shards each of the
    ``n_micro`` micro-batches over the data axes (their size divides its
    rows), the rows of this rank's block of the data shards of every
    micro-batch, so that splitting the rank's rows into ``n_micro``
    gives its block of each; where it does not, every row (each data
    rank takes the whole batch)."""
    import numpy as np
    rows = np.arange(batch_size)
    dp, _ = _axes(mesh, policy)
    dp_size = _axis_size(mesh, dp)
    if (not getattr(mesh, "ranked", False) or batch_size % n_micro
            or (batch_size // n_micro) % dp_size or mesh.n_ranks(dp) == 1):
        return rows
    # [micro, dp shard (the dp axes row-major), rows of a shard]
    grid = rows.reshape((n_micro,) + tuple(mesh.shape[a] for a in dp)
                        + (-1,))
    for i, a in enumerate(dp):
        first, stop = mesh.block(a)
        grid = grid[(slice(None),) * (i + 1) + (slice(first, stop),)]
    return grid.reshape(-1)


def rank_dims(mesh, specs):
    """A tree matching ``specs`` (a train state's, or a parameter tree's)
    of each leaf's :class:`RankDims` on a ranked mesh: along each ranked
    axis, every leaf whose spec names it, at the entry that names it
    (along the model axis the column-, row- and vocab-parallel leaves
    and the routed experts, their m, v and error feedback; along the
    data axis a parameter's ``fs`` dim, its m, v and error feedback
    alike).  An int8 m or v counts where the axis moved to its block
    count (``train.step.opt_specs``: only where a shard's width is whole
    blocks; elsewhere a rank holds it whole along the axis).  The
    divisibility guard is the spec's, against the mesh axis, so a rank's
    block is its shards' blocks concatenated.  Empty for a leaf every
    rank holds whole, and for every leaf off a ranked mesh."""
    ranks = getattr(mesh, "ranks", {}) if getattr(mesh, "ranked", False) \
        else {}

    def dims(_, spec):
        out = {}
        for axis in ranks:
            for i, ax in enumerate(spec):
                if ax == axis or (isinstance(ax, tuple) and axis in ax):
                    out[axis] = i
                    break
        return RankDims(out)
    return _map(dims, specs)


def to_named(mesh, specs):
    """A tree of :class:`NamedSharding` over ``mesh`` for a tree of
    specs, each with its :func:`rank_dims` entry."""
    return _map(lambda _, s, d: NamedSharding(mesh, s, d), specs,
                rank_dims(mesh, specs))


def device_put(tree, shardings):
    """Each leaf of ``tree`` on its sharding's mesh device, after checking
    that the sharding's spec divides the leaf's whole shape (JAX's
    ``device_put`` refuses such a placement; over ranks a ranked leaf is
    this rank's block of it); a leaf already there is returned as it
    is."""
    leaves, spec = pt.flatten(tree)
    placements = pt.leaves(shardings)
    if len(placements) != len(leaves):
        raise ValueError("shardings/tree structure mismatch")
    out = []
    for leaf, sh in zip(leaves, placements):
        sh.check(leaf.shape)
        out.append(leaf.to(sh.device))
    return pt.unflatten(spec, out)
