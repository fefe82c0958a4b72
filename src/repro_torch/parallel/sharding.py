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
its global layout, so a spec is a record, not a placement: :class:`P`
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

import math
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


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``).  ``rank_dim`` names
    the dim that a rank of a ranked mesh holds as its block (the leaf's
    ``world`` blocks in rank order), None for a leaf every rank holds
    whole; :func:`to_named` sets it from :func:`rank_dims`."""
    mesh: Any
    spec: P
    rank_dim: int | None = None

    @property
    def device(self):
        return self.mesh.device

    def global_shape(self, shape) -> tuple:
        """The whole leaf's shape from this rank's: the block times the
        world along ``rank_dim``."""
        shape = tuple(shape)
        if self.rank_dim is None:
            return shape
        d = self.rank_dim
        return shape[:d] + (shape[d] * self.mesh.world,) + shape[d + 1:]

    def block(self, x):
        """This rank's block of the whole leaf ``x`` (a tensor or numpy
        array; ``x`` itself for a leaf every rank holds whole)."""
        if self.rank_dim is None:
            return x
        d, w = self.rank_dim, self.mesh.world
        n = x.shape[d] // w
        r = self.mesh.rank
        return x[(slice(None),) * d + (slice(r * n, (r + 1) * n),)]

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


# the leaves an expert-parallel rank holds as its block of the model axis
RANKED_KEYS = EXPERT_LEAVES


def param_specs(mesh, params, policy: ShardingPolicy | None = None):
    """A tree of specs matching ``params`` (leaves need only a shape).
    On a ranked mesh a routed-expert leaf is a rank's block of the
    experts (``convert.rank_experts``), and its spec is the whole
    leaf's: ``E / W`` rows times the world."""
    policy = policy or ShardingPolicy()
    dp, tp = _axes(mesh, policy)
    fs = "data" if (policy.fsdp_params and "data" in mesh.axis_names) \
        else None
    world = mesh.world if getattr(mesh, "ranked", False) else 1

    def rule(key, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if key in RANKED_KEYS and world > 1:
            shape = shape[:nd - 3] + (shape[nd - 3] * world,) + shape[nd - 2:]

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
    """The model's context on ``mesh``: the data and model axes and the
    expert-parallel degree (the model axis's size for the moe family).
    It constrains nothing: on the one device a sharding constraint
    leaves every value as it is (the spec the reference would apply is
    :func:`activation_spec`)."""
    policy = policy or ShardingPolicy()
    dp, tp = _axes(mesh, policy)
    ep = mesh.shape[tp] if (cfg.family == "moe" and tp is not None
                            and tp in mesh.axis_names) else 1
    return ParallelCtx(mesh=mesh, dp_axis=dp if len(dp) > 1 else dp[0],
                       tp_axis=tp or "model", ep=ep)


def expert_block(cfg, ctx):
    """``(first, stop)``: the routed experts a rank of ``ctx``'s ranked
    mesh holds under expert parallelism (``E / W`` of them, its model
    shards' experts), or None where it holds them all (no ranks, or no
    expert parallelism) — the ``experts`` argument of
    ``lm.init_params`` and ``train.init_train_state``."""
    mesh = ctx.mesh
    if not getattr(mesh, "ranked", False) or ctx.ep <= 1:
        return None
    per = cfg.n_experts // mesh.world
    return mesh.rank * per, (mesh.rank + 1) * per


def rank_dims(mesh, specs):
    """A tree matching ``specs`` (a train state's, or a parameter tree's)
    of the dim each leaf holds as this rank's block on a ranked mesh:
    the leaves under a routed-expert key (:data:`RANKED_KEYS`: the
    parameter, its m and v in any tier, its error feedback) whose spec
    names the mesh's ranked axis, at that entry; None for every other
    leaf, which each rank holds whole, and for every leaf off a ranked
    mesh."""
    ranked = getattr(mesh, "ranked", False)
    axis = getattr(mesh, "ranked_axis", None)

    def walk(node, under):
        if isinstance(node, dict):
            return {k: walk(v, under or k in RANKED_KEYS)
                    for k, v in node.items()}
        if _is_node(node):
            out = [walk(v, under) for v in node]
            return out if isinstance(node, list) else tuple(out)
        if not (ranked and under):
            return None
        for i, ax in enumerate(node):
            if ax == axis or (isinstance(ax, tuple) and axis in ax):
                return i
        return None
    return walk(specs, False)


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
