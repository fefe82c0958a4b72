"""The reference's fp32 deepseek smoke model on an ``Auto`` (2, 4) mesh
of 8 CPU devices (``jax.sharding.Mesh``: ``jax.make_mesh``'s
``Explicit`` axes make ``with_sharding_constraint`` raise under jax
0.9), shared by ``tests/test_torch_parallel.py``'s reference script and
``tests/test_torch_ranks_train.py``.

:func:`moe_model` runs inside a process whose JAX has 8 CPU devices: a
prefill and two decode steps (``serve``), and the loss and every
gradient leaf of ``jax.value_and_grad(lm.train_loss)`` through the
model's ``shard_map``, on a batch of 4 x 16 tokens drawn from numpy
seed 11; the parameters are JAX's own draw from ``PRNGKey(0)``, or the
arrays of a ``params/...`` ``.npz`` (e.g. the port's draw).  Run as a
script it does that in a fresh process::

    python tests/_torch_moe_reference.py OUT.npz [PARAMS.npz]

and writes ``model/loss``, ``model/grad<i>`` (JAX's leaf order) and
``model/toks`` to ``OUT.npz``, then prints ``MOE_REFERENCE_OK``.
"""

import os
import sys

ARCH = "deepseek-moe-16b"
BATCH, SEQ, N_DEC, SEED, LOSS_CHUNK = 4, 16, 2, 11, 16


def mesh_of(shape):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:int(np.prod(shape))])
    return Mesh(devs.reshape(shape), ("data", "model"))


def keep_params(out, prefix, params):
    """Every leaf of ``params`` into ``out`` under ``prefix`` + its
    path; bf16 as its uint16 bits, which ``convert.lm_params_to_torch``
    reads."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        v = np.asarray(v)
        out[prefix + "/".join(k.key for k in path)] = (
            v.view(np.uint16) if v.dtype == jnp.bfloat16 else v)


def _tree(arrays, prefix):
    import jax.numpy as jnp
    tree = {}
    for k, v in arrays.items():
        if k.startswith(prefix):
            *keys, leaf = k[len(prefix):].split("/")
            node = tree
            for key in keys:
                node = node.setdefault(key, {})
            node[leaf] = jnp.asarray(v)
    return tree


def moe_model(out, params=None, serve=True):
    """The model's results into ``out`` (a dict of numpy arrays):
    ``model/params/...`` (the parameters used), ``model/toks``, with
    ``serve`` ``model/dec``, ``model/prefill`` and ``model/decode<i>``,
    then ``model/loss`` and ``model/grad<i>``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_smoke_config
    from repro.models import lm
    from repro.parallel.sharding import make_ctx
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    ctx = make_ctx(mesh_of((2, 4)), cfg)
    if params is None:
        params = lm.init_params(jax.random.PRNGKey(0), cfg)
    keep_params(out, "model/params/", params)
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (N_DEC, BATCH, 1)).astype(np.int32)
    out["model/toks"] = toks
    if serve:
        out["model/dec"] = dec
        logits, cache = jax.jit(lambda p, t: lm.prefill(
            p, {"tokens": t}, cfg, ctx))(params, jnp.asarray(toks[:, :-1]))
        out["model/prefill"] = np.asarray(logits)
        full = lm.init_decode_cache(cfg, BATCH, SEQ + N_DEC)
        for k in cache:
            if k != "pos":
                full[k] = full[k].at[tuple(slice(0, n) for n in
                                           cache[k].shape)].set(cache[k])
            else:
                full[k] = cache[k]
        step = jax.jit(lambda p, c, t: lm.decode_step(p, c, t, cfg, ctx))
        for i in range(N_DEC):
            logits, full = step(params, full, jnp.asarray(dec[i]))
            out[f"model/decode{i}"] = np.asarray(logits)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: lm.train_loss(p, batch, cfg, ctx, remat=False,
                                loss_chunk=LOSS_CHUNK)))(params)
    out["model/loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"model/grad{i}"] = np.asarray(g)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    res = {}
    given = None
    if len(sys.argv) > 2:
        with np.load(sys.argv[2]) as z:
            given = _tree({k: z[k] for k in z.files}, "params/")
    moe_model(res, given, serve=given is None)
    np.savez(sys.argv[1], **res)
    print("MOE_REFERENCE_OK")
