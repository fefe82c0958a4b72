"""The reference's training of the fp32 smoke models of :data:`ARCHS` (one
of every family) on an ``Auto`` (data 4, model 2) mesh of 8 CPU devices (or
the (data, model) shape given after the directory: (2, 4) for
``tests/test_torch_ranks_tp.py``)
(``jax.sharding.Mesh``: ``jax.make_mesh``'s ``Explicit`` axes make
``with_sharding_constraint`` raise under jax 0.9), with the train state
placed by the reference's ``state_specs`` (so GSPMD shards every dense
leaf over ``model`` as its default policy does), for
``tests/test_torch_ranks_data.py``.

For each model: ``build_train_step``'s context, the state of
``init_train_state`` with the parameters of ``<arch>_in.npz`` (the
port's draw, ``params/...`` arrays) placed by ``state_specs`` with
``jax.device_put``, then ``jax.value_and_grad(lm.train_loss)`` under that
context without remat on a batch of 4 x 16 tokens from numpy seed 11
(with the vlm's patch or the encdec's frame embeddings of
``<arch>_in.npz``'s ``batch/...`` arrays: the port's seeded stand-ins),
and one step of the train step itself (its grad norm).  Run as a
script in a fresh process::

    python tests/_torch_data_reference.py DIR [DATA MODEL]

reads ``DIR/<arch>_in.npz``, writes ``DIR/<arch>_ref.npz``
(``loss``, ``grad<i>`` in JAX's leaf order, ``grad_norm``, ``toks``) and
prints ``DATA_REFERENCE_OK``.
"""

import os
import sys

ARCHS = ("qwen3-1.7b", "deepseek-moe-16b", "mamba2-2.7b",
         "recurrentgemma-2b", "llava-next-mistral-7b",
         "seamless-m4t-medium")
BATCH, SEQ, SEED, LOSS_CHUNK = 4, 16, 11, 16


def run(arch, params_path, out_path, shape=(4, 2)):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from repro.configs import get_smoke_config
    from repro.models import lm
    from repro.train.step import (TrainConfig, build_train_step,
                                  init_train_state, state_specs)
    from _torch_moe_reference import _tree
    cfg = get_smoke_config(arch).replace(dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("data", "model"))
    tcfg = TrainConfig(remat=False, loss_chunk=LOSS_CHUNK)
    step, ctx, _ = build_train_step(cfg, mesh, tcfg)
    state = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    with np.load(params_path) as z:
        state["params"] = _tree({k: z[k] for k in z.files}, "params/")
        embeds = _tree({k: z[k] for k in z.files}, "batch/")
    specs = state_specs(mesh, jax.eval_shape(lambda: state), tcfg)
    state = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, PartitionSpec)))
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:]), **embeds}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: lm.train_loss(p, batch, cfg, ctx, remat=False,
                                loss_chunk=LOSS_CHUNK)))(state["params"])
    out = {"loss": np.asarray(loss), "toks": toks}
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"grad{i}"] = np.asarray(g)
    _, metrics = jax.jit(step)(state, batch)
    out["grad_norm"] = np.asarray(metrics["grad_norm"])
    np.savez(out_path, **out)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.join(os.path.dirname(here), "src"), here]
    d = sys.argv[1]
    shape = tuple(int(a) for a in sys.argv[2:4]) or (4, 2)
    for arch in ARCHS:
        run(arch, os.path.join(d, f"{arch}_in.npz"),
            os.path.join(d, f"{arch}_ref.npz"), shape)
    print("DATA_REFERENCE_OK")
