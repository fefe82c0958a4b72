"""Elastic restart walkthrough on the PyTorch port: a data-parallel row
dies mid-training and the job continues on the survivors; the flow and
the printed lines of ``examples/elastic_restart.py``.

Single-process demo on a 1x1 mesh on ``--device`` (``cuda`` unless
``--device cpu`` is given; the remesh over shard ids runs in
``tests/test_torch_parallel.py``, and over ranks in
``tests/test_torch_ranks_train.py``): shows the operator flow —
heartbeats, failure verdict, elastic plan, checkpoint restore, batch
rescale.  On the card the smoke model's head dim is the attention
kernels' smallest, 64 (``configs.on_device``).

    PYTHONPATH=src python examples/torch_elastic_restart.py
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config, on_device  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import (FailureDetector,  # noqa: E402
                                 StragglerWatchdog, plan_elastic_mesh)
from repro_torch.train import (TrainConfig, build_train_step,  # noqa: E402
                               init_train_state)


def main(argv=None):
    """Runs the walkthrough; returns its losses by phase, the verdict,
    the plan, the restored step and each phase's micro-batch count."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "elastic_demo"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = on_device(get_smoke_config("qwen3-1.7b"), dev)
    tcfg = TrainConfig(remat=False, opt=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=12))
    mesh = make_local_mesh(device=dev)
    step_fn, _, n_micro = build_train_step(cfg, mesh, tcfg, global_batch=8)
    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=8, seq_len=64))
    mgr = CheckpointManager(args.ckpt, keep=2)
    fd = FailureDetector([f"h{i}" for i in range(4)], suspect_after=5,
                         dead_after=10)
    dog = StragglerWatchdog()
    out = {"healthy": [], "continued": []}

    print("[phase 1] healthy training on 4 data rows (logical)")
    for s in range(4):
        state, m = step_fn(state, data.batch_at(s))
        for h in ("h0", "h1", "h2", "h3"):
            fd.beat(h)
        dog.observe(0.1, slowest_host="h2")
        out["healthy"].append(float(m["loss"]))
        print(f"  step {s}: loss {float(m['loss']):.4f}")
    mgr.save(state, 3)
    mgr.wait()

    print("[phase 2] h1 stops heartbeating...")
    fd.last_beat["h1"] -= 100
    alive, suspect, dead = fd.sweep()
    print(f"  detector verdict: dead={dead}")
    plan = plan_elastic_mesh(4, 2, dead_hosts=dead,
                             host_of_device=lambda d, m: f"h{d}")
    print(f"  elastic plan: keep rows {plan.data_rows}, "
          f"batch scale {plan.batch_scale:.2f}")

    print("[phase 3] restore + continue with rescaled batch")
    new_batch = max(2, int(8 * plan.batch_scale) // 2 * 2)
    step_fn2, _, n_micro2 = build_train_step(cfg, mesh, tcfg,
                                             global_batch=new_batch)
    state2, step = mgr.restore(state)
    data2 = SyntheticLM(DataConfig(vocab=cfg.vocab, batch=new_batch,
                                   seq_len=64))
    for s in range(step + 1, step + 4):
        state2, m = step_fn2(state2, data2.batch_at(s))
        out["continued"].append(float(m["loss"]))
        print(f"  step {s}: loss {float(m['loss']):.4f} "
              f"(batch {new_batch})")
    print("[done] training continued across the failure")
    out.update(dead=dead, plan=plan, restored_step=step,
               n_micro=(n_micro, n_micro2))
    return out


if __name__ == "__main__":
    main()
