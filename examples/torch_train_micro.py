"""Train a ~100M-parameter dense LM for a few hundred steps on the
PyTorch port, exercising the full production path of
``examples/train_micro.py``: grad accumulation, checkpointing, resume,
straggler watchdog, on ``--device`` (``cuda`` unless ``--device cpu``
is given).

    PYTHONPATH=src python examples/torch_train_micro.py [--steps 300]

(~100M params: d=768, L=12, vocab 32k — qwen3-family block.  Use
--tiny for a 2-minute variant: the qwen3 smoke config, on the card with
the attention kernels' smallest head dim, 64, ``configs.on_device``.)
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_smoke_config, on_device  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.config import LMConfig  # noqa: E402

MODEL_100M = LMConfig(
    name="micro-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32_000, qk_norm=True,
    tie_embeddings=True,
)
NAME, MODULE = "micro-100m", "micro_100m"


def main(argv=None):
    """Runs the driver; returns its record (``launch.train.main``'s)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "selcc_train_micro"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # register the 100M config under a private name (for this run)
    if args.tiny:
        cfg = on_device(get_smoke_config("qwen3-1.7b"), args.device)
    else:
        cfg = MODEL_100M
        print(f"[example] {cfg.name}: {cfg.param_count()/1e6:.0f}M params")

    class _Mod:
        CONFIG = cfg
        SMOKE_CONFIG = cfg
    sys.modules[f"repro_torch.configs.{MODULE}"] = _Mod
    configs.CANON[NAME] = MODULE
    configs.ARCHS.append(MODULE)
    try:
        return train_mod.main([
            "--arch", NAME, "--smoke",
            "--steps", str(args.steps),
            "--batch", "4", "--seq", "256", "--lr", "1e-3",
            "--ckpt", args.ckpt, "--ckpt-every", "100",
            "--log-every", "20", "--device", args.device,
        ])
    finally:
        configs.ARCHS.remove(MODULE)
        del configs.CANON[NAME]
        del sys.modules[f"repro_torch.configs.{MODULE}"]


if __name__ == "__main__":
    main()
