"""PyTorch/CUDA port of the SELCC device plane, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held
against; this one imports ``torch`` and numpy and nothing of ``repro``
or ``jax``.  Its layout mirrors ``repro`` so each module's counterpart
is found by name:

* ``core/coherence.py`` — the Fig. 3 latch-word lane helpers;
* ``core/rounds/`` — round state, one coherence round, the drivers and
  the flat ``DevicePlane`` facade;
* ``dsm/kvpool.py`` — the rounds-plane KV-page pool;
* ``serve/`` — the continuous-batching ``ServeLoop`` and its oracle;
* ``models/``, ``launch/serve.py`` — LM serving for every family;
* ``optim/``, ``train/``, ``data/``, ``checkpoint/``, ``runtime/``,
  ``launch/train.py`` — the training stack on one device;
* ``kernels/`` — the hand-written Hopper kernels (CUDA C++ under
  ``csrc/``) that replace the TPU's Pallas kernels, each with its plain
  PyTorch version beside it, and the backward kernels of K4 and K5.

Devices: entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise ``RuntimeError`` when no GPU is present and
the CPU was not asked for.  Kernel wrappers dispatch by the device of
the tensors they are given: a CUDA tensor launches the kernel, a CPU
tensor runs the plain version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, or
    whatever the caller names.  Never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
