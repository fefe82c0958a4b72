"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``latch_ops.apply_batch`` (K1) replaces the TPU's ``latch_apply``;
* ``gcl_fetch.fetch`` (K2) replaces the TPU's ``gcl_fetch``;
* ``paged_attention.decode_paged`` (K3) replaces the TPU's
  ``paged_attention``;
* ``flash_attention.flash_attention`` (K4) replaces the TPU's
  ``flash_attention``;
* ``ssd_intra.ssd_intra`` (K5) replaces the TPU's ``ssd_intra``;
* ``flash_attention.flash_attention_bwd`` and ``ssd_intra.ssd_intra_bwd``
  are K4's and K5's backward kernels (the TPU kernels are forward-only);
  the forward wrappers call them through their autograd Functions on the
  card.

The CUDA sources live in ``../csrc`` and build on first launch
(``_build``).  A wrapper launches its kernel for CUDA tensors, runs the
plain version for CPU tensors, and counts its launches in
``<wrapper>.launches``.
"""

from .flash_attention import flash_attention, flash_attention_bwd
from .gcl_fetch import fetch
from .latch_ops import apply_batch
from .paged_attention import decode_paged
from .ssd_intra import ssd_intra, ssd_intra_bwd

WRAPPERS = {"latch_ops": apply_batch, "gcl_fetch": fetch,
            "paged_attention": decode_paged,
            "flash_attention": flash_attention, "ssd_intra": ssd_intra,
            "flash_attention_bwd": flash_attention_bwd,
            "ssd_intra_bwd": ssd_intra_bwd}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "flops"):
            fn.flops = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def flop_counts() -> dict:
    """The operations of the launches counted so far, by wrapper (K4's
    and K5's, forward and backward)."""
    return {name: fn.flops for name, fn in WRAPPERS.items()
            if hasattr(fn, "flops")}


__all__ = ["WRAPPERS", "apply_batch", "decode_paged", "fetch",
           "flash_attention", "flash_attention_bwd", "flop_counts",
           "launch_counts",
           "reset_launch_counts", "ssd_intra", "ssd_intra_bwd"]
