"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``latch_ops.apply_batch`` (K1) replaces the TPU's ``latch_apply``;
* ``gcl_fetch.fetch`` (K2) replaces the TPU's ``gcl_fetch``;
* ``paged_attention.decode_paged`` (K3) replaces the TPU's
  ``paged_attention``.

The CUDA sources live in ``../csrc`` and build on first launch
(``_build``).  A wrapper launches its kernel for CUDA tensors, runs the
plain version for CPU tensors, and counts its launches in
``<wrapper>.launches``.
"""

from .gcl_fetch import fetch
from .latch_ops import apply_batch
from .paged_attention import decode_paged

WRAPPERS = {"latch_ops": apply_batch, "gcl_fetch": fetch,
            "paged_attention": decode_paged}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["WRAPPERS", "apply_batch", "decode_paged", "fetch",
           "launch_counts", "reset_launch_counts"]
