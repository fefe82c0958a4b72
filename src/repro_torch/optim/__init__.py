"""AdamW with tiered optimizer state and int8 gradient compression;
port of ``repro.optim``."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    lr_schedule)
from .compress import compress_grads, decompress_grads

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "lr_schedule", "compress_grads", "decompress_grads"]
