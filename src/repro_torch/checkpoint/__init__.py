from .ckpt import (CheckpointManager, latest_step, restore, save,
                   verify_manifest)

__all__ = ["CheckpointManager", "latest_step", "restore", "save",
           "verify_manifest"]
