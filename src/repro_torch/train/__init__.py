"""Step builders of the port: the training step (gradient accumulation,
remat, int8 gradient compression, AdamW) and the serving step, on one
device."""

from .step import (TrainConfig, build_serve_step, build_train_step,
                   init_train_state, resolve_micro)

__all__ = ["TrainConfig", "build_serve_step", "build_train_step",
           "init_train_state", "resolve_micro"]
