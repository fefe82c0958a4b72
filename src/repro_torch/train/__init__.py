"""Step builders of the port: the training step (gradient accumulation,
remat, int8 gradient compression, AdamW) and the serving step, on a
mesh whose shards share one device."""

from .step import (TrainConfig, build_serve_step, build_train_step,
                   init_train_state, opt_specs, resolve_micro, state_specs)

__all__ = ["TrainConfig", "build_serve_step", "build_train_step",
           "init_train_state", "opt_specs", "resolve_micro", "state_specs"]
