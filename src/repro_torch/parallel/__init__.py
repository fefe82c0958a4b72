"""The LM stack's sharding, in one process or over ``torch.distributed``
ranks (:mod:`.dist`); port of ``repro.parallel``."""

from .sharding import (ShardingPolicy, batch_specs, cache_specs, make_ctx,
                       param_specs, to_named)

__all__ = ["ShardingPolicy", "make_ctx", "param_specs", "batch_specs",
           "cache_specs", "to_named"]
