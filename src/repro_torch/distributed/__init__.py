"""Sharding rules, collectives, fault tolerance and gradient compression (a
port of ``repro.distributed``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    logical_to_spec,
    param_axes,
    shard_params,
)
