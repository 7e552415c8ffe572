"""repro_torch.sharding — the sharding policy (``partitioning``): where each
parameter, activation and cache lives on a DTensor device mesh."""
from repro_torch.sharding.partitioning import (  # noqa: F401
    NO_SHARDING, ShardingPolicy)
