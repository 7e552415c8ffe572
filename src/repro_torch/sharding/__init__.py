"""repro_torch.sharding — the sharding policy (``partitioning``): where each
parameter, activation and cache lives on a DTensor device mesh."""
