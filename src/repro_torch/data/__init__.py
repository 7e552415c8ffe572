"""repro_torch.data — the synthetic token pipeline and its dedup."""
