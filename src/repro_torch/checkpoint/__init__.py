"""repro_torch.checkpoint — asynchronous, atomic checkpoints of trees of
tensors."""
