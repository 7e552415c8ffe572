"""repro_torch.launch — drivers of the port: ``steps`` (prefill and decode
step builders) and ``serve`` (the length-sorted serving loop)."""
