"""repro_torch.optim — the optimizers (AdamW, Adafactor) and the
error-feedback gradient codecs of the training path."""
