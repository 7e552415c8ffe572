"""repro_torch.runtime — preemption handling, the step watchdog and the
elastic-restart arithmetic of the training loop."""
