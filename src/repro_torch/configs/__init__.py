"""repro_torch.configs — workload configurations of the port (the paper's
sorting unit; model configurations arrive with the model stack)."""
