"""repro_torch.core — key codec, tuning profiles, cost model, the SortSpec
front-door contract and the backend registry."""
