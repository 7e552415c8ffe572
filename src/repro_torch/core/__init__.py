"""repro_torch.core — key codec, tuning profiles, cost model, the SortSpec
front-door contract and the backend registry.

API v2 lives in :mod:`repro_torch.core.sortspec` (SortSpec + backend
registry) with the front door in :mod:`repro_torch.sort`; the re-exported
``sort`` / ``argsort`` / ``topk`` here are the v1 shims kept for
compatibility, as in the JAX package.
"""
from repro_torch.core.sort_api import (argsort, bitonic_sort, sort, top_p_mask,
                                       topk)
from repro_torch.core.sortspec import (Capabilities, SortBackend, SortSpec,
                                       register_backend, sort_defaults)
from repro_torch.core import network, cost_model

__all__ = ["sort", "argsort", "topk", "top_p_mask", "bitonic_sort",
           "Capabilities", "SortBackend", "SortSpec", "register_backend",
           "sort_defaults", "network", "cost_model"]
