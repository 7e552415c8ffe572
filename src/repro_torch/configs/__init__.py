"""repro_torch.configs — workload configurations of the port: the paper's
sorting unit (``adsimc_paper``), the model configurations (one module per
architecture of ``ARCH_IDS``) and the shape registry."""
from repro_torch.configs.adsimc_paper import PAPER_UNIT, SortUnitConfig  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ALIASES, ARCH_IDS, SHAPES, ModelConfig, MoEConfig, RGLRUConfig,
    SSMConfig, ShapeSpec, cell_is_supported, get_config, get_smoke_config)
