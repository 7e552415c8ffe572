"""The paper's own workload config: N-input, W-bit in-memory sorting units.

Method names are the port's (``xla`` is ``torch``, ``pallas`` is
``cuda``; see ``repro_torch.BACKEND_NAMES``)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SortUnitConfig:
    n_inputs: int = 8
    width: int = 4
    method: str = "imc"       # imc | bitonic | cuda | torch


PAPER_UNIT = SortUnitConfig()
