"""repro_torch.models — the model stack of the port: ``layers``,
``attention`` (with K6 flash prefill), ``transformer`` (dense stacks) and
the ``model_zoo`` facade."""
from repro_torch.models.model_zoo import Model, build  # noqa: F401
