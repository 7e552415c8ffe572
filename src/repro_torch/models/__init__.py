"""repro_torch.models — the model stack of the port: ``layers``,
``attention`` (with K6 flash prefill and M-RoPE), the mixers ``ssm``
(Mamba-2 SSD) and ``rglru`` (RG-LRU), ``moe``, ``transformer`` (the
decoder-only families), ``encdec`` (whisper) and the ``model_zoo``
facade."""
from repro_torch.models.model_zoo import Model, build  # noqa: F401
