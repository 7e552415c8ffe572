"""repro_torch.obs — span tracer, metrics and markdown reports, one master
switch::

    import repro_torch.obs as obs

    obs.enable()                     # or REPRO_OBS=1 in the environment
    repro_torch.sort.sort(x)
    print(obs.report.render_markdown())

Disabled (the default) every call site pays one flag check and outputs are
unchanged.
"""
from __future__ import annotations

from repro_torch.obs import metrics, report, trace  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    counter, gauge, histogram, snapshot)
from repro_torch.obs.trace import (  # noqa: F401
    Span, disable, enable, enabled, events, record_event, spans, tracing)

span = trace.trace


def clear() -> None:
    """Reset every recorded span, event and metric."""
    trace.clear()
    metrics.reset()
