"""repro_torch.obs — span tracer and metrics, one master switch.

Disabled (the default; ``REPRO_OBS=1`` or :func:`enable` turns it on) every
call site pays one flag check and outputs are unchanged.
"""
from __future__ import annotations

from repro_torch.obs import metrics, trace  # noqa: F401
from repro_torch.obs.metrics import counter, histogram, snapshot  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    Span, disable, enable, enabled, events, record_event, spans, tracing)

span = trace.trace


def clear() -> None:
    """Reset every recorded span, event and metric."""
    trace.clear()
    metrics.reset()
