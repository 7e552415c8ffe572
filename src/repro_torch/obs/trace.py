"""Contextvar-scoped span tracer with a zero-overhead disabled mode.

The port of the JAX package's tracer.  Disabled (the default, unless
``REPRO_OBS`` is set) ``trace(...)`` returns a shared no-op span: nothing is
allocated or recorded.  Enabled, each span records its wall time, its depth
and parent, and — when :meth:`Span.fence` is handed CUDA tensors — its
device time, measured by a ``torch.cuda.Event`` pair on the current stream
(recorded at entry and at the fence, which synchronises on the second
event).  For CPU tensors there is no device clock, so ``device_ms`` stays
``None`` and the engine records no cost observation.

Events (``record_event``) are the structured side of the same log: the
planner appends one ``plan_decision`` per cache miss, the engine one
``cost_observation`` per fenced call.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "enable", "disable", "enabled", "tracing", "trace", "Span",
    "record_event", "events", "spans", "clear", "to_json",
]

_ENABLED = bool(os.environ.get("REPRO_OBS"))

_LOCK = threading.Lock()
_SPANS: List[Dict[str, Any]] = []
_EVENTS: List[Dict[str, Any]] = []
_STACK: contextvars.ContextVar[Tuple["Span", ...]] = contextvars.ContextVar(
    "repro_torch_obs_span_stack", default=())


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def tracing(on: bool = True):
    """Scoped enable/disable."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    try:
        yield
    finally:
        _ENABLED = prev


def clear() -> None:
    """Drop every recorded span and event."""
    with _LOCK:
        _SPANS.clear()
        _EVENTS.clear()


def _cuda_leaves(value: Any) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value] if value.is_cuda else []
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _cuda_leaves(v)]
    return []


class Span:
    """One timed region: wall time always, device time when fenced on
    CUDA tensors."""

    __slots__ = ("name", "attrs", "depth", "parent", "_t0", "_start",
                 "wall_ms", "device_ms")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.depth = 0
        self.parent: Optional[str] = None
        self._t0 = 0.0
        self._start: Optional[torch.cuda.Event] = None
        self.wall_ms: Optional[float] = None
        self.device_ms: Optional[float] = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def fence(self, value):
        """Wait until the CUDA work producing ``value`` is done and record
        the span's device time; returns ``value`` unchanged."""
        leaves = _cuda_leaves(value)
        if leaves and self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(leaves[0].device))
            end.synchronize()
            self.device_ms = self._start.elapsed_time(end)
        return value

    def __enter__(self) -> "Span":
        stack = _STACK.get()
        self.depth = len(stack)
        self.parent = stack[-1].name if stack else None
        _STACK.set(stack + (self,))
        if torch.cuda.is_available():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        stack = _STACK.get()
        if stack and stack[-1] is self:
            _STACK.set(stack[:-1])
        with _LOCK:
            _SPANS.append({
                "name": self.name, "parent": self.parent,
                "depth": self.depth, "wall_ms": self.wall_ms,
                "device_ms": self.device_ms, "attrs": dict(self.attrs),
            })


class _NoopSpan:
    """The shared disabled-mode span."""

    __slots__ = ()
    name = None
    wall_ms = None
    device_ms = None
    attrs: Dict[str, Any] = {}

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def fence(self, value):
        return value

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoopSpan()


def trace(name: str, **attrs):
    """Open a span (a context manager); the no-op singleton when off."""
    if not _ENABLED:
        return _NOOP
    return Span(name, attrs)


def spans() -> List[Dict[str, Any]]:
    """Finished span records (completion order)."""
    with _LOCK:
        return list(_SPANS)


def record_event(kind: str, **fields) -> None:
    """Append one structured event (no-op when disabled)."""
    if not _ENABLED:
        return
    with _LOCK:
        _EVENTS.append({"kind": kind, **fields})


def events(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    with _LOCK:
        evs = list(_EVENTS)
    if kind is not None:
        evs = [e for e in evs if e.get("kind") == kind]
    return evs


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:                                    # 0-d tensors, numpy scalars
        return v.item()
    except (AttributeError, ValueError, RuntimeError):
        return repr(v)


def to_json(indent: Optional[int] = None) -> str:
    """Every recorded span and event as one JSON document."""
    return json.dumps({"spans": _jsonable(spans()),
                       "events": _jsonable(events())}, indent=indent)
