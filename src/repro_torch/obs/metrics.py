"""Process-local counters and fixed-bucket histograms (the part of the JAX
package's metrics registry the engine writes; pure Python).

No dependencies beyond the standard library: histograms use fixed
geometric buckets (``_BPD`` buckets per decade over ``[_LO, _HI)``), so an
``observe`` is one ``log10`` + an integer increment and percentile queries
(p50/p90/p99) resolve by walking the cumulative counts with log-linear
interpolation inside the crossing bucket — accurate to roughly one bucket
width (~7%% relative with 32 buckets/decade).

Recording respects the observability master switch
(:func:`repro_torch.obs.trace.enabled`): with obs disabled every ``inc`` /
``set`` / ``observe`` returns immediately, so instrumented hot paths pay
one flag check.  Reads (``snapshot``, ``percentile``) always work.

Units are by convention in the metric name (``serve.e2e_ms``,
``samplesort.alltoall_bytes``); the registry does not interpret them.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from repro_torch.obs import trace as _trace

__all__ = ["Counter", "Histogram", "counter", "histogram", "snapshot",
           "reset"]

_LOCK = threading.Lock()
_REGISTRY: Dict[str, object] = {}

# histogram geometry: 32 geometric buckets per decade over [1e-9, 1e12)
_BPD = 32
_LO = 1e-9
_DECADES = 21
_NBUCKETS = _BPD * _DECADES


class Counter:
    """Monotonic accumulator (events, bytes, cache hits)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not _trace.enabled():
            return
        with _LOCK:
            self.value += v

    def _snap(self):
        return {"type": "counter", "value": self.value}


class Histogram:
    """Fixed-geometric-bucket histogram with percentile queries."""

    def __init__(self, name: str):
        self.name = name
        self.buckets: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    @staticmethod
    def _bucket_of(v: float) -> int:
        if v <= _LO:
            return 0
        i = int(math.log10(v / _LO) * _BPD)
        return min(i, _NBUCKETS - 1)

    @staticmethod
    def _edges(i: int):
        lo = _LO * 10.0 ** (i / _BPD)
        return lo, lo * 10.0 ** (1.0 / _BPD)

    def observe(self, v: float) -> None:
        if not _trace.enabled():
            return
        v = float(v)
        with _LOCK:
            self.buckets[self._bucket_of(v)] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100] -> log-interpolated value, None when empty."""
        if self.count == 0:
            return None
        target = (p / 100.0) * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if seen + c >= target:
                lo, hi = self._edges(i)
                frac = (target - seen) / c
                est = lo * (hi / lo) ** frac
                # never extrapolate past the observed extremes
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def clear(self) -> None:
        """Zero this histogram in place (the registry keeps the instance).
        Drift detectors (``tuning.refresh_if_stale``) clear the error
        histogram after acting on it so the next decision starts from
        fresh observations instead of re-counting the stale ones."""
        with _LOCK:
            self.buckets = [0] * _NBUCKETS
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None

    def _snap(self):
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


def _get(name: str, cls):
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = cls(name)
    if not isinstance(m, cls):
        raise TypeError(f"metric {name!r} already registered as "
                        f"{type(m).__name__}, requested {cls.__name__}")
    return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def histogram(name: str) -> Histogram:
    return _get(name, Histogram)


def snapshot() -> Dict[str, dict]:
    """{name: {type, ...summary...}} for every registered metric."""
    with _LOCK:
        metrics = dict(_REGISTRY)
    return {name: m._snap() for name, m in sorted(metrics.items())}


def reset() -> None:
    with _LOCK:
        _REGISTRY.clear()
