"""Histogram and quantile sketches.

Quantiles are order statistics, and the MSD radix selection (K4,
``kernels/radix_select.py``) computes them without a sort: encode the
column ascending (key codec), select the bottom k with k = the largest
needed order statistic + 1, and read every requested quantile out of the
ascending survivors.  ``q``'s order statistic is ``floor(q * (n - 1))``
(numpy's ``method="lower"``), so every answer is an element of the column.
At q near 1 the survivors are most of the column, and ordering them is
most of a sort.

Histograms search explicit float32 bin edges (bin of x = the edge interval
holding it, rightmost bin closed, ``np.histogram``'s rule); the edges are
part of the result.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import keycodec
from repro_torch.relational import _core
from repro_torch.relational.relspec import RelSpec


class HistogramSketch(NamedTuple):
    """``counts[b]`` (int32) = #elements in ``[edges[b], edges[b+1])``
    (the last bin closed on the right); ``edges`` is (num_bins + 1,)
    float32."""
    counts: torch.Tensor
    edges: torch.Tensor


class QuantileSketch(NamedTuple):
    """``values[i]`` is the ``qs[i]`` quantile (an element of the column,
    the lower order statistic)."""
    values: torch.Tensor


def run_histogram(spec: RelSpec, x: torch.Tensor) -> HistogramSketch:
    bins = spec.num_bins
    n = x.shape[0]
    dev = x.device

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    sp = _core.span(spec, n)
    with sp:
        xf = x.to(torch.float32)
        lo = scalar(spec.lo) if spec.lo is not None \
            else (xf.min() if n else scalar(0.0))
        hi = scalar(spec.hi) if spec.hi is not None \
            else (xf.max() if n else scalar(1.0))
        # a NaN-holding column's min/max is NaN: the reference's bits
        # (0x7FC00000, XLA's reductions), not torch's all-ones
        lo, hi = (torch.where(torch.isnan(v), scalar(float("nan")), v)
                  for v in (lo, hi))
        hi = torch.where(hi > lo, hi, lo + 1.0)     # degenerate range guard
        edges = lo + (hi - lo) * (
            torch.arange(bins + 1, dtype=torch.float32, device=dev) / bins)
        idx = (torch.searchsorted(edges, xf, side="right") - 1
               ).clamp(0, bins - 1)
        inside = (xf >= lo) & (xf <= edges[-1])
        # values outside [lo, hi] land in one extra bin, dropped: a
        # bincount, not atomic adds of every element on a few counters
        counts = torch.bincount(torch.where(inside, idx, bins),
                                minlength=bins + 1)[:bins].to(torch.int32)
        out = HistogramSketch(counts=counts, edges=edges)
        sp.fence(out.counts)
    _core.finish(sp, spec, None, n)
    return out


def run_quantile(spec: RelSpec, x: torch.Tensor) -> QuantileSketch:
    from repro_torch.kernels import radix_select
    n = x.shape[0]
    # lower order statistic per fraction; k = the largest one to reach
    ords = [int(q * (n - 1)) for q in spec.qs]
    k = max(ords) + 1
    sp = _core.span(spec, n)
    with sp:
        enc = keycodec.encode(x)
        kth, _ = radix_select.select_topk_encoded(enc[None, :], k)
        # the ascending survivors: position j IS the j-th order statistic
        pick = torch.tensor(ords, dtype=torch.int64, device=x.device)
        out = QuantileSketch(values=keycodec.decode(kth[0, pick], x.dtype))
        sp.fence(out.values)
    _core.finish(sp, spec, None, n)
    return out
