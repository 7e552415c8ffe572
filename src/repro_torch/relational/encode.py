"""Run-length and delta encoding of sorted columns.

Both encoders sort their input first (through the planner-picked backend)
unless ``assume_sorted=True``.  RLE round-trips any dtype; delta encoding
is integer-only: modular differences and prefix sums in the column's own
dtype round-trip bit-exactly even through wraparound (computed in int64,
whose low bits are the dtype's, and cut back).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import keycodec
from repro_torch.relational import _core
from repro_torch.relational.relspec import RelSpec


class RunLength(NamedTuple):
    """``values[:n_runs]`` / ``run_lengths[:n_runs]`` describe the runs in
    order; the tails hold ``fill_value`` (default: values repeat the max)
    and 0."""
    values: torch.Tensor
    run_lengths: torch.Tensor             # int32
    n_runs: torch.Tensor                  # int32 scalar


class Delta(NamedTuple):
    """``deltas[0]`` is the first (smallest) element; ``deltas[i]`` the
    modular difference from its predecessor in the sorted column."""
    deltas: torch.Tensor


def run_rle(spec: RelSpec, x: torch.Tensor) -> RunLength:
    n = x.shape[0]
    if n == 0:
        return RunLength(
            values=x, run_lengths=torch.zeros((0,), dtype=torch.int32,
                                              device=x.device),
            n_runs=torch.zeros((), dtype=torch.int32, device=x.device))
    method, plan = _core.resolve_plan(spec, n, x.dtype, x.device)
    sp = _core.span(spec, n)
    with sp:
        s = x if spec.assume_sorted else _core.sorted_column(x, method)
        s = keycodec.to_signed(s)
        vals, n_runs, _, lengths = _core.compact_sorted(
            s, _core.boundary_mask(s))
        values = keycodec.from_signed(vals, x.dtype)
        if spec.fill_value is not None:
            values = _core.pad_tail(values, _core.valid_mask(n_runs, n),
                                    spec.fill_value)
        out = RunLength(values=values, run_lengths=lengths, n_runs=n_runs)
        sp.fence(out.values)
    _core.finish(sp, spec, plan, n)
    return out


def rle_decode(values: torch.Tensor, run_lengths: torch.Tensor,
               n: int) -> torch.Tensor:
    """Rebuild the (sorted) column of length ``n`` from its runs, on the
    runs' device."""
    ends = torch.cumsum(run_lengths, 0, dtype=torch.int32)
    idx = torch.searchsorted(
        ends, torch.arange(n, dtype=torch.int32, device=ends.device),
        side="right")
    idx = idx.clamp(0, max(values.shape[0] - 1, 0))
    return keycodec.from_signed(keycodec.to_signed(values)[idx],
                                values.dtype)


def run_delta(spec: RelSpec, x: torch.Tensor) -> Delta:
    n = x.shape[0]
    if n == 0:
        return Delta(deltas=x)
    method, plan = _core.resolve_plan(spec, n, x.dtype, x.device)
    sp = _core.span(spec, n)
    with sp:
        s = x if spec.assume_sorted else _core.sorted_column(x, method)
        w = s.to(torch.int64)
        # int64 -> the column's dtype keeps the low bits: modular deltas
        d = torch.cat([w[:1], w[1:] - w[:-1]]).to(x.dtype)
        sp.fence(d)
    _core.finish(sp, spec, plan, n)
    return Delta(deltas=d)


def delta_decode(deltas: torch.Tensor) -> torch.Tensor:
    """Modular prefix sum in the column's own dtype: the exact inverse of
    ``run_delta``."""
    return torch.cumsum(deltas.to(torch.int64), 0).to(deltas.dtype)
