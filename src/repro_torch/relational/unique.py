"""Dedup / unique: sort -> adjacent-diff mask -> searchsorted compaction.

``np.unique`` semantics under the static-shape contract: the distinct
values come back ascending in a fixed (n,)-shaped tensor with a valid
count, plus optional inverse indices and per-value counts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import keycodec
from repro_torch.relational import _core
from repro_torch.relational.relspec import RelSpec


class Unique(NamedTuple):
    """``values[:n_unique]`` is ``np.unique(x)``; the tail holds
    ``fill_value`` (or repeats the maximum when fill_value is None, which
    keeps ``values`` non-decreasing).  ``inverse`` (optional, int32) maps
    each input position to its slot in ``values``; ``counts`` (optional,
    int32) is the multiplicity of each slot, 0 past ``n_unique``."""
    values: torch.Tensor
    n_unique: torch.Tensor                # int32 scalar
    inverse: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None


def run(spec: RelSpec, x: torch.Tensor) -> Unique:
    n = x.shape[0]
    if n == 0:
        def z():
            return torch.zeros((0,), dtype=torch.int32, device=x.device)
        return Unique(values=x,
                      n_unique=torch.zeros((), dtype=torch.int32,
                                           device=x.device),
                      inverse=z() if spec.return_inverse else None,
                      counts=z() if spec.return_counts else None)
    method, plan = _core.resolve_plan(spec, n, x.dtype, x.device)
    sp = _core.span(spec, n)
    with sp:
        s = keycodec.to_signed(_core.sorted_column(x, method))
        uvals, n_unique, _, lengths = _core.compact_sorted(
            s, _core.boundary_mask(s))
        inverse = None
        if spec.return_inverse:
            # uvals is non-decreasing (the tail repeats the max) and every
            # value of x is in its valid prefix: one binary search finds
            # each element's slot
            inverse = torch.searchsorted(uvals, keycodec.to_signed(x),
                                         side="left", out_int32=True)
        values = keycodec.from_signed(uvals, x.dtype)
        if spec.fill_value is not None:
            values = _core.pad_tail(values, _core.valid_mask(n_unique, n),
                                    spec.fill_value)
        out = Unique(
            values=values, n_unique=n_unique, inverse=inverse,
            # a slot's multiplicity is its run's length (the JAX package
            # counts the inverse indices: the same numbers)
            counts=lengths if spec.return_counts else None)
        sp.fence(out.values)
    _core.finish(sp, spec, plan, n)
    return out
