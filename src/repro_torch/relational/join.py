"""Sorted equi-join: sort both sides, merge-scan with duplicate expansion.

Both key columns are stably sorted, each left element binary-searches its
matching run on the right (the merge-scan), and the cross product of
duplicates is expanded by rank arithmetic: every step a gather.

Pair order (the JAX package's contract): pairs ascend by key; within a
key, left occurrences in input order; within one left occurrence, right
occurrences in input order.  Results are padded to ``size`` (default
``n_l * n_r``) with ``fill_value`` (default -1), plus the true
``n_pairs``; a count larger than ``size`` raises rather than truncate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.relational import _core
from repro_torch.relational.relspec import RelSpec


class Join(NamedTuple):
    """``(left_idx[:n_pairs], right_idx[:n_pairs])`` (int32) enumerate the
    matching pairs by input position; the tail holds ``fill_value``."""
    left_idx: torch.Tensor
    right_idx: torch.Tensor
    n_pairs: torch.Tensor                 # int32 scalar


def run(spec: RelSpec, lk: torch.Tensor, rk: torch.Tensor) -> Join:
    nl, nr = lk.shape[0], rk.shape[0]
    dev = lk.device
    size = spec.size if spec.size is not None else max(nl * nr, 1)
    fill = -1 if spec.fill_value is None else spec.fill_value
    if nl == 0 or nr == 0:
        pad = torch.full((size,), fill, device=dev).to(torch.int32)
        return Join(pad, pad.clone(),
                    torch.zeros((), dtype=torch.int32, device=dev))
    method, plan = _core.resolve_plan(spec, max(nl, nr), lk.dtype, dev)
    sp = _core.span(spec, nl + nr)
    with sp:
        ol = _core.stable_order(lk, method, spec).to(torch.int64)
        sl = _core.search_key(lk)[ol]
        orr = _core.stable_order(rk, method, spec).to(torch.int64)
        sr = _core.search_key(rk)[orr]
        # merge-scan: each left-sorted element's matching run on the right
        # (in the search order: -0.0 matches +0.0, NaN matches NaN)
        start = torch.searchsorted(sr, sl, side="left")
        stop = torch.searchsorted(sr, sl, side="right")
        off = torch.cumsum(stop - start, 0)         # inclusive pair offsets
        n_pairs = off[-1]
        # duplicate-pair expansion: pair t belongs to the left-sorted
        # element li with off[li-1] <= t < off[li]; its right partner is
        # the (t - off[li-1])-th element of li's run
        t = torch.arange(size, dtype=torch.int64, device=dev)
        li = torch.searchsorted(off, t, side="right").clamp(0, nl - 1)
        prev = torch.where(li > 0, off[(li - 1).clamp(min=0)], 0)
        ri = (start[li] + (t - prev)).clamp(0, nr - 1)
        valid = t < n_pairs
        out = Join(left_idx=torch.where(valid, ol[li], fill).to(torch.int32),
                   right_idx=torch.where(valid, orr[ri], fill
                                         ).to(torch.int32),
                   n_pairs=n_pairs.to(torch.int32))
        sp.fence(out.left_idx)
    _core.finish(sp, spec, plan, nl + nr)
    concrete = int(out.n_pairs)
    if concrete > size:
        raise ValueError(
            f"join produced {concrete} pairs but size={size}; pass "
            f"size >= {concrete} (the padded output would truncate)")
    return out
