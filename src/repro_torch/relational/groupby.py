"""Group-by aggregate: stable key-value sort -> boundary flags -> segment
reductions; and ``group_ranks``, the MoE dispatch primitive.

The reductions follow the JAX package's ``jax.ops.segment_*`` bit for bit:

* integer ``sum`` wraps in the column's dtype: it is summed in int64 (an
  integer sum is the same in any order) and cut back to the dtype;
* float ``sum`` and ``mean``'s float32 sum add each contiguous run of the
  stably sorted values in order (``torch.segment_reduce`` over an (n, 1)
  column), on the card as on the CPU, never a float ``index_add_``
  (atomics on the card, whose order changes from run to run);
* ``min``/``max`` reduce an integer key in the IEEE total order
  (``keycodec.total_order_key``), so a group holding -0.0 and +0.0 gives
  -0.0 for ``min`` and +0.0 for ``max``, XLA's rule, in either order;
* ``count`` is each run's length, and ``mean`` the float32 sum over
  ``max(count, 1)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.relational import _core
from repro_torch.relational.relspec import RelSpec, is_integer

# one-hot counting stays cheaper than a sort pipeline while the O(n * G)
# one-hot tensor is small; past this domain the flat path sorts instead
ONE_HOT_MAX_GROUPS = 512


class GroupBy(NamedTuple):
    """``keys[:n_groups]`` are the distinct keys ascending; ``aggregates``
    holds one (n,)-shaped column per requested reduction (in ``agg``'s
    order), valid to ``n_groups`` and padded with ``fill_value`` (default
    0) past it."""
    keys: torch.Tensor
    n_groups: torch.Tensor                # int32 scalar
    aggregates: Tuple[torch.Tensor, ...]


class GroupRanks(NamedTuple):
    """``ranks`` is each element's 0-based arrival order within its key
    group (the input's shape); ``counts`` is (..., num_groups) group
    sizes."""
    ranks: torch.Tensor
    counts: torch.Tensor


def _segment_sum(v: torch.Tensor, seg: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Per-run sums of the sorted values ``v`` in ``v``'s dtype, run i
    ``lengths[i]`` long (0 for the empty runs past the last); ``seg`` is
    each value's run, int64."""
    if is_integer(v.dtype):
        acc = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
        acc.index_add_(0, seg, v.to(torch.int64))
        # int64 -> a narrower integer keeps the low bits: the dtype's wrap
        return acc.to(v.dtype)
    # the runs are contiguous: each summed in its order, one after
    # another, from 0 -- XLA's segment_sum bits.  As an (n, 1) column
    # segment_reduce gives a run to one thread on the card too (the 1-D
    # form runs a block-wide tree a run there: other bits, and ~50x slower
    # over 15 M short runs)
    return torch.segment_reduce(v[:, None], "sum", lengths=lengths, axis=0,
                                unsafe=True)[:, 0]


def _segment_extreme(v: torch.Tensor, seg: torch.Tensor, n: int,
                     agg: str) -> torch.Tensor:
    """Per-run min or max in the IEEE total order (-0.0 below +0.0)."""
    key = keycodec.total_order_key(v) if v.dtype.is_floating_point else v
    out = torch.zeros(n, dtype=torch.int64, device=v.device)
    out.scatter_reduce_(0, seg, key.to(torch.int64),
                        "amin" if agg == "min" else "amax",
                        include_self=False)
    if not v.dtype.is_floating_point:
        return out.to(v.dtype)
    carrier = keycodec.key_dtype(v.dtype)
    return keycodec.decode(out.to(carrier) ^ torch.iinfo(carrier).min,
                           v.dtype)


def _aggregate(sv: torch.Tensor, seg: torch.Tensor, lengths: torch.Tensor,
               aggs, valid: torch.Tensor, fill) -> Tuple[torch.Tensor, ...]:
    """Segment reductions over the sorted values, one column per agg."""
    n = sv.shape[0]
    seg = seg.to(torch.int64)
    fill = 0 if fill is None else fill
    outs = []
    for a in aggs:
        if a == "sum":
            r = _segment_sum(sv, seg, lengths)
        elif a in ("min", "max"):
            r = _segment_extreme(sv, seg, n, a)
        elif a == "count":
            r = lengths
        else:  # mean: the float32 sum over the count, as in the reference
            s = _segment_sum(sv.to(torch.float32), seg, lengths)
            r = s / lengths.clamp(min=1).to(torch.float32)
        outs.append(_core.pad_tail(r, valid, fill))
    return tuple(outs)


def run(spec: RelSpec, keys: torch.Tensor, values: torch.Tensor) -> GroupBy:
    n = keys.shape[0]
    if n == 0:
        empty = tuple(
            torch.zeros((0,), device=keys.device,
                        dtype=torch.int32 if a == "count"
                        else torch.float32 if a == "mean" else values.dtype)
            for a in spec.agg)
        return GroupBy(keys=keys,
                       n_groups=torch.zeros((), dtype=torch.int32,
                                            device=keys.device),
                       aggregates=empty)
    method, plan = _core.resolve_plan(spec, n, keys.dtype, keys.device)
    sp = _core.span(spec, n)
    with sp:
        # the stable sort fixes each group's summation order (input order)
        sk, sv = _core.sorted_column(keys, method, values=values)
        s = keycodec.to_signed(sk)
        ukeys, n_groups, seg, lengths = _core.compact_sorted(
            s, _core.boundary_mask(s))
        valid = _core.valid_mask(n_groups, n)
        aggs = _aggregate(sv, seg, lengths, spec.agg, valid, spec.fill_value)
        ukeys = keycodec.from_signed(ukeys, keys.dtype)
        if spec.fill_value is not None:
            ukeys = _core.pad_tail(ukeys, valid, spec.fill_value)
        out = GroupBy(keys=ukeys, n_groups=n_groups, aggregates=aggs)
        sp.fence(out.keys)
    _core.finish(sp, spec, plan, n)
    return out


def run_group_ranks(spec: RelSpec, keys: torch.Tensor,
                    constrain: Optional[Callable] = None) -> GroupRanks:
    """Arrival rank within each key group.  Small domains (and any batched
    input) use the one-hot counting sort, an O(n * num_groups) exclusive
    cumsum (``constrain``, if given, is applied to the one-hot); a key
    outside ``[0, num_groups)`` has an all-zero one-hot row, as in
    ``jax.nn.one_hot``.  Large flat domains ride the stable sort: rank =
    sorted position - the start of its group."""
    g = spec.num_groups
    n = keys.shape[-1]
    dev = keys.device
    sp = _core.span(spec, keys.numel())
    with sp:
        if keys.dim() > 1 or g <= ONE_HOT_MAX_GROUPS or n == 0:
            onehot = (keys.to(torch.int64)[..., None]
                      == torch.arange(g, device=dev)).to(torch.int32)
            if constrain is not None:
                onehot = constrain(onehot)
            # (..., g, n): the running count runs along the last axis,
            # which the card scans in parallel (along the middle axis it is
            # one thread a column)
            oh = onehot.transpose(-1, -2).contiguous()
            before = oh.cumsum(-1, dtype=torch.int32) - oh
            ranks = (before * oh).sum(-2, dtype=torch.int32)
            counts = oh.sum(-1, dtype=torch.int32)
        else:
            order = _core.stable_order(keys, spec.method).to(torch.int64)
            sk = keycodec.to_signed(keys)[order]
            pos = torch.arange(n, dtype=torch.int32, device=dev)
            # a group's start is the first sorted position of its key: one
            # binary search each, no scatter
            starts = torch.searchsorted(sk, sk, side="left", out_int32=True)
            ranks = torch.empty_like(pos).scatter_(0, order, pos - starts)
            counts = torch.bincount(
                keys.to(torch.int64).clamp(0, g - 1), minlength=g
            ).to(torch.int32)
        sp.fence(ranks)
    _core.finish(sp, spec, None, n)
    return GroupRanks(ranks=ranks, counts=counts)
