"""Segmented sort over ragged row groups.

Serving length buckets and MoE expert groups both need "sort within each
group", where groups are ragged: a flat token stream plus segment ids (or
row splits).  Done as a composite two-pass sort:

  1. order the values with the engine (any backend, need not be stable);
  2. stably re-order that permutation by segment id, so groups come out
     contiguous and each group's interior stays value-sorted.

The stable second pass is the engine's stable argsort: on a card, the
radix kernels (K3) directly or as the runs of the merge path (K2 merges).

The padded-batch variant (``sort_padded_rows``) covers the scheduler's
fixed-shape buckets: rows valid up to ``lengths[i]``, tail rewritten after
the sort.

Every function takes ``device=`` (default ``"cuda"``), moves its inputs
there and returns on it, like the rest of the engine.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec, sortspec


def _resolve(method: Optional[str]) -> str:
    """None -> the ambient ``sort_defaults`` method, default "auto"."""
    if method is not None:
        return method
    return sortspec.default("method") or "auto"


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(sortspec.resolve_device(device))


def segment_ids_from_row_splits(row_splits, n: int, *,
                                device="cuda") -> torch.Tensor:
    """[0, 3, 5, n] -> [0,0,0,1,1,2,...]: dense int32 ids from
    boundaries."""
    splits = _on(row_splits, device)
    pos = torch.arange(n, dtype=splits.dtype, device=splits.device)
    return (torch.searchsorted(splits, pos, right=True) - 1).to(torch.int32)


def segmented_argsort(values, segment_ids, *, descending: bool = False,
                      method: Optional[str] = None,
                      run_len: Optional[int] = None,
                      device="cuda") -> torch.Tensor:
    """Permutation grouping ``values`` by segment, value-sorted per group.

    ``values`` and ``segment_ids`` are flat (n,) or batched (..., n); the
    segment ids need not be non-decreasing — groups need not be contiguous
    on input; they are contiguous, in ascending segment-id order, in the
    output permutation."""
    from repro_torch import engine
    method = _resolve(method)
    values, segment_ids = _on(values, device), _on(segment_ids, device)
    order1 = engine.argsort(values, method=method, descending=descending,
                            run_len=run_len, device=device)
    seg1 = segment_ids.gather(-1, order1.to(torch.int64))
    order2 = engine.argsort(seg1, method=method, stable=True,
                            run_len=run_len, device=device)
    return order1.gather(-1, order2.to(torch.int64))


def segmented_sort(values, segment_ids, *, descending: bool = False,
                   method: Optional[str] = None,
                   run_len: Optional[int] = None, device="cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted values, grouped segment ids), groups contiguous and
    ascending."""
    values, segment_ids = _on(values, device), _on(segment_ids, device)
    order = segmented_argsort(values, segment_ids, descending=descending,
                              method=method, run_len=run_len,
                              device=device).to(torch.int64)
    out = keycodec.to_signed(values).gather(-1, order)
    return keycodec.from_signed(out, values.dtype), \
        segment_ids.gather(-1, order)


def sort_padded_rows(values, lengths, *, descending: bool = False,
                     method: Optional[str] = None, fill_value=0,
                     run_len: Optional[int] = None,
                     device="cuda") -> torch.Tensor:
    """Sort each row's valid prefix of a padded (rows, L) batch.

    Positions >= lengths[row] are padding: they carry the direction's
    sentinel through the sort, which parks them past the valid prefix,
    and are rewritten with ``fill_value`` afterwards, so the ragged layout
    is preserved."""
    from repro_torch import engine
    from repro_torch.kernels.ops import sentinel
    values, lengths = _on(values, device), _on(lengths, device)
    dtype = values.dtype
    # uint16/uint32 ride as order-preserving signed keys, as in the engine
    v = keycodec.to_signed(values)
    fill = keycodec.to_signed(torch.full((1,), fill_value, dtype=dtype,
                                         device=v.device))[0]
    pos = torch.arange(v.shape[-1], device=v.device)[None, :]
    valid = pos < lengths[:, None]
    masked = torch.where(valid, v, torch.full(
        (), sentinel(v.dtype, descending), dtype=v.dtype, device=v.device))
    out = engine.sort(masked, method=_resolve(method), descending=descending,
                      run_len=run_len, device=device)
    return keycodec.from_signed(torch.where(valid, out, fill), dtype)


def group_tokens_by_expert(expert_ids, num_experts: int, *,
                           method: Optional[str] = None, device="cuda"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE dispatch order: (permutation, row_splits) grouping tokens by
    expert.  The permutation is stable (tokens keep arrival order inside
    each expert group), which capacity-truncation policies assume.  The
    splits count ids as ``jnp.bincount(length=num_experts)`` does: a
    negative id counts as expert 0, an id past the last is dropped."""
    from repro_torch import engine
    expert_ids = _on(expert_ids, device)
    perm = engine.argsort(expert_ids, method=_resolve(method), stable=True,
                          device=device)
    # ids past the last expert land in a throwaway count
    ids = expert_ids.reshape(-1).to(torch.int64).clamp(0, num_experts)
    counts = torch.zeros(num_experts + 1, dtype=torch.int32,
                         device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int32))[:num_experts]
    return perm, torch.cat([counts.new_zeros(1),
                            torch.cumsum(counts, 0, dtype=torch.int32)])
