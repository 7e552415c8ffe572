"""repro_torch.sort — the one front door for every sort of the port.

A sort problem is a :class:`~repro_torch.core.sortspec.SortSpec`; running
one is ``run(spec, x, device=...)``.  The wrappers build the spec::

    import repro_torch.sort as rsort

    rsort.sort(x)                                  # auto plan, on the card
    rsort.sort(x, method="radix", descending=True)
    rsort.argsort(x, stable=True)
    rsort.topk(logits, 50)                         # (values, indices)
    rsort.topk(logits, 50, method="select")        # radix select (K4)
    rsort.sort_kv(keys, payload, device="cpu")     # plain versions, CPU
    rsort.segment_sort(x, segment_ids=seg)         # ragged groups
    rsort.sort(batch, valid_lengths=lengths)       # padded rows
    rsort.sort(huge_host_keys)                     # > 4 GiB: spill tier
    rsort.sort(x, mesh=mesh)                       # mesh-global sort

Validation happens once, at the spec layer; execution is
``repro_torch.engine``'s.  Every entry point takes ``device=`` (default
``"cuda"``), moves its input there and returns on it; ``device="cuda"``
without a card raises ``RuntimeError``.  A sort planned onto the spill
tier (``method="spill"``, or ``auto`` above the profile's
``spill_threshold_bytes``) leaves its input where it is and returns a CPU
tensor.  A spec with ``mesh`` (``core.mesh.Mesh``) runs on the mesh's
devices, whatever ``device`` says, and returns on its first entry's.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core import keycodec
from repro_torch.core.sortspec import (  # noqa: F401  (public re-exports)
    Capabilities, SortBackend, SortSpec, backend_names, get_backend,
    register_backend, registered_backends, sort_defaults, unregister_backend)
from repro_torch.engine.planner import clear_plan_cache  # noqa: F401

__all__ = [
    "run", "sort", "argsort", "topk", "sort_kv", "segment_sort",
    "SortSpec", "Capabilities", "SortBackend", "register_backend",
    "unregister_backend", "registered_backends", "backend_names",
    "get_backend", "sort_defaults", "clear_plan_cache",
]

_T = torch.Tensor


def _gather(t, order: _T) -> _T:
    """``t`` permuted along its last axis by ``order``, on its device."""
    t = torch.as_tensor(t).to(order.device)
    out = keycodec.to_signed(t).gather(-1, order.to(torch.int64))
    return keycodec.from_signed(out, t.dtype)


def run(spec: SortSpec, x, *, device="cuda") -> Union[_T, Tuple[_T, _T]]:
    """Execute ``spec`` on ``x``.  Returns, by spec shape:

      plain sort           sorted tensor
      ``indices=True``     the sorting permutation (int32)
      ``values`` payload   (sorted keys, permuted payload)
      ``k`` set            (top-k values, int32 indices), descending
      ``segment_ids`` /    (sorted values, grouped segment ids); with
      ``row_splits``       ``indices``/``values`` as a plain sort does
      ``valid_lengths``    padded rows, valid prefixes sorted

    With ``mesh`` the sort is mesh-global (the ``distributed`` backend:
    sample sort, odd-even or the two-level schedule, planner-priced) and
    the result lies on the mesh's first entry's device.
    """
    from repro_torch import engine
    x = torch.as_tensor(x)
    spec = spec.canonical(x)
    if spec.mesh is not None:
        be = get_backend("distributed")
        if spec.k is not None:
            return be.topk_mesh(x, spec.k, spec.mesh, spec.axis_name)
        if spec.indices:
            return be.argsort_mesh(x, spec.mesh, spec.axis_name,
                                   descending=spec.descending)
        return be.sort_mesh(x, spec.mesh, spec.axis_name,
                            values=spec.values, descending=spec.descending)
    if spec.valid_lengths is not None:
        if spec.indices or spec.values is not None:
            raise ValueError("valid_lengths supports value sorts only")
        if x.dim() != 2 or spec.axis != 1:
            raise ValueError("valid_lengths expects a padded (rows, L) "
                             "batch sorted along the last axis")
        return engine.sort_padded_rows(
            x, spec.valid_lengths, descending=spec.descending,
            method=spec.method, fill_value=spec.fill_value,
            run_len=spec.run_len, device=device)
    if spec.segment_ids is not None or spec.row_splits is not None:
        if spec.axis != x.dim() - 1:
            raise ValueError("segmented sort runs along the last axis")
        seg = spec.segment_ids
        if seg is None:
            seg = engine.segment_ids_from_row_splits(
                spec.row_splits, x.shape[spec.axis], device=device)
        if spec.indices or spec.values is not None:
            order = engine.segmented_argsort(
                x, seg, descending=spec.descending, method=spec.method,
                run_len=spec.run_len, device=device)
            if spec.indices:
                return order
            return _gather(x, order), _gather(spec.values, order)
        return engine.segmented_sort(
            x, seg, descending=spec.descending, method=spec.method,
            run_len=spec.run_len, device=device)
    if spec.k is not None:
        ax = spec.axis
        if ax != x.dim() - 1:
            x = torch.movedim(x, ax, -1)
        v, i = engine.topk(x, spec.k, method=spec.method,
                           run_len=spec.run_len, device=device)
        if ax != v.dim() - 1:
            v, i = torch.movedim(v, -1, ax), torch.movedim(i, -1, ax)
        return v, i
    if spec.indices:
        return engine.argsort(x, axis=spec.axis, descending=spec.descending,
                              method=spec.method, stable=spec.stable,
                              run_len=spec.run_len, device=device)
    if spec.values is not None:
        return engine.sort_kv(x, spec.values, axis=spec.axis,
                              descending=spec.descending, method=spec.method,
                              stable=spec.stable, run_len=spec.run_len,
                              device=device)
    return engine.sort(x, axis=spec.axis, descending=spec.descending,
                       method=spec.method, run_len=spec.run_len,
                       device=device)


def sort(x, *, axis: int = -1, descending: bool = False,
         method: Optional[str] = None, run_len: Optional[int] = None,
         valid_lengths=None, fill_value=0, mesh=None,
         axis_name: Optional[str] = None, device="cuda") -> _T:
    """Sort along ``axis``; with ``valid_lengths``, sort each row's valid
    prefix of a padded (rows, L) batch and write ``fill_value`` over the
    tail (the scheduler's fixed-shape buckets).  With ``mesh``/
    ``axis_name`` a flat tensor is sorted globally over the mesh (the
    sample sort; ``axis_name=None`` spans every axis, taking the
    two-level schedule on a two-axis mesh; odd-even for small sorts on
    one axis)."""
    return run(SortSpec(axis=axis, descending=descending, method=method,
                        run_len=run_len, valid_lengths=valid_lengths,
                        fill_value=fill_value, mesh=mesh,
                        axis_name=axis_name), x, device=device)


def argsort(x, *, axis: int = -1, descending: bool = False,
            stable: bool = False, method: Optional[str] = None,
            run_len: Optional[int] = None, mesh=None,
            axis_name: Optional[str] = None, device="cuda") -> _T:
    """The sorting permutation (ties keep ascending index order in both
    directions on every backend; ``stable=True`` forces a stable
    pipeline).  With ``mesh`` the permutation of a mesh-global sort
    (int32 global positions; the mesh sort is stable)."""
    return run(SortSpec(axis=axis, descending=descending, stable=stable,
                        indices=True, method=method, run_len=run_len,
                        mesh=mesh, axis_name=axis_name), x, device=device)


def topk(x, k: int, *, axis: int = -1, method: Optional[str] = None,
         run_len: Optional[int] = None, mesh=None,
         axis_name: Optional[str] = None, device="cuda") -> Tuple[_T, _T]:
    """Top-k along ``axis`` -> (values, indices), descending, the lower
    index first among equal keys; 1 <= k <= n or ValueError.  The plan is
    k-aware: ``auto`` weighs radix selection (``select``, K4) against
    ``cuda``'s bitonic top-k (K5) and sort-prefix on the other backends.
    ``select`` and ``torch`` rank +0.0 above -0.0 (``lax.top_k``);
    ``cuda`` and the other network backends compare numerically.  With
    ``mesh`` a flat tensor is selected globally: a radix select a shard
    and ONE candidate all-gather, ``lax.top_k``'s bits (indices are
    global positions)."""
    return run(SortSpec(axis=axis, k=k, descending=True, method=method,
                        run_len=run_len, mesh=mesh, axis_name=axis_name),
               x, device=device)


def sort_kv(keys, values, *, axis: int = -1, descending: bool = False,
            stable: bool = False, method: Optional[str] = None,
            run_len: Optional[int] = None, mesh=None,
            axis_name: Optional[str] = None, device="cuda"
            ) -> Tuple[_T, _T]:
    """Sort ``keys`` carrying ``values`` -> (sorted keys, permuted values);
    with ``mesh`` globally over the mesh (the payload rides the
    exchanges)."""
    return run(SortSpec(axis=axis, descending=descending, stable=stable,
                        values=torch.as_tensor(values), method=method,
                        run_len=run_len, mesh=mesh, axis_name=axis_name),
               keys, device=device)


def segment_sort(values, *, segment_ids=None, row_splits=None,
                 descending: bool = False, method: Optional[str] = None,
                 indices: bool = False, device="cuda"):
    """Sort within ragged groups (flat values + segment ids or row
    splits).  Returns (sorted values, grouped segment ids), or just the
    grouping permutation with ``indices=True``."""
    if segment_ids is None and row_splits is None:
        raise ValueError("segment_sort needs segment_ids or row_splits")
    return run(SortSpec(descending=descending, method=method,
                        segment_ids=segment_ids, row_splits=row_splits,
                        indices=indices), values, device=device)
