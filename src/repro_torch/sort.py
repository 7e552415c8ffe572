"""repro_torch.sort — the one front door for every sort of the port.

A sort problem is a :class:`~repro_torch.core.sortspec.SortSpec`; running
one is ``run(spec, x, device=...)``.  The wrappers build the spec::

    import repro_torch.sort as rsort

    rsort.sort(x)                                  # auto plan, on the card
    rsort.sort(x, method="radix", descending=True)
    rsort.argsort(x, stable=True)
    rsort.topk(logits, 50)                         # (values, indices)
    rsort.sort_kv(keys, payload, device="cpu")     # plain versions, CPU

Validation happens once, at the spec layer; execution is
``repro_torch.engine``'s.  Every entry point takes ``device=`` (default
``"cuda"``), moves its input there and returns on it; ``device="cuda"``
without a card raises ``RuntimeError``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.sortspec import (  # noqa: F401  (public re-exports)
    Capabilities, SortBackend, SortSpec, backend_names, get_backend,
    register_backend, registered_backends, sort_defaults, unregister_backend)
from repro_torch.engine.planner import clear_plan_cache  # noqa: F401

__all__ = [
    "run", "sort", "argsort", "topk", "sort_kv",
    "SortSpec", "Capabilities", "SortBackend", "register_backend",
    "unregister_backend", "registered_backends", "backend_names",
    "get_backend", "sort_defaults", "clear_plan_cache",
]

_T = torch.Tensor


def run(spec: SortSpec, x, *, device="cuda") -> Union[_T, Tuple[_T, _T]]:
    """Execute ``spec`` on ``x``.  Returns, by spec shape:

      plain sort           sorted tensor
      ``indices=True``     the sorting permutation (int32)
      ``values`` payload   (sorted keys, permuted payload)
      ``k`` set            (top-k values, int32 indices), descending
    """
    from repro_torch import engine
    x = torch.as_tensor(x)
    spec = spec.canonical(x)
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
         valid_lengths=None, mesh=None, axis_name: Optional[str] = None,
         device="cuda") -> _T:
    """Sort along ``axis``.  ``valid_lengths`` and ``mesh``/``axis_name``
    are the JAX package's padded-row and distributed forms; they raise
    ``NotImplementedError`` until their ROADMAP items land."""
    return run(SortSpec(axis=axis, descending=descending, method=method,
                        run_len=run_len, valid_lengths=valid_lengths,
                        mesh=mesh, axis_name=axis_name), x, device=device)


def argsort(x, *, axis: int = -1, descending: bool = False,
            stable: bool = False, method: Optional[str] = None,
            run_len: Optional[int] = None, device="cuda") -> _T:
    """The sorting permutation (ties keep ascending index order in both
    directions on every backend; ``stable=True`` forces a stable
    pipeline)."""
    return run(SortSpec(axis=axis, descending=descending, stable=stable,
                        indices=True, method=method, run_len=run_len),
               x, device=device)


def topk(x, k: int, *, axis: int = -1, method: Optional[str] = None,
         run_len: Optional[int] = None, mesh=None,
         axis_name: Optional[str] = None, device="cuda") -> Tuple[_T, _T]:
    """Top-k along ``axis`` -> (values, indices), descending, the lower
    index first among equal keys; 1 <= k <= n or ValueError."""
    return run(SortSpec(axis=axis, k=k, descending=True, method=method,
                        run_len=run_len, mesh=mesh, axis_name=axis_name),
               x, device=device)


def sort_kv(keys, values, *, axis: int = -1, descending: bool = False,
            stable: bool = False, method: Optional[str] = None,
            run_len: Optional[int] = None, mesh=None,
            axis_name: Optional[str] = None, device="cuda"
            ) -> Tuple[_T, _T]:
    """Sort ``keys`` carrying ``values`` -> (sorted keys, permuted values)."""
    return run(SortSpec(axis=axis, descending=descending, stable=stable,
                        values=torch.as_tensor(values), method=method,
                        run_len=run_len, mesh=mesh, axis_name=axis_name),
               keys, device=device)
