"""Legacy public sorting API — deprecation shims over ``repro_torch.sort``.

The JAX package's original string-dispatched front door, kept so its call
forms work on the port: each shim warns once per form (a
``DeprecationWarning``) and forwards to :mod:`repro_torch.sort`, the
``SortSpec`` front door, with ``device=`` passed through (default the
card).  Method names are the port's (``repro_torch.BACKEND_NAMES``: the
JAX package's ``xla`` is ``torch``, ``pallas`` is ``cuda``).

Tie convention (unchanged): ``argsort`` ties keep *ascending* index order
in both directions on every backend.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import torch

# the v1 method strings ("auto" plus the built-in backends) under the
# port's names; the live list is repro_torch.core.sortspec.backend_names()
METHODS = ("torch", "bitonic", "cuda", "imc", "merge", "radix", "auto")

_warned: set = set()


def _deprecated(name: str, instead: str = "") -> None:
    if name not in _warned:
        _warned.add(name)
        warnings.warn(
            f"repro_torch.core.sort_api.{name} is deprecated; use "
            f"{instead or 'repro_torch.sort.' + name} (SortSpec front door) "
            f"instead", DeprecationWarning, stacklevel=3)


def bitonic_sort(x, *, axis: int = -1, descending: bool = False,
                 values=None, device="cuda"):
    """The v1 word-parallel bitonic sort along ``axis``, optionally
    carrying ``values`` sorted by the keys -> keys, or (keys, values).

    Runs the ``bitonic`` backend's network (plain PyTorch ops on
    ``device``, what the JAX package runs outside its kernel).  Rows are
    padded to a power of two with keys that sort last and, with
    ``values``, the payload ``n``: a pad key can tie a genuine extreme
    key, and the key-value network breaks ties on ascending payload, so
    the pads sort after every real entry."""
    _deprecated("bitonic_sort",
                "repro_torch.sort.sort / sort_kv with method='bitonic'")
    from repro_torch.core.sortspec import next_pow2, resolve_device
    from repro_torch.kernels import bitonic_sort as _bs
    from repro_torch.kernels.ops import _from_rows, _to_rows, pad_rows, \
        sentinel
    dev = resolve_device(device)
    rows, lead, ax = _to_rows(torch.as_tensor(x).to(dev), axis)
    n = rows.shape[-1]
    m = next_pow2(n)
    keys = pad_rows(rows, m, sentinel(rows.dtype, descending))
    if values is None:
        return _from_rows(_bs.apply_network(keys, descending)[:, :n], lead,
                          ax)
    vals = _to_rows(torch.as_tensor(values).to(dev), axis)[0]
    sk, sv = _bs.apply_network_kv(keys, pad_rows(vals, m, n), descending)
    return _from_rows(sk[:, :n], lead, ax), _from_rows(sv[:, :n], lead, ax)


def sort(x, *, axis: int = -1, method: str = "torch",
         descending: bool = False, device="cuda") -> torch.Tensor:
    """Sort along ``axis`` with the selected backend (shim over
    ``repro_torch.sort.sort``)."""
    _deprecated("sort")
    from repro_torch import sort as _front
    return _front.sort(x, axis=axis, method=method, descending=descending,
                       device=device)


def argsort(x, *, axis: int = -1, method: str = "torch",
            descending: bool = False, device="cuda") -> torch.Tensor:
    _deprecated("argsort")
    from repro_torch import sort as _front
    return _front.argsort(x, axis=axis, method=method, descending=descending,
                          device=device)


def topk(x, k: int, *, method: str = "torch", device="cuda"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis -> (values, indices), descending (shim
    over ``repro_torch.sort.topk``; k is validated at the spec layer)."""
    _deprecated("topk")
    from repro_torch import sort as _front
    return _front.topk(x, k, method=method, device=device)


def top_p_mask(logits, p: float, *, axis: int = -1, method: str = "auto",
               device="cuda") -> torch.Tensor:
    """Nucleus-sampling mask: True for logits inside the top-p mass.

    Requires a descending sort of the probabilities — the paper's workload
    sitting directly on the serving path.  ``method`` defaults to "auto"
    (cost-model dispatch); ``axis`` and ``method`` pass straight through
    the spec front door.
    """
    from repro_torch import sort as _front
    from repro_torch.core.sortspec import resolve_device
    logits = torch.as_tensor(logits).to(resolve_device(device))
    probs = torch.softmax(logits, dim=axis)
    sorted_probs = _front.sort(probs, axis=axis, method=method,
                               descending=True, device=device)
    cum = torch.cumsum(sorted_probs, dim=axis)
    # number of entries needed to reach mass p
    keep_sorted = cum - sorted_probs < p
    kth = keep_sorted.sum(dim=axis, keepdim=True)  # count kept
    threshold = torch.gather(sorted_probs, axis, (kth - 1).clamp(min=0))
    return probs >= threshold
