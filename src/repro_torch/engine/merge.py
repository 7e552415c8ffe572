"""Merge tree over sorted runs — rung two of the sort engine.

Pairwise merges, level by level over a power-of-two run count: R runs of
length L become R/2 runs of 2L, log2(R) times, each level O(n).

Merge backends:

  ``torch``    the rank merge in plain PyTorch (``searchsorted`` cross-
               ranks + scatter) — the merge-path kernel's plain version.
  ``cuda``     the merge-path kernel (K2, kernels/merge_path.py).
  ``bitonic``  the bitonic merge box over concat(a, reverse(b)): O(n log n)
               compare-exchanges, not stable (ties follow a consistent
               left-wins predicate; payloads stay with their keys).

``torch``/``cuda`` are stable (the left run wins ties) in both
directions.  ``cuda`` merges descending runs with a descending comparator
and moves no more bytes than an ascending merge; ``torch`` and
``bitonic`` keep the reference's construction (flip in, swap the pair,
merge ascending, flip out), as ``src/repro/engine/merge.py`` does.  The
k-way merges of the spill tier (``kway_merge*``) come with that tier.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import bitonic_sort as _bs
from repro_torch.kernels import merge_path as _mp

MERGE_BACKENDS = ("torch", "cuda", "bitonic")


def _bitonic_box_merge(a, b, va, vb):
    """Merge box over concat(a, reverse(b)) — a bitonic sequence, so only
    the log2(2L) merge substages run, each a (pairs, 2, j) view + min/max
    (XLA's min/max: the minimum of -0.0 and +0.0 is -0.0).  With a payload
    the comparator is an explicit a <= b predicate."""
    rows, l = a.shape
    if l & (l - 1):
        raise ValueError(
            f"bitonic merge backend needs power-of-two run lengths, got {l}")
    n = 2 * l
    z = torch.cat([a, b.flip(-1)], -1)
    w = None if va is None else torch.cat([va, vb.flip(-1)], -1)
    j = n // 2
    while j >= 1:
        zv = z.reshape(rows, n // (2 * j), 2, j)
        ka, kb = zv[:, :, 0, :], zv[:, :, 1, :]
        if w is None:
            mn, mx = _bs._MinMax.apply(ka, kb)
            z = torch.stack([mn, mx], dim=2).reshape(rows, n)
        else:
            wv = w.reshape(rows, n // (2 * j), 2, j)
            pa, pb = wv[:, :, 0, :], wv[:, :, 1, :]
            pred = ka <= kb
            z = torch.stack([torch.where(pred, ka, kb),
                             torch.where(pred, kb, ka)], 2).reshape(rows, n)
            w = torch.stack([torch.where(pred, pa, pb),
                             torch.where(pred, pb, pa)], 2).reshape(rows, n)
        j //= 2
    return z, w


def merge_pairs(a: torch.Tensor, b: torch.Tensor, *,
                descending: bool = False, backend: str = "torch",
                values: Tuple = (None, None)):
    """Merge row-wise sorted (rows, L) a and b -> (rows, 2L) (+ payloads)."""
    if backend not in MERGE_BACKENDS:
        raise ValueError(
            f"merge backend must be one of {MERGE_BACKENDS}, got {backend!r}")
    va, vb = values
    if backend == "cuda":
        if va is None:
            out, vout = _mp.merge_pairs_blocks(
                a, b, descending=descending), None
        else:
            out, vout = _mp.merge_pairs_kv_blocks(a, b, va, vb,
                                                  descending=descending)
    elif backend == "bitonic":
        out, vout = (_mp.flip_merge(_bitonic_box_merge, a, b, va, vb)
                     if descending else _bitonic_box_merge(a, b, va, vb))
    else:
        out, vout = _mp.rank_merge(a, b, va, vb, descending=descending)
    return (out, vout) if values[0] is not None else out


def merge_runs(run_keys: torch.Tensor,
               run_vals: Optional[torch.Tensor] = None, *,
               descending: bool = False, backend: str = "torch"):
    """Collapse (rows, R, L) sorted runs into one (rows, R*L) sorted row
    through a complete tournament of pairwise merges (R a power of two)."""
    rows, r, l = run_keys.shape
    if r & (r - 1):
        raise ValueError(f"run count must be a power of two, got {r}")
    keys, vals = run_keys, run_vals
    while r > 1:
        kv = keys.reshape(rows * (r // 2), 2, l)
        a, b = kv[:, 0, :], kv[:, 1, :]
        if vals is None:
            merged = merge_pairs(a, b, descending=descending, backend=backend)
        else:
            vv = vals.reshape(rows * (r // 2), 2, l)
            merged, mvals = merge_pairs(
                a, b, descending=descending, backend=backend,
                values=(vv[:, 0, :], vv[:, 1, :]))
            vals = mvals.reshape(rows, r // 2, 2 * l)
        keys = merged.reshape(rows, r // 2, 2 * l)
        r //= 2
        l *= 2
    keys = keys.reshape(rows, l)
    if run_vals is None:
        return keys
    return keys, vals.reshape(rows, l)
