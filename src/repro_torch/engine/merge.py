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
merge ascending, flip out), as ``src/repro/engine/merge.py`` does.

``kway_merge``/``kway_merge_kv`` merge k sorted 1-D arrays of any lengths
(the spill tier's block merges): a tournament of pairwise merges over the
arrays padded to one power-of-two length, the pads dropped by position.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.core.sortspec import next_pow2
from repro_torch.kernels import bitonic_sort as _bs
from repro_torch.kernels import merge_path as _mp
from repro_torch.kernels.ops import sentinel

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


# ---------------------------------------------------------------------------
# k-way merges of 1-D arrays (the spill tier's block merges)
# ---------------------------------------------------------------------------

def order_key(x: torch.Tensor) -> torch.Tensor:
    """The reference merge's comparator as an integer key: -0.0 and +0.0
    equal, every NaN one value above +inf (``jnp.searchsorted``'s order,
    NaN last), floats only.  K2 and the rank merge compare numerically and
    ``torch.searchsorted`` mis-ranks keys against a NaN, so runs that hold
    NaN merge on this key and their keys are gathered back by position,
    bits (NaN payloads) untouched."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return keycodec.total_order_key(x)


def _kway(keys: Sequence[torch.Tensor], descending: bool, backend: str):
    """Tournament over ``keys`` padded to one power-of-two length ->
    (merged genuine keys, or None where the caller must gather them, and
    their positions in the concatenation, int64).  The keys of float runs
    that hold NaN merge as :func:`order_key`.  Pads carry the direction's
    sentinel of the merge key and position ``total``: a pad that ties a
    genuine key (a genuine +inf, an integer maximum) is dropped by
    position, never by value, so it cannot shadow one."""
    total = sum(a.shape[0] for a in keys)
    if total >= 1 << 31:
        raise ValueError(f"kway_merge: {total} keys overflow the int32 "
                         f"positions")
    dtype, dev = keys[0].dtype, keys[0].device
    by_order = dtype.is_floating_point and any(
        bool(torch.isnan(a).any()) for a in keys)
    mkeys = [order_key(a) if by_order else keycodec.to_signed(a)
             for a in keys]
    l = next_pow2(max(1, max(a.shape[0] for a in keys)))
    r = next_pow2(len(keys))
    pk = torch.full((r, l), sentinel(mkeys[0].dtype, descending),
                    dtype=mkeys[0].dtype, device=dev)
    pp = torch.full((r, l), total, dtype=torch.int32, device=dev)
    off = 0
    for i, a in enumerate(mkeys):
        m = a.shape[0]
        pk[i, :m] = a
        pp[i, :m] = torch.arange(off, off + m, dtype=torch.int32, device=dev)
        off += m
    mk, mp = merge_runs(pk[None], pp[None], descending=descending,
                        backend=backend)
    genuine = mp[0] < total
    pos = mp[0][genuine].to(torch.int64)
    if by_order:
        return None, pos
    return keycodec.from_signed(mk[0][genuine], dtype), pos


def _take(arrays: Sequence[torch.Tensor], pos: torch.Tensor) -> torch.Tensor:
    """The concatenation of ``arrays`` at positions ``pos``, moved as bits:
    floats through their integer carrier (a CPU gather may quiet a
    signalling NaN), uint16/uint32 through their signed one."""
    dtype = arrays[0].dtype
    flat = torch.cat([keycodec.to_signed(a) for a in arrays])
    if flat.is_floating_point() and keycodec.supports(dtype):
        return flat.view(keycodec.key_dtype(dtype))[pos].view(dtype)
    return keycodec.from_signed(flat[pos], dtype)


def _flat(keys, vals=None):
    if not keys or (vals is not None and len(vals) != len(keys)):
        raise ValueError("need matching non-empty key/payload array lists")
    keys = [a.reshape(-1) for a in keys]
    if vals is None:
        return keys, None
    vals = [v.reshape(-1) for v in vals]
    for a, v in zip(keys, vals):
        if a.shape != v.shape:
            raise ValueError(
                f"key/payload length mismatch: {tuple(a.shape)} vs "
                f"{tuple(v.shape)}")
    return keys, vals


def kway_merge(arrays: Sequence[torch.Tensor], *, descending: bool = False,
               backend: str = "torch") -> torch.Tensor:
    """Merge k independently sorted 1-D arrays of any lengths into one
    sorted array; ties keep array order (``torch``/``cuda``).  The pads
    are dropped by position, as :func:`kway_merge_kv` drops them."""
    arrays, _ = _flat(arrays)
    mk, pos = _kway(arrays, descending, backend)
    return _take(arrays, pos) if mk is None else mk


def kway_merge_kv(keys: Sequence[torch.Tensor], vals: Sequence[torch.Tensor],
                  *, descending: bool = False, backend: str = "torch"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge k independently sorted 1-D (key, payload) arrays.  The
    tournament runs on (key, concatenation position) and the payload, of
    any dtype, is gathered by position at the end, so a pad never
    displaces a genuine element whatever its key.  Stable for
    ``torch``/``cuda``: ties keep array order, then index order.  Its
    compaction is data-dependent: not for a captured CUDA graph."""
    keys, vals = _flat(keys, vals)
    mk, pos = _kway(keys, descending, backend)
    return (_take(keys, pos) if mk is None else mk), _take(vals, pos)
