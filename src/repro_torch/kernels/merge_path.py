"""K2 — stable merge of row-sorted run pairs, either direction: the CUDA
kernels and their plain versions.

On a card a merge is two launches (``csrc/merge_path.cu``): the partition
kernel binary-searches the merge path's diagonal at every boundary of the
output's ``KERNEL_TILE``-output tiles, and the merge kernel merges each
tile's two windows in shared memory along those cuts.  The plain version is
the rank merge: every element's output slot is its own index plus its
cross-rank in the partner run (``searchsorted``; ``a`` counts only strictly
smaller b-elements, ``b`` counts the a-elements less or equal, so ``a``
wins ties), placed with one scatter per run; descending, it is the
reference's construction (flip both runs into ascending order, swap them,
merge, flip out).  A stable merge with a fixed tie winner has exactly one
result, so kernel and plain agree bit for bit, whatever their order of
work.

Both directions keep ``a`` first on equal keys: the kernel compares in the
merge's direction (descending takes ``a`` when ``a >= b``), so a
descending merge moves no more bytes than an ascending one.  Keys are
NaN-free and compare numerically (-0.0 == +0.0).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.kernels import _build

KERNEL_TILE = 4096          # outputs a tile in csrc/merge_path.cu


def tiles_per_row(l: int) -> int:
    """Tiles of a merged row of 2L outputs."""
    return -(-2 * l // KERNEL_TILE)


def _rank_merge_ascending(a, b, va, vb):
    rows, la = a.shape
    lb = b.shape[-1]
    pa = torch.arange(la, device=a.device) + torch.searchsorted(b, a)
    pb = torch.arange(lb, device=a.device) + torch.searchsorted(
        a, b, right=True)
    out = torch.empty((rows, la + lb), dtype=a.dtype, device=a.device)
    out.scatter_(1, pa, a).scatter_(1, pb, b)
    if va is None:
        return out, None
    vout = torch.empty((rows, la + lb), dtype=va.dtype, device=va.device)
    vout.scatter_(1, pa, va).scatter_(1, pb, vb)
    return out, vout


def flip_merge(merge, a, b, va=None, vb=None):
    """A descending merge through an ascending ``merge(a, b, va, vb)``: the
    reference's construction.  Flip both runs into ascending order AND swap
    them: the ascending merge's left-wins rule becomes right-wins after the
    final flip, so swapping roles keeps ``a`` first on equal keys."""
    out, vout = merge(b.flip(-1), a.flip(-1),
                      None if vb is None else vb.flip(-1),
                      None if va is None else va.flip(-1))
    return out.flip(-1), None if vout is None else vout.flip(-1)


def rank_merge(a: torch.Tensor, b: torch.Tensor,
               va: Optional[torch.Tensor] = None,
               vb: Optional[torch.Tensor] = None, *,
               descending: bool = False):
    """Plain version: merge row-sorted (rows, La) + (rows, Lb), ascending
    (or descending), ``a`` first on ties -> (rows, La+Lb) (and the
    permuted payloads)."""
    dtype = a.dtype
    a = keycodec.to_signed(a).contiguous()
    b = keycodec.to_signed(b).contiguous()
    if descending:
        out, vout = flip_merge(_rank_merge_ascending, a, b, va, vb)
    else:
        out, vout = _rank_merge_ascending(a, b, va, vb)
    return keycodec.from_signed(out.contiguous(), dtype), vout


def partition_plain(a: torch.Tensor, b: torch.Tensor, *,
                    descending: bool = False) -> torch.Tensor:
    """Plain version of the partition kernel: (rows, tiles + 1) int32, the
    a-elements among the first ``min(t * KERNEL_TILE, 2L)`` outputs of the
    merge, for every tile boundary t: the count of a's output slots below
    the boundary."""
    a = keycodec.to_signed(a).contiguous()
    b = keycodec.to_signed(b).contiguous()
    rows, l = a.shape
    ar = torch.arange(l, device=a.device)
    if descending:
        # a[i] goes after the b-elements strictly greater
        slot = ar + l - torch.searchsorted(b.flip(-1).contiguous(), a,
                                           right=True)
    else:
        slot = ar + torch.searchsorted(b, a)
    d = (torch.arange(tiles_per_row(l) + 1, device=a.device)
         * KERNEL_TILE).clamp(max=2 * l)
    return torch.searchsorted(slot.contiguous(),
                              d.expand(rows, -1).contiguous()).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("merge_path")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.merge_path_partition.argtypes = [i, vp, ll, vp, ll, vp, ll, i, i,
                                             i, vp]
        lib.merge_path_partition.restype = i
        lib.merge_pairs_blocks.argtypes = [i, vp, ll, vp, ll, vp, ll, vp, ll,
                                           vp, vp, vp, ll, i, i, i, vp]
        lib.merge_pairs_blocks.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_pair(a, b, name: str) -> None:
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"{name} takes two (rows, L) runs of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"{name}: runs differ in dtype or device")


def _row_stride(t, name: str) -> int:
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: rows must be contiguous (last-axis stride "
                         f"1), got strides {t.stride()}")
    return t.stride(0)


def _check_keys(a, b, name: str) -> None:
    _check_pair(a, b, name)
    if a.dtype not in _build.KEY_CODES:
        raise TypeError(f"{name}: no kernel for keys of "
                        f"{keycodec.dtype_name(a.dtype)}")
    if 2 * a.shape[-1] >= 1 << 31:
        raise ValueError(f"{name}: run length {a.shape[-1]} overflows the "
                         f"kernel's int32 positions")


def _partition(a, b, descending: bool) -> torch.Tensor:
    """The partition kernel's launch: (rows, tiles + 1) int32 cuts."""
    rows, l = a.shape
    shape = (rows, tiles_per_row(l) + 1)
    if a.numel() == 0:
        return torch.zeros(shape, dtype=torch.int32, device=a.device)
    cuts = torch.empty(shape, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        status = _lib().merge_path_partition(
            _build.KEY_CODES[a.dtype], _build.ptr(a), _row_stride(a, "K2"),
            _build.ptr(b), _row_stride(b, "K2"), _build.ptr(cuts), rows, l,
            KERNEL_TILE, int(descending), _build.stream_of(a))
    _build.check(status, "merge_path_partition")
    _build.count_launch("merge_path_partition")
    return cuts


def merge_path_partition(a: torch.Tensor, b: torch.Tensor, *,
                         descending: bool = False) -> torch.Tensor:
    """The merge's tile cuts: (rows, tiles + 1) int32 a-element counts at
    every ``KERNEL_TILE`` boundary of the merged rows (see
    :func:`partition_plain`)."""
    _check_keys(a, b, "merge_path_partition")
    if a.is_cuda:
        return _partition(a, b, descending)
    if a.device.type != "cpu":
        raise ValueError(f"merge_path_partition: unsupported device "
                         f"{a.device}")
    return partition_plain(a, b, descending=descending)


def _launch(a, b, va, vb, descending: bool, name: str):
    _check_keys(a, b, name)
    rows, l = a.shape
    if va is not None:
        _check_pair(va, vb, name)
        if va.dtype != torch.int32 or va.shape != a.shape \
                or va.device != a.device:
            raise ValueError(f"{name}: payloads must be int32 tensors of the "
                             f"keys' shape and device")
    out = torch.empty((rows, 2 * l), dtype=a.dtype, device=a.device)
    vout = None if va is None else torch.empty(
        (rows, 2 * l), dtype=torch.int32, device=a.device)
    if a.numel() == 0:
        return out, vout
    strides = [_row_stride(t, name) for t in (a, b)]
    vstrides = [0, 0] if va is None else [_row_stride(t, name)
                                          for t in (va, vb)]
    cuts = _partition(a, b, descending)
    with torch.cuda.device(a.device):
        status = _lib().merge_pairs_blocks(
            _build.KEY_CODES[a.dtype], _build.ptr(a), strides[0],
            _build.ptr(b), strides[1], _build.ptr(va), vstrides[0],
            _build.ptr(vb), vstrides[1], _build.ptr(out), _build.ptr(vout),
            _build.ptr(cuts), rows, l, KERNEL_TILE, int(descending),
            _build.stream_of(a))
    _build.check(status, name)
    _build.count_launch(name)
    return out, vout


def merge_pairs_blocks(a: torch.Tensor, b: torch.Tensor, *,
                       descending: bool = False) -> torch.Tensor:
    """Merge row-wise sorted (rows, L) + (rows, L) -> (rows, 2L), ascending
    (or descending), ``a`` first on ties.  Rows may be strided views; each
    row must be contiguous."""
    if a.is_cuda:
        return _launch(a, b, None, None, descending, "merge_pairs_blocks")[0]
    if a.device.type != "cpu":
        raise ValueError(f"merge_pairs_blocks: unsupported device {a.device}")
    _check_pair(a, b, "merge_pairs_blocks")
    return rank_merge(a, b, descending=descending)[0]


def merge_pairs_kv_blocks(a: torch.Tensor, b: torch.Tensor,
                          va: torch.Tensor, vb: torch.Tensor, *,
                          descending: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value variant: payloads ride along their keys."""
    if a.is_cuda:
        return _launch(a, b, va, vb, descending, "merge_pairs_kv_blocks")
    if a.device.type != "cpu":
        raise ValueError(f"merge_pairs_kv_blocks: unsupported device "
                         f"{a.device}")
    _check_pair(a, b, "merge_pairs_kv_blocks")
    return rank_merge(a, b, va, vb, descending=descending)
