"""K2 — stable merge of row-sorted run pairs: the CUDA kernel and its plain
version.

The kernel (``csrc/merge_path.cu``) cuts each output row into tiles of
``KERNEL_TILE`` by binary search on the merge path's diagonals and merges
each tile's two windows in shared memory.  The plain version is the rank
merge: every element's output slot is its own index plus its cross-rank in
the partner run (``searchsorted``; ``a`` counts only strictly smaller
b-elements, ``b`` counts the a-elements less or equal, so ``a`` wins
ties), placed with one scatter per run.  A stable merge with a fixed tie
winner has exactly one result, so the two agree bit for bit, whatever
their order of work.

Both merge ascending; callers flip for descending merges.  Keys are
NaN-free and compare numerically (-0.0 == +0.0).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.kernels import _build

KERNEL_TILE = 2048          # outputs per CTA in csrc/merge_path.cu


def rank_merge(a: torch.Tensor, b: torch.Tensor,
               va: Optional[torch.Tensor] = None,
               vb: Optional[torch.Tensor] = None):
    """Plain version: merge row-sorted (rows, La) + (rows, Lb) ascending,
    ``a`` first on ties -> (rows, La+Lb) (and the permuted payloads)."""
    dtype = a.dtype
    a = keycodec.to_signed(a).contiguous()
    b = keycodec.to_signed(b).contiguous()
    rows, la = a.shape
    lb = b.shape[-1]
    pa = torch.arange(la, device=a.device) + torch.searchsorted(b, a)
    pb = torch.arange(lb, device=a.device) + torch.searchsorted(
        a, b, right=True)
    out = torch.empty((rows, la + lb), dtype=a.dtype, device=a.device)
    out.scatter_(1, pa, a).scatter_(1, pb, b)
    out = keycodec.from_signed(out, dtype)
    if va is None:
        return out, None
    vout = torch.empty((rows, la + lb), dtype=va.dtype, device=va.device)
    vout.scatter_(1, pa, va).scatter_(1, pb, vb)
    return out, vout


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("merge_path")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.merge_pairs_blocks.argtypes = [i, vp, ll, vp, ll, vp, ll, vp, ll,
                                           vp, vp, ll, i, vp]
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


def _launch(a, b, va, vb, name: str):
    _check_pair(a, b, name)
    if a.dtype not in _build.KEY_CODES:
        raise TypeError(f"{name}: no kernel for keys of "
                        f"{keycodec.dtype_name(a.dtype)}")
    rows, l = a.shape
    if 2 * l >= 1 << 31:
        raise ValueError(f"{name}: run length {l} overflows the kernel's "
                         f"int32 positions")
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
    with torch.cuda.device(a.device):
        status = _lib().merge_pairs_blocks(
            _build.KEY_CODES[a.dtype], _build.ptr(a), strides[0],
            _build.ptr(b), strides[1], _build.ptr(va), vstrides[0],
            _build.ptr(vb), vstrides[1], _build.ptr(out), _build.ptr(vout),
            rows, l, _build.stream_of(a))
    _build.check(status, name)
    _build.count_launch(name)
    return out, vout


def merge_pairs_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge row-wise sorted (rows, L) + (rows, L) -> (rows, 2L), ascending,
    ``a`` first on ties.  Rows may be strided views; each row must be
    contiguous."""
    if a.is_cuda:
        return _launch(a, b, None, None, "merge_pairs_blocks")[0]
    if a.device.type != "cpu":
        raise ValueError(f"merge_pairs_blocks: unsupported device {a.device}")
    _check_pair(a, b, "merge_pairs_blocks")
    return rank_merge(a, b)[0]


def merge_pairs_kv_blocks(a: torch.Tensor, b: torch.Tensor,
                          va: torch.Tensor, vb: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value variant: payloads ride along their keys."""
    if a.is_cuda:
        return _launch(a, b, va, vb, "merge_pairs_kv_blocks")
    if a.device.type != "cpu":
        raise ValueError(f"merge_pairs_kv_blocks: unsupported device "
                         f"{a.device}")
    _check_pair(a, b, "merge_pairs_kv_blocks")
    return rank_merge(a, b, va, vb)
