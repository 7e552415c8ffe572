"""K5 — per-row bitonic top-k: the CUDA kernel and its plain version.

The kernel (``csrc/bitonic_topk.cu``) loads each row into registers with
its lane indices as payload, runs K1's descending key-value network on
them (the shared ``csrc/bitonic_reg.cuh``) and writes only the first k
keys and indices: one read of the row, one write of k columns.  The plain
version is the port's key-value network (``bitonic_sort.apply_network_kv``)
on the same lane indices, sliced to k.  Keys compare numerically, so -0.0
and +0.0 tie and come out in index order, as in the reference's Pallas
top-k.

``kernels/ops.py`` composes it for rows of any length (chunks, then an
ordering of the candidates).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.core.sortspec import index_rows
from repro_torch.kernels import _build
from repro_torch.kernels import bitonic_sort as _bs

MAX_N = _bs.MAX_N       # the same cap as K1


def topk_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the descending key-value network on
    lane indices, first k columns."""
    sk, si = _bs.apply_network_kv(x, index_rows(x), True)
    return sk[:, :k].contiguous(), si[:, :k].contiguous()


_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("bitonic_topk")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bitonic_topk_blocks.argtypes = [i, vp, vp, vp, ll, i, i, vp]
        lib.bitonic_topk_blocks.restype = i
        _lib_handle = lib
    return _lib_handle


def topk_blocks(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of (rows, n) -> (rows, k) values and int32 indices,
    descending, the lower index first among equal keys; n a power of two
    >= k (``ops.bitonic_topk`` pads).  The kernel for a CUDA tensor, the
    plain network for a CPU tensor."""
    n = _bs._check_rows(x, "topk_blocks")
    if not 1 <= k <= n:
        raise ValueError(f"topk_blocks: k must satisfy 1 <= k <= n (n={n}); "
                         f"got k={k}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"topk_blocks: unsupported device {x.device}")
        return topk_plain(x, k)
    if x.dtype not in _build.KEY_CODES:
        raise TypeError(f"topk_blocks: no kernel for keys of "
                        f"{keycodec.dtype_name(x.dtype)}")
    if n > MAX_N:
        raise ValueError(f"topk_blocks: rows of {n} exceed the shared-memory "
                         f"cap of {MAX_N}")
    if not x.is_contiguous():
        raise ValueError("topk_blocks: keys must be contiguous")
    rows = x.shape[0]
    vout = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    iout = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows == 0:
        return vout, iout
    with torch.cuda.device(x.device):
        status = _lib().bitonic_topk_blocks(
            _build.KEY_CODES[x.dtype], _build.ptr(x), _build.ptr(vout),
            _build.ptr(iout), rows, n.bit_length() - 1, k,
            _build.stream_of(x))
    _build.check(status, "bitonic_topk_blocks")
    _build.count_launch("bitonic_topk_blocks")
    return vout, iout
