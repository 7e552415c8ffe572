"""K3 — stable LSD radix sort over keycodec keys: the CUDA kernels, their
plain versions, and the pass loop that runs either.

Keys arrive encoded (``core/keycodec.py``: carrier ints holding unsigned
keys whose order is the source order).  Each digit pass is the classic
three-phase LSD structure:

  upsweep     per-tile digit histogram            ``digit_hist``
  scan        digit-major exclusive prefix sum    ``torch.cumsum`` (here)
              across the tiles of a row -> base[tile, digit]
  downsweep   stable in-tile rank of each element ``digit_scatter``
              and one scatter to base + rank

On a CUDA tensor ``digit_hist`` and ``digit_scatter`` launch the kernels of
``csrc/radix_sort.cu``; on a CPU tensor they run the plain versions, which
are the reference's per-tile functions (``digit_stats``, ``global_pos``)
written in PyTorch.  A stable sort has one result, so the tile size does
not change any output; the digit width sets only the number of passes.
Pads carry the maximum key and payload ``n``: stability parks them behind
every genuine element, even one equal to the pad key.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.kernels import _build


def _resolve(tile: Optional[int], digit_bits: Optional[int]
             ) -> Tuple[int, int]:
    """Fill unset kernel parameters from the active tuning profile."""
    if tile is None or digit_bits is None:
        from repro_torch.core import tuning
        prof = tuning.active()
        tile = prof.radix_tile if tile is None else tile
        digit_bits = prof.digit_bits if digit_bits is None else digit_bits
    return tile, digit_bits


def pass_tile_counts(n: int, dtype, tile: Optional[int] = None,
                     digit_bits: Optional[int] = None) -> Tuple[int, int]:
    """(digit passes, tiles per row) that ``sort_blocks`` runs at this
    shape, from the shape alone."""
    tile, digit_bits = _resolve(tile, digit_bits)
    bits = keycodec.key_bits(dtype)
    tile = min(tile, max(8, n))
    return -(-bits // digit_bits), -(-n // tile)


def _digits(keys: torch.Tensor, shift: int, radix: int) -> torch.Tensor:
    """Digit ``shift`` of the unsigned keys held in a carrier, as int32."""
    bits = keys.element_size() * 8
    u = keys.to(torch.int64) & ((1 << bits) - 1)
    return ((u >> shift) & (radix - 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions of the reference's per-tile functions
# ---------------------------------------------------------------------------

# one-hot elements materialised at once by digit_stats (int32: 64 MB)
_ONE_HOT_BUDGET = 1 << 24


def digit_stats(d: torch.Tensor, radix: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tiles, tile) int32 digits -> (histogram (tiles, radix), stable rank
    of every element among the equal digits of its tile)."""
    tiles, c = d.shape
    hist = torch.empty((tiles, radix), dtype=torch.int32, device=d.device)
    rank = torch.empty_like(d)
    slots = torch.arange(radix, dtype=torch.int32, device=d.device)
    step = max(1, _ONE_HOT_BUDGET // max(1, c * radix))
    for s in range(0, tiles, step):
        oh = (d[s:s + step, :, None] == slots).to(torch.int32)
        hist[s:s + step] = oh.sum(1)
        rank[s:s + step] = ((oh.cumsum(1) - oh) * oh).sum(2)
    return hist, rank


def global_pos(d: torch.Tensor, base: torch.Tensor,
               rank: torch.Tensor) -> torch.Tensor:
    """Slot of every element: base offset of its (tile, digit) + its rank."""
    return base.gather(1, d.to(torch.int64)) + rank


def digit_hist_plain(keys: torch.Tensor, shift: int, digit_bits: int,
                     tile: int) -> torch.Tensor:
    """Plain version of the upsweep kernel (any device)."""
    rows, m = keys.shape
    radix = 1 << digit_bits
    d = _digits(keys, shift, radix).reshape(rows * (m // tile), tile)
    return digit_stats(d, radix)[0]


def digit_scatter_plain(keys: torch.Tensor, vals: Optional[torch.Tensor],
                        base: torch.Tensor, shift: int, digit_bits: int,
                        tile: int):
    """Plain version of the downsweep kernel (any device)."""
    rows, m = keys.shape
    radix = 1 << digit_bits
    d = _digits(keys, shift, radix).reshape(rows * (m // tile), tile)
    _, rank = digit_stats(d, radix)
    pos = global_pos(d, base, rank).reshape(rows, m).to(torch.int64)
    kout = torch.empty_like(keys).scatter_(1, pos, keys)
    vout = None if vals is None else \
        torch.empty_like(vals).scatter_(1, pos, vals)
    return kout, vout


# ---------------------------------------------------------------------------
# CUDA wrappers (plain versions for CPU tensors)
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("radix_sort")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.radix_digit_hist.argtypes = [i, vp, vp, ll, i, i, i, i, vp]
        lib.radix_digit_hist.restype = i
        lib.radix_digit_scatter.argtypes = [i, vp, vp, vp, vp, vp, ll, i, i,
                                            i, i, vp]
        lib.radix_digit_scatter.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_keys(keys, tile: int, digit_bits: int, name: str) -> int:
    if keys.dim() != 2 or keys.element_size() not in (1, 2, 4) \
            or keys.is_floating_point():
        raise ValueError(f"{name} takes (rows, m) integer keys of 1, 2 or 4 "
                         f"bytes, got {keycodec.dtype_name(keys.dtype)} "
                         f"{tuple(keys.shape)}")
    m = keys.shape[-1]
    if m >= 1 << 31:
        raise ValueError(f"{name}: row length {m} overflows the kernels' "
                         f"int32 positions")
    if tile < 1 or m % tile:
        raise ValueError(f"{name}: row length {m} is not a multiple of the "
                         f"tile {tile}")
    if digit_bits not in (1, 2, 4, 8):
        raise ValueError(f"{name}: digit_bits must be 1, 2, 4 or 8")
    return m // tile


def digit_hist(keys: torch.Tensor, shift: int, digit_bits: int,
               tile: int) -> torch.Tensor:
    """Upsweep: (rows, m) keys -> (rows * m/tile, 2^digit_bits) int32
    digit counts per tile."""
    tiles = _check_keys(keys, tile, digit_bits, "digit_hist")
    rows, m = keys.shape
    radix = 1 << digit_bits
    if not keys.is_cuda:
        return digit_hist_plain(keys, shift, digit_bits, tile)
    if not keys.is_contiguous():
        raise ValueError("digit_hist: keys must be contiguous")
    hist = torch.empty((rows * tiles, radix), dtype=torch.int32,
                       device=keys.device)
    if keys.numel() == 0:
        return hist
    with torch.cuda.device(keys.device):
        status = _lib().radix_digit_hist(
            keys.element_size(), _build.ptr(keys), _build.ptr(hist), rows, m,
            tile, shift, digit_bits, _build.stream_of(keys))
    _build.check(status, "radix_digit_hist")
    _build.count_launch("radix_digit_hist")
    return hist


def digit_scatter(keys: torch.Tensor, vals: Optional[torch.Tensor],
                  base: torch.Tensor, shift: int, digit_bits: int,
                  tile: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Downsweep: move every element of tile t to base[t, digit] + its
    stable rank among its tile's elements of that digit (row-local)."""
    tiles = _check_keys(keys, tile, digit_bits, "digit_scatter")
    rows, m = keys.shape
    radix = 1 << digit_bits
    if base.shape != (rows * tiles, radix) or base.dtype != torch.int32:
        raise ValueError("digit_scatter: base must be int32 "
                         f"({rows * tiles}, {radix})")
    if not keys.is_cuda:
        return digit_scatter_plain(keys, vals, base, shift, digit_bits, tile)
    if vals is not None and (vals.dtype != torch.int32
                             or vals.shape != keys.shape
                             or not vals.is_contiguous()):
        raise ValueError("digit_scatter: the payload must be a contiguous "
                         "int32 tensor of the keys' shape")
    if not (keys.is_contiguous() and base.is_contiguous()):
        raise ValueError(f"digit_scatter: keys {tuple(keys.shape)} strides "
                         f"{keys.stride()} and base {tuple(base.shape)} "
                         f"strides {base.stride()} must be contiguous")
    kout = torch.empty_like(keys)
    vout = None if vals is None else torch.empty_like(vals)
    if keys.numel() == 0:
        return kout, vout
    with torch.cuda.device(keys.device):
        status = _lib().radix_digit_scatter(
            keys.element_size(), _build.ptr(keys), _build.ptr(vals),
            _build.ptr(kout), _build.ptr(vout), _build.ptr(base), rows, m,
            tile, shift, digit_bits, _build.stream_of(keys))
    _build.check(status, "radix_digit_scatter")
    _build.count_launch("radix_digit_scatter")
    return kout, vout


# ---------------------------------------------------------------------------
# pass loop
# ---------------------------------------------------------------------------

def tile_bases(hist: torch.Tensor, rows: int) -> torch.Tensor:
    """Digit-major exclusive prefix sum across a row's tiles: every element
    with a smaller digit anywhere in the row, or the same digit in an
    earlier tile, precedes you.  (rows*tiles, radix) -> same shape."""
    radix = hist.shape[-1]
    tiles = hist.shape[0] // rows
    flat = hist.view(rows, tiles, radix).transpose(1, 2).reshape(rows, -1)
    excl = torch.cumsum(flat, dim=-1, dtype=torch.int32) - flat
    return excl.view(rows, radix, tiles).transpose(1, 2).reshape(
        rows * tiles, radix).contiguous()


def radix_pass(keys: torch.Tensor, vals: Optional[torch.Tensor], shift: int,
               tile: int, digit_bits: int):
    """One stable digit pass over (rows, m) keys (m a multiple of tile)."""
    hist = digit_hist(keys, shift, digit_bits, tile)
    base = tile_bases(hist, keys.shape[0])
    return digit_scatter(keys, vals, base, shift, digit_bits, tile)


def _padded(keys, vals, tile):
    rows, n = keys.shape
    tile = min(tile, max(8, n))
    m = -(-n // tile) * tile
    if m != n:
        # the carrier's all-ones pattern is the maximum unsigned key
        pad = torch.full((rows, m - n), -1, dtype=keys.dtype,
                         device=keys.device)
        keys = torch.cat([keys, pad], dim=1)
        if vals is not None:
            vals = torch.cat([vals, torch.full((rows, m - n), n,
                                               dtype=vals.dtype,
                                               device=vals.device)], dim=1)
    return keys.contiguous(), \
        None if vals is None else vals.contiguous(), tile


def _check_carrier(keys):
    if keys.dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError(
            f"radix sort takes keycodec carrier keys (int8/int16/int32), got "
            f"{keycodec.dtype_name(keys.dtype)}")


def sort_kv_blocks(keys: torch.Tensor, vals: Optional[torch.Tensor], *,
                   tile: Optional[int] = None,
                   digit_bits: Optional[int] = None):
    """Stable ascending LSD radix sort of each row of carrier keys, with an
    optional payload riding every pass.  ``tile``/``digit_bits`` default to
    the active tuning profile."""
    _check_carrier(keys)
    tile, digit_bits = _resolve(tile, digit_bits)
    n = keys.shape[-1]
    keys, vals, tile = _padded(keys, vals, tile)
    for shift in range(0, keys.element_size() * 8, digit_bits):
        keys, vals = radix_pass(keys, vals, shift, tile, digit_bits)
    return keys[:, :n], None if vals is None else vals[:, :n]


def sort_blocks(keys: torch.Tensor, *, tile: Optional[int] = None,
                digit_bits: Optional[int] = None) -> torch.Tensor:
    """Key-only variant of :func:`sort_kv_blocks`."""
    return sort_kv_blocks(keys, None, tile=tile, digit_bits=digit_bits)[0]
