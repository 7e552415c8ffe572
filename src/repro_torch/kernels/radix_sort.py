"""K3 — stable LSD radix sort over keycodec keys: the CUDA kernels, their
plain versions, and the pass loops that run them.

Keys arrive encoded (``core/keycodec.py``: carrier ints holding unsigned
keys whose order is the source order).  A stable sort has one result, so
the tile size does not change any output; the digit width sets only the
number of passes.

:func:`sort_kv_blocks` is a onesweep sort (``csrc/radix_sort.cu``), 1 + P
launches for P digit passes on a CUDA tensor:

  ``onesweep_hist``   one read of the keys counts the digits of every pass
                      of every row: (rows, passes, 2^digit_bits) int32
  ``onesweep_pass``   once a pass: each 4096-key tile ranks its elements
                      stably by position, learns the counts of the earlier
                      tiles of its row by decoupled look-back, and writes
                      its keys and payloads out grouped by digit

On a CPU tensor the same loop runs the kernels' plain versions,
``onesweep_hist_plain`` and ``onesweep_pass_plain``.

:func:`bucket_hist` is the third entry, ``radix_bucket_hist``: the
distributed sample sort's count of a sorted shard's keys by splitter
interval (the reference runs ``_digit_stats`` with the interval id as the
digit).  On the card it searches the sorted shard for each splitter and
takes differences, one launch; its plain version :func:`bucket_hist_plain`
is the reference's formulation.  ``digit_stats``,
``global_pos``, ``digit_hist_plain``, ``digit_scatter_plain`` and
``tile_bases`` are the reference's per-tile functions in PyTorch, held
against it by the tests; the plain pass ranks with ``digit_stats``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.kernels import _build

ONESWEEP_TILE = 4096      # csrc/radix_sort.cu kTile
MAX_BUCKET_BINS = 1024    # csrc/radix_sort.cu kMaxBucketBins: D + 1 bins


def _resolve(tile: Optional[int], digit_bits: Optional[int]
             ) -> Tuple[int, int]:
    """Fill unset kernel parameters from the active tuning profile."""
    if tile is None or digit_bits is None:
        from repro_torch.core import tuning
        prof = tuning.active()
        tile = prof.radix_tile if tile is None else tile
        digit_bits = prof.digit_bits if digit_bits is None else digit_bits
    return tile, digit_bits


def pass_tile_counts(n: int, dtype, digit_bits: Optional[int] = None
                     ) -> Tuple[int, int]:
    """(digit passes, 4096-key tiles per row) that ``sort_blocks`` runs at
    this shape, from the shape alone."""
    digit_bits = _resolve(None, digit_bits)[1]
    return -(-keycodec.key_bits(dtype) // digit_bits), -(-n // ONESWEEP_TILE)


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
    """(rows, m) keys -> (rows * m/tile, 2^digit_bits) int32 digit counts
    per tile (the reference's upsweep)."""
    rows, m = keys.shape
    radix = 1 << digit_bits
    d = _digits(keys, shift, radix).reshape(rows * (m // tile), tile)
    return digit_stats(d, radix)[0]


def digit_scatter_plain(keys: torch.Tensor, vals: Optional[torch.Tensor],
                        base: torch.Tensor, shift: int, digit_bits: int,
                        tile: int):
    """Move every element of tile t to base[t, digit] + its stable rank
    among its tile's elements of that digit, row-local (the reference's
    downsweep and scatter)."""
    rows, m = keys.shape
    radix = 1 << digit_bits
    d = _digits(keys, shift, radix).reshape(rows * (m // tile), tile)
    _, rank = digit_stats(d, radix)
    pos = global_pos(d, base, rank).reshape(rows, m).to(torch.int64)
    kout = torch.empty_like(keys).scatter_(1, pos, keys)
    vout = None if vals is None else \
        torch.empty_like(vals).scatter_(1, pos, vals)
    return kout, vout


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


# ---------------------------------------------------------------------------
# plain versions of the onesweep kernels
# ---------------------------------------------------------------------------

def _passes(keys: torch.Tensor, digit_bits: int) -> int:
    return keys.element_size() * 8 // digit_bits


def onesweep_hist_plain(keys: torch.Tensor, digit_bits: int
                        ) -> torch.Tensor:
    """(rows, m) keys -> (rows, passes, 2^digit_bits) int32: the count of
    every digit of every pass in each row."""
    rows, m = keys.shape
    radix = 1 << digit_bits
    passes = _passes(keys, digit_bits)
    hist = torch.zeros((rows, passes, radix), dtype=torch.int32,
                       device=keys.device)
    ones = torch.ones((1, 1), dtype=torch.int32,
                      device=keys.device).expand(rows, m)
    for p in range(passes):
        d = _digits(keys, p * digit_bits, radix).to(torch.int64)
        hist[:, p].scatter_add_(1, d, ones)
    return hist


def onesweep_pass_plain(keys: torch.Tensor, vals: Optional[torch.Tensor],
                        hist: torch.Tensor, shift: int, digit_bits: int):
    """Plain version of one onesweep pass: every element of a row goes to
    the row's count of smaller digits (the exclusive scan of ``hist``'s
    pass) plus the count of its digit in the row's earlier tiles (the
    look-back) plus its stable rank in its own tile.  The tiles are the
    kernel's, the last one of a row partial (a row shorter than a tile is
    one tile of its own length)."""
    rows, m = keys.shape
    if keys.numel() == 0:
        return keys.clone(), None if vals is None else vals.clone()
    radix = 1 << digit_bits
    tile = min(ONESWEEP_TILE, m)
    tiles = -(-m // tile)
    d = _digits(keys, shift, radix)
    # the missing items of the last tile take an extra digit of their own
    dp = torch.full((rows, tiles * tile), radix, dtype=torch.int32,
                    device=keys.device)
    dp[:, :m] = d
    counts, rank = digit_stats(dp.view(rows * tiles, tile), radix + 1)
    counts = counts.view(rows, tiles, radix + 1)[..., :radix]
    lookback = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    h = hist[:, shift // digit_bits]
    row_base = torch.cumsum(h, dim=-1, dtype=torch.int32) - h
    base = (row_base[:, None, :] + lookback).view(rows * tiles, radix)
    dt = dp.view(rows * tiles, tile).clamp(max=radix - 1)
    pos = global_pos(dt, base, rank).view(rows, -1)[:, :m].to(torch.int64)
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
        lib.radix_onesweep_hist.argtypes = [i, vp, vp, ll, ll, i, vp]
        lib.radix_onesweep_hist.restype = i
        lib.radix_onesweep_pass.argtypes = [i, vp, vp, vp, vp, vp, vp, ll,
                                            ll, i, i, vp]
        lib.radix_onesweep_pass.restype = i
        lib.radix_bucket_hist.argtypes = [i, vp, ll, vp, i, vp, vp]
        lib.radix_bucket_hist.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_keys(keys, digit_bits: int, name: str) -> None:
    if keys.dim() != 2 or keys.element_size() not in (1, 2, 4) \
            or keys.is_floating_point():
        raise ValueError(f"{name} takes (rows, m) integer keys of 1, 2 or 4 "
                         f"bytes, got {keycodec.dtype_name(keys.dtype)} "
                         f"{tuple(keys.shape)}")
    m = keys.shape[-1]
    if m >= 1 << 31:
        raise ValueError(f"{name}: row length {m} overflows the kernels' "
                         f"int32 positions")
    if keys.shape[0] * -(-m // ONESWEEP_TILE) >= 1 << 31:
        raise ValueError(f"{name}: {keys.shape[0]} rows of {m} keys are too "
                         f"many tiles for the kernels' int32 tile ids")
    if digit_bits not in (1, 2, 4, 8):
        raise ValueError(f"{name}: digit_bits must be 1, 2, 4 or 8")
    if not keys.is_cuda and keys.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {keys.device}")


def _scratch(keys: torch.Tensor, digit_bits: int) -> torch.Tensor:
    """Zeroed look-back words and tile counters for one onesweep sort of
    ``keys``: rows x tiles x 2^digit_bits status words, then one counter a
    pass.  Each pass of one sort uses it once; it is never handed out."""
    rows, m = keys.shape
    tiles = rows * -(-m // ONESWEEP_TILE)
    return torch.zeros(tiles * (1 << digit_bits) + _passes(keys, digit_bits),
                       dtype=torch.int64, device=keys.device)


def onesweep_hist(keys: torch.Tensor, digit_bits: int) -> torch.Tensor:
    """(rows, m) keys -> (rows, passes, 2^digit_bits) int32 digit counts
    of every pass: one launch of ``radix_onesweep_hist`` for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check_keys(keys, digit_bits, "onesweep_hist")
    if not keys.is_cuda:
        return onesweep_hist_plain(keys, digit_bits)
    if not keys.is_contiguous():
        raise ValueError("onesweep_hist: keys must be contiguous")
    rows, m = keys.shape
    hist = torch.zeros((rows, _passes(keys, digit_bits), 1 << digit_bits),
                       dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return hist
    with torch.cuda.device(keys.device):
        status = _lib().radix_onesweep_hist(
            keys.element_size(), _build.ptr(keys), _build.ptr(hist), rows, m,
            digit_bits, _build.stream_of(keys))
    _build.check(status, "radix_onesweep_hist")
    _build.count_launch("radix_onesweep_hist")
    return hist


def onesweep_pass(keys: torch.Tensor, vals: Optional[torch.Tensor],
                  hist: torch.Tensor, shift: int, digit_bits: int
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Digit pass ``shift`` of a onesweep sort of each row: one launch of
    ``radix_onesweep_pass`` (on a look-back scratch of its own) for a CUDA
    tensor, the plain version for a CPU tensor.  ``hist`` is
    :func:`onesweep_hist` of the sort's input."""
    return _pass(keys, vals, hist, shift, digit_bits, None)


def _pass(keys, vals, hist, shift, digit_bits, scratch):
    """:func:`onesweep_pass` on the sort's ``scratch`` (a fresh one if
    None); a scratch serves each pass of one sort once."""
    _check_keys(keys, digit_bits, "onesweep_pass")
    rows, m = keys.shape
    radix, passes = 1 << digit_bits, _passes(keys, digit_bits)
    if shift % digit_bits or not 0 <= shift < passes * digit_bits:
        raise ValueError(f"onesweep_pass: shift {shift} is not a digit of "
                         f"{passes} x {digit_bits} bits")
    if hist.shape != (rows, passes, radix) or hist.dtype != torch.int32:
        raise ValueError(f"onesweep_pass: hist must be int32 "
                         f"({rows}, {passes}, {radix})")
    if vals is not None and (vals.dtype != torch.int32
                             or vals.shape != keys.shape
                             or vals.device != keys.device):
        raise ValueError("onesweep_pass: the payload must be an int32 "
                         "tensor of the keys' shape and device")
    if not keys.is_cuda:
        return onesweep_pass_plain(keys, vals, hist, shift, digit_bits)
    if not all(t.is_contiguous() for t in (keys, hist)) or \
            (vals is not None and not vals.is_contiguous()):
        raise ValueError("onesweep_pass: keys, payload and hist must be "
                         "contiguous")
    kout = torch.empty_like(keys)
    vout = None if vals is None else torch.empty_like(vals)
    if keys.numel() == 0:
        return kout, vout
    if scratch is None:
        scratch = _scratch(keys, digit_bits)
    with torch.cuda.device(keys.device):
        status = _lib().radix_onesweep_pass(
            keys.element_size(), _build.ptr(keys), _build.ptr(vals),
            _build.ptr(kout), _build.ptr(vout), _build.ptr(hist),
            _build.ptr(scratch), rows, m, shift // digit_bits, digit_bits,
            _build.stream_of(keys))
    _build.check(status, "radix_onesweep_pass")
    _build.count_launch("radix_onesweep_pass")
    return kout, vout


# ---------------------------------------------------------------------------
# pass loops
# ---------------------------------------------------------------------------

def onesweep_sort_kv(keys: torch.Tensor, vals: Optional[torch.Tensor],
                     digit_bits: int):
    """The onesweep sort of each row of (rows, m) carrier keys: one
    histogram of every pass, then the passes, least significant digit
    first, all on one look-back scratch.  The kernels on a CUDA tensor,
    their plain versions on a CPU tensor."""
    keys = keys.contiguous()
    vals = None if vals is None else vals.contiguous()
    hist = onesweep_hist(keys, digit_bits)
    scratch = _scratch(keys, digit_bits) if keys.is_cuda else None
    for shift in range(0, keys.element_size() * 8, digit_bits):
        keys, vals = _pass(keys, vals, hist, shift, digit_bits, scratch)
    return keys, vals


def onesweep_sort_kv_plain(keys: torch.Tensor, vals: Optional[torch.Tensor],
                           digit_bits: int):
    """Plain version of :func:`onesweep_sort_kv`, on any device."""
    hist = onesweep_hist_plain(keys, digit_bits)
    for shift in range(0, keys.element_size() * 8, digit_bits):
        keys, vals = onesweep_pass_plain(keys, vals, hist, shift, digit_bits)
    return keys, vals


def _check_carrier(keys):
    if keys.dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError(
            f"radix sort takes keycodec carrier keys (int8/int16/int32), got "
            f"{keycodec.dtype_name(keys.dtype)}")


def sort_kv_blocks(keys: torch.Tensor, vals: Optional[torch.Tensor], *,
                   digit_bits: Optional[int] = None):
    """Stable ascending LSD radix sort of each row of carrier keys, with an
    optional payload riding every pass (:func:`onesweep_sort_kv`).
    ``digit_bits`` defaults to the active tuning profile's."""
    _check_carrier(keys)
    return onesweep_sort_kv(keys, vals, _resolve(None, digit_bits)[1])


def sort_blocks(keys: torch.Tensor, *,
                digit_bits: Optional[int] = None) -> torch.Tensor:
    """Key-only variant of :func:`sort_kv_blocks`."""
    return sort_kv_blocks(keys, None, digit_bits=digit_bits)[0]


# ---------------------------------------------------------------------------
# the sample sort's bucket histogram
# ---------------------------------------------------------------------------

def _check_buckets(keys, splitters, name: str) -> int:
    if keys.dim() != 1 or splitters.dim() != 1:
        raise ValueError(f"{name} takes 1-D keys and splitters, got "
                         f"{tuple(keys.shape)} and {tuple(splitters.shape)}")
    if keys.dtype not in (torch.int8, torch.int16, torch.int32) \
            or splitters.dtype != keys.dtype:
        raise TypeError(f"{name} takes signed-order int8/int16/int32 keys "
                        f"and splitters of one dtype, got "
                        f"{keycodec.dtype_name(keys.dtype)} and "
                        f"{keycodec.dtype_name(splitters.dtype)}")
    bins = splitters.shape[0] + 2
    if bins > MAX_BUCKET_BINS:
        raise ValueError(
            f"{name}: {splitters.shape[0] + 1} buckets + the pad bin = "
            f"{bins} bins, over the kernel's {MAX_BUCKET_BINS} (D + 1 <= "
            f"{MAX_BUCKET_BINS})")
    if keys.device != splitters.device:
        raise ValueError(f"{name}: keys and splitters on different devices")
    return bins


def bucket_hist_plain(keys: torch.Tensor, splitters: torch.Tensor,
                      tile: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`bucket_hist`, the reference's formulation:
    every key's interval id ``searchsorted(splitters, key, side="left")``
    as a digit, tiled like the radix passes (the tail tile padded with the
    extra id D, counted in the pad bin and dropped), the per-tile
    histograms of :func:`digit_stats` summed over the tiles -> (D + 1,)
    int32 with the pad bin zeroed."""
    bins = _check_buckets(keys, splitters, "bucket_hist_plain")
    n_dev = bins - 1
    m = keys.shape[0]
    if m == 0:
        return torch.zeros(bins, dtype=torch.int32, device=keys.device)
    ids = torch.searchsorted(splitters, keys, side="left", out_int32=True)
    tile = min(max(8, _resolve(tile, None)[0]), m)
    mt = -(-m // tile) * tile
    if mt != m:
        ids = torch.cat([ids, ids.new_full((mt - m,), n_dev)])
    hist, _ = digit_stats(ids.view(mt // tile, tile), n_dev + 1)
    counts = hist.sum(0, dtype=torch.int32)
    counts[n_dev] = 0
    return counts


def bucket_hist(keys: torch.Tensor, splitters: torch.Tensor
                ) -> torch.Tensor:
    """(m,) signed-order keys (int8/16/32; the keycodec key with its sign
    bit flipped) and D - 1 splitters of the same dtype -> (D + 1,) int32:
    ``counts[b]`` keys fall in bucket b (a key equal to a splitter in the
    lower bucket), the last bin the reference's pad bin, 0.  The keys must
    be ascending (a sorted shard, as ``bucket_bounds`` has them) and the
    splitters ascending: the kernel searches the shard for each splitter
    and takes differences, so an unsorted shard gives wrong counts (the
    plain version counts any shard).  One launch of ``radix_bucket_hist``
    for a CUDA tensor (D + 1 <= 1024, checked here), the plain version for
    a CPU tensor."""
    bins = _check_buckets(keys, splitters, "bucket_hist")
    if not keys.is_cuda:
        if keys.device.type != "cpu":
            raise ValueError(f"bucket_hist: unsupported device {keys.device}")
        return bucket_hist_plain(keys, splitters)
    keys, splitters = keys.contiguous(), splitters.contiguous()
    if keys.numel() == 0:
        return torch.zeros(bins, dtype=torch.int32, device=keys.device)
    counts = torch.empty(bins, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        status = _lib().radix_bucket_hist(
            keys.element_size(), _build.ptr(keys), keys.shape[0],
            _build.ptr(splitters), splitters.shape[0], _build.ptr(counts),
            _build.stream_of(keys))
    _build.check(status, "radix_bucket_hist")
    _build.count_launch("radix_bucket_hist")
    return counts
