"""K4 — MSD radix select: exact top-k without sorting the row.

The port of the JAX package's ``kernels/radix_select.py``:

  1. **digit refinement** (most-significant digit first): each pass
     histograms one ``digit_bits``-wide digit of the still-active encoded
     keys (those whose higher bits equal the threshold prefix fixed by
     earlier passes) and takes the smallest digit whose cumulative count
     reaches the residual k.  ``ceil(b/digit_bits)`` passes of O(n)
     counting; no key moves.
  2. **exact-k mask**: with the threshold T and the residual tie budget
     r = k - #{enc < T}, the survivors are every key below T plus the
     first r (ascending index) keys equal to T.  Exactly k survive.
  3. **compact + order**: the survivors are gathered in index order
     (cumulative count + binary search, no scatter) and put in (encoded
     key, index) order.

Keys go through the key codec with ``descending=True``, so the k largest
are the k smallest encoded and ties keep ascending index order:
``jax.lax.top_k``'s convention, with +0.0 above -0.0 (the IEEE total
order).

The histogram is the kernel (``csrc/radix_select.cu``): on a CUDA tensor
:func:`digit_hist` launches it, on a CPU tensor it runs the plain version,
the reference's masked per-tile histogram in PyTorch ops.  The kernel's
grid is sized to the card, not to ``tile``, which only the plain version
reads; the counts do not depend on it.  A selection zeroes one
``(passes, rows, radix)`` buffer and each pass counts into its slice.  The
digit choice between passes is a few ops on ``(rows, radix)`` counts on
the keys' device, with no host synchronisation.  The compaction is
PyTorch ops (``cumsum`` + ``searchsorted``), as it is jnp outside Pallas
in the reference.  The
final order of the k survivors is K1's key-value kernel on a card (k <=
16384) or the engine's merge path (K1 runs, K2 merges) above that, and a
stable ``torch.sort`` on the CPU.

The reference's host path (``use_kernel=False``, a radix-2 refinement)
has no counterpart: the digit-serial refinement is the one engine here.
A selection has one result, so both references give the port's bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import keycodec
from repro_torch.kernels import _build
from repro_torch.kernels.ops import order_candidates
from repro_torch.kernels.radix_sort import _resolve

__all__ = ["pass_tile_counts", "digit_hist", "digit_hist_plain",
           "kth_key_encoded", "select_topk_encoded", "select_topk",
           "select_topk_kv"]

_UNSIGNED_CODE = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32}


def pass_tile_counts(n: int, dtype, tile: Optional[int] = None,
                     digit_bits: Optional[int] = None) -> Tuple[int, int]:
    """(refinement passes, the plain version's histogram tiles per row) at
    this shape, from the shape alone."""
    tile, digit_bits = _resolve(tile, digit_bits)
    tile = min(tile, max(8, n))
    return -(-keycodec.key_bits(dtype) // digit_bits), -(-n // tile)


def _encoded(keys: torch.Tensor, encode: bool) -> torch.Tensor:
    """The descending-encoded carrier keys: ``keys`` themselves when they
    are encoded already."""
    return keycodec.encode(keys, descending=True) if encode else keys


def _unsigned(enc: torch.Tensor) -> torch.Tensor:
    """Carrier keys as their unsigned values, widened to int64."""
    bits = enc.element_size() * 8
    return enc.to(torch.int64) & ((1 << bits) - 1)


# ---------------------------------------------------------------------------
# the histogram: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def digit_hist_plain(keys: torch.Tensor, thresh: torch.Tensor, shift: int,
                     digit_bits: int, tile: int, *,
                     encode: bool) -> torch.Tensor:
    """Plain version of the kernel: the reference's masked per-tile
    histogram.  Inactive and pad slots carry digit ``radix`` and are
    counted into a throwaway column, then every row's tiles are summed."""
    rows, n = keys.shape
    bits = keys.element_size() * 8
    radix = 1 << digit_bits
    u = _unsigned(_encoded(keys, encode))
    d = (u >> shift) & (radix - 1)
    hi = shift + digit_bits
    if hi < bits:
        d = torch.where((u >> hi) == (thresh[:, None] >> hi), d, radix)
    tile = min(tile, max(8, n))
    m = -(-n // tile) * tile
    if m != n:
        d = torch.cat([d, torch.full((rows, m - n), radix, dtype=d.dtype,
                                     device=d.device)], dim=1)
    d = d.reshape(rows * (m // tile), tile)
    per_tile = torch.zeros((d.shape[0], radix + 1), dtype=torch.int32,
                           device=d.device).scatter_add_(
        1, d, torch.ones_like(d, dtype=torch.int32))
    return per_tile.view(rows, m // tile, radix + 1).sum(
        1, dtype=torch.int32)[:, :radix].contiguous()


_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("radix_select")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.select_digit_hist.argtypes = [i, vp, vp, vp, ll, ll, i, i, i,
                                          vp]
        lib.select_digit_hist.restype = i
        _lib_handle = lib
    return _lib_handle


def digit_hist(keys: torch.Tensor, thresh: torch.Tensor, shift: int,
               digit_bits: int, tile: int, *, encode: bool,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, n) keys -> (rows, 2^digit_bits) int32 counts of the digit at
    ``shift`` among the keys still active under ``thresh`` (int64 (rows,),
    the unsigned encoded threshold so far).  ``encode=True``: ``keys`` are
    source-dtype keys, encoded descending on the fly (by the kernel in
    registers); ``encode=False``: they are encoded carrier keys already.
    ``tile`` is the plain version's (the reference's) histogram tile.
    With ``out`` (a zeroed contiguous int32 (rows, 2^digit_bits) tensor on
    the keys' device) the counts are added into it and it is returned:
    no new buffer, no memset."""
    if keys.dim() != 2 or not keycodec.supports(keys.dtype):
        raise ValueError(f"digit_hist takes (rows, n) keys of a codec dtype, "
                         f"got {keycodec.dtype_name(keys.dtype)} "
                         f"{tuple(keys.shape)}")
    rows, n = keys.shape
    if not encode and keys.dtype not in (torch.int8, torch.int16,
                                         torch.int32):
        raise TypeError("encoded keys live in int8/int16/int32 carriers, got "
                        f"{keycodec.dtype_name(keys.dtype)}")
    if digit_bits not in (1, 2, 4, 8) or tile < 1:
        raise ValueError("digit_hist: digit_bits must be 1, 2, 4 or 8 and "
                         "the tile positive")
    if thresh.shape != (rows,) or thresh.dtype != torch.int64 \
            or thresh.device != keys.device:
        raise ValueError("digit_hist: thresh must be an int64 (rows,) tensor "
                         "on the keys' device")
    radix = 1 << digit_bits
    if out is not None and (out.shape != (rows, radix)
                            or out.dtype != torch.int32
                            or out.device != keys.device
                            or not out.is_contiguous()):
        raise ValueError(f"digit_hist: out must be a contiguous int32 "
                         f"({rows}, {radix}) tensor on the keys' device")
    if not keys.is_cuda:
        if keys.device.type != "cpu":
            raise ValueError(f"digit_hist: unsupported device {keys.device}")
        hist = digit_hist_plain(keys, thresh, shift, digit_bits, tile,
                                encode=encode)
        return hist if out is None else out.add_(hist)
    if not (keys.is_contiguous() and thresh.is_contiguous()):
        raise ValueError("digit_hist: keys and thresh must be contiguous")
    hist = out if out is not None else torch.zeros(
        (rows, radix), dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return hist
    code_dtype = keys.dtype if encode else _UNSIGNED_CODE[keys.element_size()]
    with torch.cuda.device(keys.device):
        status = _lib().select_digit_hist(
            _build.KEY_CODES[code_dtype], _build.ptr(keys), _build.ptr(thresh),
            _build.ptr(hist), rows, n, shift, digit_bits, int(encode),
            _build.stream_of(keys))
    _build.check(status, "select_digit_hist")
    _build.count_launch("select_digit_hist")
    return hist


# ---------------------------------------------------------------------------
# digit refinement: the k-th encoded key, no data movement
# ---------------------------------------------------------------------------

def _kth_key(keys: torch.Tensor, k: int, tile: int, digit_bits: int,
             encode: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 unsigned threshold, int32 residual tie budget) per row."""
    rows, _ = keys.shape
    bits = keys.element_size() * 8
    k_rem = torch.full((rows,), k, dtype=torch.int64, device=keys.device)
    thresh = torch.zeros((rows,), dtype=torch.int64, device=keys.device)
    shifts = range(bits - digit_bits, -1, -digit_bits)
    # every pass's histogram, zeroed once
    hists = torch.zeros((len(shifts), rows, 1 << digit_bits),
                        dtype=torch.int32, device=keys.device)
    for p, shift in enumerate(shifts):
        hist = digit_hist(keys, thresh, shift, digit_bits, tile,
                          encode=encode, out=hists[p]).to(torch.int64)
        cum = hist.cumsum(-1)
        # the smallest digit whose cumulative count reaches the residual k
        d = (cum < k_rem[:, None]).sum(-1)
        k_rem = k_rem - (cum - hist).gather(-1, d[:, None])[:, 0]
        thresh = thresh | (d << shift)
    return thresh, k_rem.to(torch.int32)


def _carrier(u: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 unsigned b-bit values -> the signed carrier with those bits."""
    top = (u >> (bits - 1)) & 1
    return (u - (top << bits)).to(keycodec._CARRIER[bits])


def kth_key_encoded(enc: torch.Tensor, k: int, *,
                    tile: Optional[int] = None,
                    digit_bits: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``(rows, n)`` encoded carrier keys: the k-th *smallest*
    encoded key ``T`` (in the carrier) and the residual tie budget
    ``r = k - #{enc < T}`` (int32)."""
    tile, digit_bits = _resolve(tile, digit_bits)
    thresh, k_rem = _kth_key(enc, k, tile, digit_bits, encode=False)
    return _carrier(thresh, enc.element_size() * 8), k_rem


# ---------------------------------------------------------------------------
# exact-k selection
# ---------------------------------------------------------------------------

def _order(s: torch.Tensor, idx: torch.Tensor, n: int):
    """(s, idx) of the k survivors in (s, idx) order; ``idx`` ascends along
    each row, so that is the stable order of ``s``.  The kernels on a
    card (``ops.order_candidates``), ``torch.sort`` on the CPU."""
    if s.is_cuda:
        return order_candidates(s, idx, n, s.shape[-1], descending=False)
    order = torch.sort(s, dim=-1, stable=True).indices
    return s.gather(-1, order), idx.gather(-1, order)


def _select(keys: torch.Tensor, k: int, tile: Optional[int],
            digit_bits: Optional[int], encode: bool):
    """The k smallest encoded keys per row, in (encoded key, index) order:
    (carrier keys, int32 indices), both (rows, k)."""
    if keys.dim() != 2:
        raise ValueError(f"select takes (rows, n), got {tuple(keys.shape)}")
    rows, n = keys.shape
    if not 1 <= k <= n:
        raise ValueError(
            f"topk k must satisfy 1 <= k <= n (n={n}); got k={k}")
    tile, digit_bits = _resolve(tile, digit_bits)
    thresh, k_eq = _kth_key(keys, k, tile, digit_bits, encode)
    enc = _encoded(keys, encode)
    bits = enc.element_size() * 8
    sign = -(1 << (bits - 1))
    # flipping the sign bit makes the carrier's signed order the unsigned
    # order of the encoded keys
    s = enc ^ sign
    t = (_carrier(thresh, bits) ^ sign)[:, None]
    eq = s == t
    eq_rank = eq.to(torch.int32).cumsum(-1, dtype=torch.int32)
    take = (s < t) | (eq & (eq_rank <= k_eq[:, None]))
    # the j-th survivor in index order sits where the running survivor
    # count first reaches j: one binary search, no scatter
    csum = take.to(torch.int32).cumsum(-1, dtype=torch.int32)
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=keys.device) \
        .expand(rows, k).contiguous()
    idx = torch.searchsorted(csum, targets)
    sk, si = _order(s.gather(-1, idx), idx.to(torch.int32), n)
    return sk ^ sign, si


def select_topk_encoded(enc: torch.Tensor, k: int, *,
                        tile: Optional[int] = None,
                        digit_bits: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, n) encoded carrier keys -> the k smallest per row, in
    ascending (encoded, index) order: ``(enc_topk, indices)``, both
    ``(rows, k)``.  Exactly k survive; ties keep ascending index order."""
    if enc.dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError("encoded keys live in int8/int16/int32 carriers, got "
                        f"{keycodec.dtype_name(enc.dtype)}")
    return _select(enc, k, tile, digit_bits, encode=False)


def select_topk(x: torch.Tensor, k: int, *, tile: Optional[int] = None,
                digit_bits: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k largest per row of ``(rows, n)`` -> (values, int32 indices),
    values descending, ties by ascending index, +0.0 above -0.0:
    ``jax.lax.top_k``'s convention, in O(n·b/digit_bits) counting work.
    The histogram passes read ``x`` itself (the kernel encodes in
    registers); the compaction encodes once."""
    if not keycodec.supports(x.dtype):
        raise ValueError(f"select supports {keycodec.SUPPORTED}, got "
                         f"{keycodec.dtype_name(x.dtype)!r}")
    enc, idx = _select(x, k, tile, digit_bits, encode=True)
    return keycodec.decode(enc, x.dtype, descending=True), idx


def select_topk_kv(keys: torch.Tensor, values: torch.Tensor, k: int, *,
                   tile: Optional[int] = None,
                   digit_bits: Optional[int] = None):
    """Key-value variant: ``(topk keys, payload, indices)`` — the payload
    rides the exact-k selection by one gather through the indices."""
    if values.shape != keys.shape:
        raise ValueError(f"values shape {tuple(values.shape)} must match "
                         f"keys shape {tuple(keys.shape)}")
    v, i = select_topk(keys, k, tile=tile, digit_bits=digit_bits)
    return v, values.gather(-1, i.to(torch.int64)), i
