"""Order-preserving key codec — the radix front-end every ordered path shares.

The same monotone bijections as the JAX package's codec:

  signed int   flip the sign bit          (biased / excess-2^(b-1) code)
  float        sign-magnitude -> lexicographic: negative values flip ALL
               bits, non-negative values flip only the sign bit

``decode(encode(x)) == x`` bit-exactly, and ``x < y`` in the source order
iff ``encode(x) < encode(y)`` as unsigned integers.  ``descending``
complements the encoded key, so one ascending stable radix sort serves both
directions while ties keep ascending index order.

Carrier.  torch has no ``<``, ``>>``, ``where`` or gather on ``uint16`` /
``uint32`` tensors on the CPU, so an encoded b-bit key lives in the signed
integer type of the same width (``int8``/``int16``/``int32``) holding the
unsigned key's exact bit pattern.  The CUDA kernels read the same bytes as
``uint8_t``/``uint16_t``/``uint32_t``; the plain paths only ever XOR, mask
and shift-after-widening, which are the same on either reading.  Viewing a
carrier as ``uint8/16/32`` (``.view``) gives the JAX package's keys.

Supported dtypes: uint8/16/32, int8/16/32, float16, bfloat16, float32.
NaN-free floats are assumed; the float code orders -0.0 strictly below
+0.0.
"""
from __future__ import annotations

import torch

# source dtype name -> (bits, kind)
_TABLE = {
    "uint8": (8, "u"),
    "uint16": (16, "u"),
    "uint32": (32, "u"),
    "int8": (8, "i"),
    "int16": (16, "i"),
    "int32": (32, "i"),
    "float16": (16, "f"),
    "bfloat16": (16, "f"),
    "float32": (32, "f"),
}

SUPPORTED = tuple(_TABLE)

_CARRIER = {8: torch.int8, 16: torch.int16, 32: torch.int32}

# unsigned dtypes torch cannot compare or move on the CPU -> the signed
# carrier of the same width
_UNSIGNED_WIDE = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the registry's dtype names)."""
    return str(dtype).rsplit(".", 1)[-1]


def supports(dtype) -> bool:
    """True if ``dtype`` has an order-preserving unsigned encoding here."""
    return dtype_name(dtype) in _TABLE


def _entry(dtype):
    name = dtype_name(dtype)
    if name not in _TABLE:
        raise ValueError(f"keycodec supports {SUPPORTED}, got {name!r}")
    return _TABLE[name]


def key_bits(dtype) -> int:
    """Radix key width in bits for ``dtype`` (== its storage width)."""
    return _entry(dtype)[0]


def key_dtype(dtype) -> torch.dtype:
    """The carrier dtype the encoded keys live in (see module docstring)."""
    return _CARRIER[key_bits(dtype)]


def _masks(bits: int):
    # sign bit and all-ones as values of the signed carrier
    return -(1 << (bits - 1)), -1


def _bits_view(x: torch.Tensor, bits: int) -> torch.Tensor:
    carrier = _CARRIER[bits]
    if x.dtype == carrier:
        return x
    if x.dtype == torch.uint8:
        # same width, wraps bit-for-bit (views between 1-byte types)
        return x.view(torch.int8)
    return x.view(carrier)


def encode(x: torch.Tensor, *, descending: bool = False) -> torch.Tensor:
    """Map ``x`` to carrier keys whose unsigned order matches the source
    order (complemented with ``descending=True``)."""
    bits, kind = _entry(x.dtype)
    sign, full = _masks(bits)
    u = _bits_view(x, bits)
    if kind == "i":
        u = u ^ sign
    elif kind == "f":
        # the arithmetic shift smears the sign bit: all ones for negative
        # values (flip every bit), zero otherwise (flip the sign bit only)
        u = u ^ ((u >> (bits - 1)) | sign)
    if descending:
        u = u ^ full
    return u


def decode(keys: torch.Tensor, dtype, *, descending: bool = False
           ) -> torch.Tensor:
    """Inverse of :func:`encode`: carrier keys back to ``dtype``."""
    bits, kind = _entry(dtype)
    carrier = _CARRIER[bits]
    if keys.dtype != carrier:
        raise ValueError(
            f"keys for {dtype_name(dtype)} must be {dtype_name(carrier)}, "
            f"got {dtype_name(keys.dtype)}")
    sign, full = _masks(bits)
    u = keys ^ full if descending else keys
    if kind == "i":
        u = u ^ sign
    elif kind == "f":
        # encoded non-negatives have the top bit set; negatives had all
        # bits flipped, so their encoded top bit is clear
        u = u ^ (~(u >> (bits - 1)) | sign)
    return u if dtype == carrier else u.view(dtype)


def to_signed(x: torch.Tensor) -> torch.Tensor:
    """``uint16``/``uint32`` -> the same-width signed type in the same
    order (sign bit flipped); every other dtype is returned unchanged.
    Lets the engine move and compare unsigned keys with torch ops that do
    not exist for those dtypes; :func:`from_signed` inverts it."""
    carrier = _UNSIGNED_WIDE.get(x.dtype)
    if carrier is None:
        return x
    return x.view(carrier) ^ _masks(key_bits(x.dtype))[0]


def from_signed(y: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`to_signed` for a tensor that was ``dtype``."""
    if dtype not in _UNSIGNED_WIDE:
        return y
    return (y ^ _masks(key_bits(dtype))[0]).view(dtype)


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """A signed integer key whose order is the IEEE total order of ``x``
    (-0.0 below +0.0) for floats, and ``x`` itself for integers.

    ``jax.lax.top_k`` ranks +0.0 above -0.0, so a top-k that must match it
    bit-exactly sorts on this key, not on the float values."""
    bits, kind = _entry(x.dtype)
    if kind != "f":
        return x
    return encode(x) ^ _masks(bits)[0]
