"""K7 — the paper's bit-serial compare-and-swap: the CUDA kernel and its
plain version.

The reconstructed NOR/NOT/AND/COPY gate program of
:func:`repro_torch.core.gates.build_cas_program` run over bit-planes, one
op per simulated IMC cycle; the result is the elementwise (min, max) of
W-bit unsigned words.  It is the paper's faithful mode, not a fast path:
word-parallel min/max would be about W times cheaper.

* :func:`exec_program_plain` — the plain version, a transcription of the
  reference's ``_exec_program`` (``src/repro/kernels/bitserial_cas.py``)
  over bool bit-planes of shape ``a.shape + (W,)``, column 0 the MSB.  A
  plane is dropped as soon as no later op reads it, so its memory is the
  few live planes, not the program's 22-98 rows.
* :func:`cas_blocks` — on a CUDA tensor it launches K7
  (``csrc/bitserial_cas.cu``) with the program as an int32 op table; on a
  CPU tensor it runs the plain version.

Both take and return int32 words that carry the W low bits (bit 31 set is
a negative carrier at W = 32), as the reference casts its operands to
int32.  ``kernels/ops.bitserial_cas`` flattens and pads any shape into the
reference's 128-lane rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.cas import cached_program
from repro_torch.core.imc_array import (ROW_A, ROW_B, ROW_ONE, ROW_ZERO,
                                        Movement, OpKind)
from repro_torch.core.keycodec import wrap_int32
from repro_torch.kernels import _build

__all__ = ["WIDTHS", "program_table", "exec_program_plain", "cas_blocks"]

WIDTHS = (2, 4, 8, 16, 32)
MAX_OPS = 128     # csrc/bitserial_cas.cu kMaxOps
MAX_ROWS = 128    # csrc/bitserial_cas.cu kMaxRows

_KIND = {OpKind.NOR: 0, OpKind.AND: 1, OpKind.NOT: 2, OpKind.COPY: 3}
_MOVE = {Movement.SAME: 0, Movement.SHIFT_RIGHT: 1, Movement.BCAST_LAST: 2,
         Movement.BCAST_COL: 3}
# the constant row NOT (a NOR) and COPY (an AND) read as their second input
_CONST_SRC = {OpKind.NOT: ROW_ZERO, OpKind.COPY: ROW_ONE}


def _check_width(width: int) -> None:
    if width not in WIDTHS:
        raise ValueError(f"bitserial CAS width must be one of {WIDTHS}, "
                         f"got {width}")


def _program(width: int):
    _check_width(width)
    return cached_program(width)


def _src2(op) -> int:
    return _CONST_SRC.get(op.kind, op.src2)


@functools.lru_cache(maxsize=None)
def program_table(width: int) -> torch.Tensor:
    """The gate program of width W as the kernel's op table: (n_ops, 7)
    int32 rows of (kind, src1, src2, dst, movement, fill, bcast_col), with
    the constant row as src2 of NOT and COPY.  A CPU tensor; do not
    modify it."""
    prog = _program(width)
    if len(prog.ops) > MAX_OPS or prog.n_rows > MAX_ROWS:
        raise ValueError(f"W={width}: {len(prog.ops)} ops on {prog.n_rows} "
                         f"rows exceed the kernel's {MAX_OPS} / {MAX_ROWS}")
    return torch.tensor([[_KIND[op.kind], op.src1, _src2(op), op.dst,
                          _MOVE[op.movement], op.fill, op.bcast_col]
                         for op in prog.ops], dtype=torch.int32)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _last_reads(ops) -> Dict[int, int]:
    last: Dict[int, int] = {}
    for i, op in enumerate(ops):
        last[op.src1] = i
        last[_src2(op)] = i
    return last


def exec_program_plain(a: torch.Tensor, b: torch.Tensor, width: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the gate program on int32 words of any (equal) shape over bool
    bit-planes -> (min, max) int32 words of the W low bits."""
    prog = _program(width)
    shape = a.shape + (width,)
    shifts = range(width - 1, -1, -1)            # column c is bit W-1-c

    def unpack(w):
        plane = torch.empty(shape, dtype=torch.bool, device=w.device)
        for c, s in enumerate(shifts):
            plane[..., c] = ((w >> s) & 1).to(torch.bool)
        return plane

    ones = (1,) * a.dim() + (width,)
    planes = {ROW_ZERO: torch.zeros(ones, dtype=torch.bool, device=a.device),
              ROW_ONE: torch.ones(ones, dtype=torch.bool, device=a.device),
              ROW_A: unpack(a), ROW_B: unpack(b)}
    last = _last_reads(prog.ops)
    for i, op in enumerate(prog.ops):
        x, y = planes[op.src1], planes[_src2(op)]
        if op.kind in (OpKind.NOR, OpKind.NOT):
            r = ~(x | y)
        else:                                    # AND, COPY
            r = x & y
        if op.movement is Movement.SHIFT_RIGHT:
            fill = torch.full_like(r[..., :1], bool(op.fill))
            r = torch.cat([fill, r[..., :-1]], dim=-1)
        elif op.movement is Movement.BCAST_LAST:
            r = r[..., -1:].expand(r.shape)
        elif op.movement is Movement.BCAST_COL:
            r = r[..., op.bcast_col:op.bcast_col + 1].expand(r.shape)
        planes[op.dst] = r
        for src in (op.src1, _src2(op)):
            if last[src] == i and src > ROW_B and src != op.dst:
                planes.pop(src, None)

    def pack(plane):
        acc = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
        for c, s in enumerate(shifts):
            acc |= plane[..., c].to(torch.int64) << s
        return wrap_int32(acc)

    return pack(planes[ROW_A]), pack(planes[ROW_B])


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None
_TABLES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("bitserial_cas")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bitserial_cas.argtypes = [vp, vp, vp, vp, ll, vp, i, i, i, vp]
        lib.bitserial_cas.restype = i
        _lib_handle = lib
    return _lib_handle


def _device_table(width: int, device: torch.device) -> torch.Tensor:
    """The op table on the card, copied once per (width, card)."""
    key = (width, device)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = program_table(width).to(device)
    return t


def cas_blocks(a: torch.Tensor, b: torch.Tensor, *, width: int = 4
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise in-memory CAS of int32 words < 2**width (their W low
    bits) -> (min, max) int32 words, one K7 launch for a CUDA tensor, the
    plain version for a CPU tensor."""
    _check_width(width)
    if a.shape != b.shape:
        raise ValueError(f"cas_blocks: operand shapes differ, "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"cas_blocks: operands must be int32 words, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"cas_blocks: operands on {a.device} and {b.device}")
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"cas_blocks: unsupported device {a.device}")
        return exec_program_plain(a, b, width)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("cas_blocks: operands must be contiguous")
    lo, hi = torch.empty_like(a), torch.empty_like(b)
    if a.numel() == 0:
        return lo, hi
    table = _device_table(width, a.device)
    with torch.cuda.device(a.device):
        status = _lib().bitserial_cas(
            _build.ptr(a), _build.ptr(b), _build.ptr(lo), _build.ptr(hi),
            a.numel(), _build.ptr(table), table.shape[0],
            _program(width).n_rows, width, _build.stream_of(a))
    _build.check(status, "bitserial_cas")
    _build.count_launch("bitserial_cas")
    return lo, hi
