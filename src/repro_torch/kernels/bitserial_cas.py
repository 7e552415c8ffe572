"""K7 — the paper's bit-serial compare-and-swap: the CUDA kernels, their
plain versions, and the generator of the kernels' gate programs.

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
* :func:`cas_blocks` — on a CUDA tensor it launches the pair kernel
  ``bitserial_cas`` (``csrc/bitserial_cas.cu``); on a CPU tensor it runs
  the plain version.
* :func:`cas_stages` — stages (k, j) of the bitonic network over the
  (batch, n) words of the in-memory sorter, in place: on a CUDA tensor one
  launch of ``bitserial_cas_stage`` a stage, on a CPU tensor
  :func:`stage_plain`.
* :func:`program_header` — the gate program of every width as
  straight-line C++ (``csrc/cas_programs.cuh``, checked in).  Regenerate
  it after a change to ``core/gates.py`` with::

      PYTHONPATH=src python -m repro_torch.kernels.bitserial_cas

  ``tests/test_torch_imc.py::test_k7_header_is_generated_from_the_programs``
  pins the checked-in file to it.

All take and return int32 words that carry the W low bits (bit 31 set is
a negative carrier at W = 32), as the reference casts its operands to
int32.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.cas import cached_program
from repro_torch.core.imc_array import (ROW_A, ROW_B, ROW_ONE, ROW_ZERO,
                                        Movement, OpKind)
from repro_torch.core.keycodec import wrap_int32
from repro_torch.kernels import _build

__all__ = ["WIDTHS", "program_table", "program_header", "exec_program_plain",
           "cas_blocks", "stage_pairs", "stage_plain", "cas_stages"]

WIDTHS = (2, 4, 8, 16, 32)
HEADER = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "cas_programs.cuh"

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
    """The gate program of width W as an op table: (n_ops, 7) int32 rows of
    (kind NOR 0 / AND 1 / NOT 2 / COPY 3, src1, src2, dst, movement SAME 0
    / SHIFT_RIGHT 1 / BCAST_LAST 2 / BCAST_COL 3, fill, bcast_col), with
    the constant row as src2 of NOT and COPY.  :func:`program_header`
    writes the kernels' code from it.  A CPU tensor; do not modify it."""
    prog = _program(width)
    return torch.tensor([[_KIND[op.kind], op.src1, _src2(op), op.dst,
                          _MOVE[op.movement], op.fill, op.bcast_col]
                         for op in prog.ops], dtype=torch.int32)


# ---------------------------------------------------------------------------
# the kernels' gate programs as straight-line code
# ---------------------------------------------------------------------------

def _op_expr(rec: List[int], names: Dict[int, str], width: int) -> str:
    """One op of the table as a C expression over the named rows: one or
    two integer instructions (``m`` is the W-bit mask)."""
    kind, s1, s2, _, move, fill, col = rec
    x, y = names[s1], names[s2]
    v = f"~({x} | {y}) & m" if kind in (0, 2) else f"{x} & {y}"
    if move == 1:       # column c-1 -> c, the fill into column 0 (the MSB)
        return f"(({v}) >> 1) | ({fill}u << {width - 1})"
    if move == 2:       # the last column (bit 0) to every column
        return f"(({v}) & 1u) ? m : 0u"
    if move == 3:       # column col (bit W-1-col) to every column
        return f"((({v}) >> {width - 1 - col}) & 1u) ? m : 0u"
    return v


def _width_code(width: int) -> List[str]:
    prog = _program(width)
    mask = (1 << width) - 1
    lines = [f"// W = {width}: {len(prog.ops)} ops on {prog.n_rows} rows",
             "template <>",
             "__device__ __forceinline__ void cas_program<"
             f"{width}>(uint32_t& a, uint32_t& b) {{",
             f"  constexpr uint32_t m = 0x{mask:X}u;",
             "  constexpr uint32_t r0 = 0u, r1 = m;  // the constant rows",
             "  const uint32_t r2 = a & m, r3 = b & m;  // rows A and B"]
    names = {ROW_ZERO: "r0", ROW_ONE: "r1", ROW_A: "r2", ROW_B: "r3"}
    for i, (op, rec) in enumerate(zip(prog.ops,
                                      program_table(width).tolist())):
        expr = _op_expr(rec, names, width)
        names[rec[3]] = f"o{i}"
        lines.append(f"  const uint32_t o{i} = {expr};  // row {rec[3]}: "
                     f"{op.kind.value} {op.label}")
    lines += [f"  a = {names[ROW_A]};", f"  b = {names[ROW_B]};", "}", ""]
    return lines


def program_header() -> str:
    """The text of ``csrc/cas_programs.cuh``: ``cas_program<W>(a, b)``
    for every W in :data:`WIDTHS`, each op of the gate program one named
    local, so every row lives in a register."""
    lines = [
        "// K7's gate programs as straight-line code, one op a line.",
        "//",
        "// Generated from kernels/bitserial_cas.py program_table(W) by",
        "// program_header(); do not edit.  Regenerate with",
        "//   PYTHONPATH=src python -m repro_torch.kernels.bitserial_cas",
        "//",
        "// cas_program<W>(a, b) states every gate of",
        "// core/gates.build_cas_program(W) for one operand pair and leaves",
        "// (min, max) in (a, b).  A row is a W-bit mask in a uint32_t,",
        "// column c (column 0 the MSB) at bit W-1-c; every op writes a new",
        "// named local, so a row reused by the program is a new register",
        "// and the row file is never indexed.  Nothing here compares a",
        "// with b.  nvcc compiles the gates' logic, not each gate: it",
        "// merges a NOR with the NOT that reads it, folds runs of shifts",
        "// and drops the closing COPYs, so a pair costs fewer instructions",
        "// than the program has gates (chip_smoke.py counts them in the",
        "// SASS).",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "template <int W>",
        "__device__ __forceinline__ void cas_program(uint32_t& a, "
        "uint32_t& b);",
        "",
    ]
    for width in WIDTHS:
        lines += _width_code(width)
    return "\n".join(lines)


def write_header(path: pathlib.Path = HEADER) -> None:
    path.write_text(program_header())


# ---------------------------------------------------------------------------
# the plain versions
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


def _check_stage(n: int, k: int, j: int) -> None:
    if n < 2 or n & (n - 1) or k < 2 or k & (k - 1) or k > n \
            or j < 1 or j & (j - 1) or j >= k:
        raise ValueError(f"bitonic stage needs powers of two j < k <= n, "
                         f"got n={n}, k={k}, j={j}")


def stage_pairs(n: int, k: int, j: int, device="cpu"):
    """The pairs of bitonic stage (k, j) over n positions: the low index i
    of every pair (``i & j == 0``), its partner ``i ^ j``, and whether the
    pair sorts ascending (``i & k == 0``).  Every position lies in exactly
    one pair."""
    _check_stage(n, k, j)
    i = torch.arange(n, dtype=torch.int64, device=device)
    i = i[(i & j) == 0]
    return i, i | j, (i & k) == 0


def stage_plain(v: torch.Tensor, k: int, j: int, width: int
                ) -> torch.Tensor:
    """Plain version of the stage kernel: gather both operands of every
    pair of stage (k, j), run the gate program, put (min, max) back in the
    pair's direction.  (batch, n) int32 words -> a new tensor."""
    i, p, asc = stage_pairs(v.shape[-1], k, j, v.device)
    lo, hi = exec_program_plain(v.index_select(1, i), v.index_select(1, p),
                                width)
    out = torch.empty_like(v)
    out[:, i] = torch.where(asc, lo, hi)
    out[:, p] = torch.where(asc, hi, lo)
    return out


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("bitserial_cas")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bitserial_cas.argtypes = [vp, vp, vp, vp, ll, i, vp]
        lib.bitserial_cas.restype = i
        lib.bitserial_cas_stage.argtypes = [vp, ll, ll, ll, ll, i, vp]
        lib.bitserial_cas_stage.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_words(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: operands must be int32 words, got "
                            f"{t.dtype}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: operands on {ts[0].device} and "
                             f"{t.device}")
    if not ts[0].is_cuda and ts[0].device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {ts[0].device}")


def cas_blocks(a: torch.Tensor, b: torch.Tensor, *, width: int = 4
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise in-memory CAS of int32 words < 2**width (their W low
    bits) -> (min, max) int32 words, one launch of the pair kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    _check_width(width)
    if a.shape != b.shape:
        raise ValueError(f"cas_blocks: operand shapes differ, "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    _check_words("cas_blocks", a, b)
    if not a.is_cuda:
        return exec_program_plain(a, b, width)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("cas_blocks: operands must be contiguous")
    lo, hi = torch.empty_like(a), torch.empty_like(b)
    if a.numel() == 0:
        return lo, hi
    with torch.cuda.device(a.device):
        status = _lib().bitserial_cas(
            _build.ptr(a), _build.ptr(b), _build.ptr(lo), _build.ptr(hi),
            a.numel(), width, _build.stream_of(a))
    _build.check(status, "bitserial_cas")
    _build.count_launch("bitserial_cas")
    return lo, hi


def cas_stages(v: torch.Tensor, schedule, width: int) -> torch.Tensor:
    """Bitonic stages (k, j), each of ``schedule`` in turn, over each row
    of (batch, n) int32 words, in place: every pair (i, i ^ j) with
    ``i & j == 0`` gets (min, max) by the gate program, ascending where
    ``i & k == 0``.  One launch of the stage kernel a stage for a CUDA
    tensor (the checks and the launch's arguments made once, so a network
    of small stages does not pay them a stage), :func:`stage_plain` for a
    CPU tensor.  Returns ``v``."""
    _check_width(width)
    _check_words("cas_stages", v)
    if v.dim() != 2:
        raise ValueError(f"cas_stages takes (batch, n) words, got "
                         f"{tuple(v.shape)}")
    batch, n = v.shape
    schedule = list(schedule)
    for k, j in schedule:
        _check_stage(n, k, j)
    if n >= 1 << 31:
        raise ValueError(f"cas_stages: rows of {n} words overflow the "
                         f"kernel's int32 positions")
    if not v.is_cuda:
        for k, j in schedule:
            v.copy_(stage_plain(v, k, j, width))
        return v
    if not v.is_contiguous():
        raise ValueError("cas_stages: words must be contiguous")
    if v.numel() == 0:
        return v
    launch, words = _lib().bitserial_cas_stage, _build.ptr(v)
    with torch.cuda.device(v.device):
        stream = _build.stream_of(v)
        for k, j in schedule:
            _build.check(launch(words, batch, n, k, j, width, stream),
                         "bitserial_cas_stage")
            _build.count_launch("bitserial_cas_stage")
    return v


if __name__ == "__main__":
    write_header()
    print(f"wrote {HEADER}")
