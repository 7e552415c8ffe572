"""Cycle-accurate functional simulator of the 6T SRAM IMC array (paper §I-II).

The port of the JAX package's simulator, op for op.  The array computes,
in ONE cycle, an elementwise two-input logic op over *all columns* of two
simultaneously-activated rows:

    AND  on the BL  (bitline)          — Fig. 1(b)
    NOR  on the BLB (complement line)  — Fig. 1(c)

Derived single-cycle ops (paper §II-A, using the constant rows):
    NOT(x)  = NOR(x, ROW_ZERO)   — row 1 stores logic 0
    COPY(x) = AND(x, ROW_ONE)    — row 2 stores logic 1

Each cycle's result is written back with ONE of four movement types
(paper §II-A, write-back taxonomy a-d):
    SAME        (a) write back column-aligned
    SHIFT_RIGHT (b) write to the adjacent right column (column 0 takes the
                    selected constant fill — the constant rows are adjacent)
    BCAST_LAST  (c) the last column's value is written to all columns
    BCAST_COL   (d) an interior column's value is written to all columns

State is a torch bool tensor ``(batch, n_rows, n_cols)`` with column 0 the
MSB; every op is batched over independent arrays (exact: bitline logic is
column-parallel).  ``step`` returns a new state, as the reference's
functional update does; ``run_program`` copies the state once and updates
the copy in place.  A :class:`CycleCounter` tallies op kinds for
validation against Table I.

Words ride in int32 carriers holding the W low bits (bit 31 may be set at
W = 32): torch's ``uint32`` has no shifts or comparisons on the CPU.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import torch

from repro_torch.core.keycodec import wrap_int32

ROW_ZERO = 0  # constant 0s (paper row 1)
ROW_ONE = 1   # constant 1s (paper row 2)
ROW_A = 2     # operand A   (paper row 3)
ROW_B = 3     # operand B   (paper row 4)


class OpKind(enum.Enum):
    NOR = "NOR"
    AND = "AND"
    NOT = "NOT"    # NOR with ROW_ZERO
    COPY = "COPY"  # AND with ROW_ONE


class Movement(enum.Enum):
    SAME = "same"
    SHIFT_RIGHT = "shift_right"
    BCAST_LAST = "bcast_last"
    BCAST_COL = "bcast_col"


@dataclasses.dataclass(frozen=True)
class Op:
    kind: OpKind
    src1: int
    dst: int
    src2: Optional[int] = None           # None for NOT/COPY (implicit const row)
    movement: Movement = Movement.SAME
    fill: int = 0                        # SHIFT_RIGHT column-0 fill (0 or 1)
    bcast_col: int = 0                   # BCAST_COL source column
    label: str = ""


@dataclasses.dataclass
class CycleCounter:
    nor: int = 0
    and_: int = 0
    not_: int = 0
    copy: int = 0

    @property
    def total(self) -> int:
        return self.nor + self.and_ + self.not_ + self.copy

    def count(self, kind: OpKind) -> None:
        if kind is OpKind.NOR:
            self.nor += 1
        elif kind is OpKind.AND:
            self.and_ += 1
        elif kind is OpKind.NOT:
            self.not_ += 1
        else:
            self.copy += 1

    def as_dict(self) -> dict:
        return {"NOR": self.nor, "NOT": self.not_, "AND": self.and_,
                "COPY": self.copy, "total": self.total}


def make_array(batch: int, n_rows: int, n_cols: int,
               device="cpu") -> torch.Tensor:
    """Fresh array with the constant rows initialised (rows 0/1)."""
    state = torch.zeros((batch, n_rows, n_cols), dtype=torch.bool,
                        device=device)
    state[:, ROW_ONE, :] = True
    return state


def write_word(state: torch.Tensor, row: int,
               bits: torch.Tensor) -> torch.Tensor:
    """Write a (batch, n_cols) bit matrix into a row (column 0 = MSB);
    returns a new state."""
    state = state.clone()
    state[:, row, :] = bits.to(torch.bool)
    return state


def read_word(state: torch.Tensor, row: int) -> torch.Tensor:
    return state[:, row, :]


def _compute(state: torch.Tensor, op: Op) -> torch.Tensor:
    a = state[:, op.src1, :]
    if op.kind is OpKind.NOR:
        return ~(a | state[:, op.src2, :])
    if op.kind is OpKind.AND:
        return a & state[:, op.src2, :]
    if op.kind is OpKind.NOT:       # NOR with the constant-0 row
        return ~(a | state[:, ROW_ZERO, :])
    # COPY: AND with the constant-1 row
    return a & state[:, ROW_ONE, :]


def _move(result: torch.Tensor, op: Op) -> torch.Tensor:
    if op.movement is Movement.SAME:
        return result
    if op.movement is Movement.SHIFT_RIGHT:
        fill = torch.full_like(result[:, :1], bool(op.fill))
        return torch.cat([fill, result[:, :-1]], dim=1)
    if op.movement is Movement.BCAST_LAST:
        return result[:, -1:].expand(result.shape)
    # BCAST_COL
    return result[:, op.bcast_col:op.bcast_col + 1].expand(result.shape)


def _step_(state: torch.Tensor, op: Op,
           counter: Optional[CycleCounter]) -> torch.Tensor:
    if counter is not None:
        counter.count(op.kind)
    state[:, op.dst, :] = _move(_compute(state, op), op)
    return state


def step(state: torch.Tensor, op: Op,
         counter: Optional[CycleCounter] = None) -> torch.Tensor:
    """Execute ONE IMC cycle: compute over all columns, move, write back
    (into a new state)."""
    return _step_(state.clone(), op, counter)


def run_program(state: torch.Tensor, program: List[Op],
                counter: Optional[CycleCounter] = None) -> torch.Tensor:
    state = state.clone()
    for op in program:
        _step_(state, op, counter)
    return state


# -- word <-> bit-plane helpers (column 0 is the MSB, as in the paper) -------

def int_to_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """(batch,) words -> (batch, width) bool, MSB first (the W low bits of
    each word's 32-bit pattern)."""
    shifts = torch.arange(width - 1, -1, -1, device=x.device)
    return ((x.to(torch.int64)[:, None] >> shifts[None, :]) & 1).to(
        torch.bool)


def bits_to_int(bits: torch.Tensor) -> torch.Tensor:
    """(batch, width) bool, MSB first -> (batch,) int32 words carrying the
    bits (bit 31 set is a negative carrier)."""
    width = bits.shape[-1]
    shifts = torch.arange(width - 1, -1, -1, device=bits.device)
    return wrap_int32((bits.to(torch.int64) << shifts).sum(-1))
