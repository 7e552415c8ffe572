"""Two-input gate programs for the in-memory CAS block (paper Fig. 3-5).

The port's own copy of the JAX package's ``core/gates.py`` (pure Python):
the op lists are equal op for op at every width, labels included.  On a
CUDA card the program runs as K7 (``kernels/bitserial_cas.py``), which is
handed the op list as a table and never a netlist written into C++.

The paper's 6T SRAM IMC substrate cannot run 3/4-input gates (data-flipping
issue, [13]), so the comparator and multiplexers are compiled to two-input
NOR/AND plus derived NOT/COPY, executed one op per cycle over all columns.

This is a *reconstruction*: the text names gate outputs (G29,16 / G30,17 /
G31,18) and gives phase totals, but not the full netlist.  The program built
here matches the paper's structure exactly for W=4:

  * 22 rows   (constants in rows 1-2, A/B in rows 3-4 — paper Fig. 5 is 4x22)
  * compare phase = 18 cycles; the comparison result is broadcast to all
    columns in cycle 17 (paper: G30,17) and its inverse — the mux select —
    is produced in cycle 18 (paper: G31,18)
  * mux phase = 8 cycles (cycles 19-26), reusing compare-phase rows
  * max written to row B in cycle 27, min to row A in cycle 28 (paper §II-A)
  * 28 cycles total (Table I)

Our op MIX differs from Table I (we count NOR 11 / NOT 4 / AND 4 / COPY 9 vs
the paper's 14/8/3/3) because the netlist is under-specified; every REPORTED
number in the cost model uses the paper's published counts (cost_model.py).

Widths other than 4 are supported as clearly-marked extrapolations: the
comparator prefix/reduction depth grows with W under the paper's
adjacent-column-copy constraint.

Comparator math (column 0 = MSB, as in the paper's A = A0 A1 A2 A3):

    e_i  = XNOR(A_i, B_i)                 bitwise equality
    l_i  = ~A_i & B_i                     A < B decided at bit i
    P_i  = prod_{j<i} e_j                 all more-significant bits equal
    s    = OR_i (l_i & P_i)  =  (A < B)

    min  = NOR(NOR(A, ~s), NOR(B, s))     3-NOR mux (select = s)
    max  = NOR(NOR(A, s), NOR(B, ~s))
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

from repro_torch.core.imc_array import Movement, Op, OpKind, ROW_A, ROW_B


@dataclasses.dataclass(frozen=True)
class CASProgram:
    width: int
    ops: List[Op]
    n_rows: int
    compare_cycles: int      # cycles until both s and ~s rows are final
    mux_cycles: int
    writeback_cycles: int
    row_s: int               # row holding s = (A < B), broadcast to all cols
    row_ns: int              # row holding ~s

    @property
    def total_cycles(self) -> int:
        return len(self.ops)


class _RowAlloc:
    """Sequential scratch-row allocator starting after the 4 base rows."""

    def __init__(self) -> None:
        self.next = ROW_B + 1
        self.high_water = self.next

    def new(self) -> int:
        row = self.next
        self.next += 1
        self.high_water = max(self.high_water, self.next)
        return row


def build_cas_program(width: int = 4) -> CASProgram:
    if width < 2 or (width & (width - 1)) != 0:
        raise ValueError(f"width must be a power of two >= 2, got {width}")
    ops: List[Op] = []
    rows = _RowAlloc()

    def emit(kind: OpKind, src1: int, src2=None, movement=Movement.SAME,
             fill: int = 0, bcast_col: int = 0, label: str = "",
             dst=None) -> int:
        d = rows.new() if dst is None else dst
        ops.append(Op(kind=kind, src1=src1, src2=src2, dst=d,
                      movement=movement, fill=fill, bcast_col=bcast_col,
                      label=label))
        return d

    # ---- compare phase -----------------------------------------------------
    nab = emit(OpKind.NOR, ROW_A, ROW_B, label="nab = ~(A|B)")
    aab = emit(OpKind.AND, ROW_A, ROW_B, label="aab = A&B")
    x = emit(OpKind.NOR, nab, aab, label="x = XOR(A,B)")
    e = emit(OpKind.NOT, x, label="e = XNOR(A,B)")
    nb = emit(OpKind.NOT, ROW_B, label="nb = ~B")
    l = emit(OpKind.NOR, ROW_A, nb, label="l = ~A & B")

    # exclusive prefix-AND of e via adjacent right-copies (movement type b)
    cur = emit(OpKind.COPY, e, movement=Movement.SHIFT_RIGHT, fill=1,
               label="t = e >> 1 (fill 1)")
    for r in range(width - 2):
        shifted = emit(OpKind.COPY, cur, movement=Movement.SHIFT_RIGHT,
                       fill=1, label=f"prefix shift r{r}")
        cur = emit(OpKind.AND, cur, shifted, label=f"prefix and r{r}")
    prefix = cur

    lt = emit(OpKind.AND, l, prefix, label="lt_i = l_i & P_i")

    # OR-reduce lt over columns; result (inverted) broadcast in the final NOR.
    levels = int(math.log2(width))
    cur = lt
    for k in range(levels - 1):
        part = cur
        for _ in range(1 << k):
            part = emit(OpKind.COPY, part, movement=Movement.SHIFT_RIGHT,
                        fill=0, label=f"or-reduce shift k{k}")
        inv = emit(OpKind.NOR, cur, part, label=f"or-reduce nor k{k}")
        cur = emit(OpKind.NOT, inv, label=f"or-reduce restore k{k}")
    if levels >= 1:
        if width == 2:
            # single final combine straight from lt's two columns
            part = emit(OpKind.COPY, cur, movement=Movement.SHIFT_RIGHT,
                        fill=0, label="final shift (W=2)")
        else:
            # the other half's OR sits in column W/2 - 1: movement type (d)
            part = emit(OpKind.COPY, cur, movement=Movement.BCAST_COL,
                        bcast_col=width // 2 - 1,
                        label="bcast interior column (movement d)")
        row_ns = emit(OpKind.NOR, cur, part, movement=Movement.BCAST_LAST,
                      label="~s broadcast to all columns (G30)")
    row_s = emit(OpKind.NOT, row_ns, label="s = A<B (G31)")
    compare_cycles = len(ops)

    # ---- mux phase (reuses compare scratch rows, paper §II-A) --------------
    mux_rows = iter(range(ROW_B + 1, ROW_B + 1 + 8))

    def memit(kind, src1, src2=None, label="") -> int:
        d = next(mux_rows)
        assert d not in (row_s, row_ns), "mux must not clobber select rows"
        ops.append(Op(kind=kind, src1=src1, src2=src2, dst=d, label=label))
        return d

    u = memit(OpKind.NOR, ROW_A, row_ns, label="u = NOR(A,~s)")
    v = memit(OpKind.NOR, ROW_B, row_s, label="v = NOR(B,s)")
    mn = memit(OpKind.NOR, u, v, label="min = NOR(u,v)")
    u2 = memit(OpKind.NOR, ROW_A, row_s, label="u2 = NOR(A,s)")
    v2 = memit(OpKind.NOR, ROW_B, row_ns, label="v2 = NOR(B,~s)")
    mx = memit(OpKind.NOR, u2, v2, label="max = NOR(u2,v2)")
    stg_mx = memit(OpKind.COPY, mx, label="stage max")
    stg_mn = memit(OpKind.COPY, mn, label="stage min")
    mux_cycles = len(ops) - compare_cycles

    # ---- write-back (paper: max -> row 4 @ cycle 27, min -> row 3 @ 28) ----
    ops.append(Op(OpKind.COPY, stg_mx, dst=ROW_B, label="max -> row B (c27)"))
    ops.append(Op(OpKind.COPY, stg_mn, dst=ROW_A, label="min -> row A (c28)"))
    writeback_cycles = 2

    return CASProgram(width=width, ops=ops, n_rows=rows.high_water,
                      compare_cycles=compare_cycles, mux_cycles=mux_cycles,
                      writeback_cycles=writeback_cycles,
                      row_s=row_s, row_ns=row_ns)
