"""Deep-dive into the in-memory CAS block: watch the 28-cycle gate program
execute on the simulated 6T SRAM array, cycle by cycle.

The array is a (batch, rows, columns) bool tensor on ``--device`` (the
card by default); each cycle is one NOR / NOT / AND / COPY over a whole
row, as the paper's Table I counts them.

Run:  PYTHONPATH=src python examples/torch/imc_sort_demo.py [A] [B] \\
          [--device cpu]
"""
import argparse

import torch

from repro_torch.core import gates, imc_array


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the CAS block, cycle by cycle")
    ap.add_argument("a", nargs="?", type=int, default=0b1000,
                    help="operand A (paper Fig. 7: 1000)")
    ap.add_argument("b", nargs="?", type=int, default=0b0001,
                    help="operand B (paper Fig. 7: 0001)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    a, b, dev = args.a, args.b, args.device

    prog = gates.build_cas_program(4)
    print(f"CAS of A={a:04b} B={b:04b} on a {prog.n_rows}-row x 4-col IMC "
          f"array")
    print(f"phases: compare={prog.compare_cycles} mux={prog.mux_cycles} "
          f"writeback={prog.writeback_cycles}  (paper: 18/8/2)\n")

    state = imc_array.make_array(1, prog.n_rows, 4, device=dev)
    for row, word in ((imc_array.ROW_A, a), (imc_array.ROW_B, b)):
        state = imc_array.write_word(state, row, imc_array.int_to_bits(
            torch.tensor([word], dtype=torch.int32, device=dev), 4))
    counter = imc_array.CycleCounter()
    for cyc, op in enumerate(prog.ops, start=1):
        state = imc_array.step(state, op, counter)
        row = state[0, op.dst].to(torch.int32).cpu().tolist()
        print(f"cycle {cyc:2d}  {op.kind.value:4s} -> row {op.dst:2d} "
              f"[{''.join(map(str, row))}]  {op.label}")

    lo = int(imc_array.bits_to_int(
        imc_array.read_word(state, imc_array.ROW_A))[0])
    hi = int(imc_array.bits_to_int(
        imc_array.read_word(state, imc_array.ROW_B))[0])
    print(f"\nresult: min={lo:04b} (row 3, cycle 28)  max={hi:04b} "
          f"(row 4, cycle 27)")
    print(f"op mix: {counter.as_dict()}   paper Table I: NOR 14 NOT 8 AND 3 "
          f"COPY 3")
    assert (lo, hi) == (min(a, b), max(a, b))
    return {"lo": lo, "hi": hi, "op_mix": counter.as_dict(),
            "phases": (prog.compare_cycles, prog.mux_cycles,
                       prog.writeback_cycles)}


if __name__ == "__main__":
    main()
