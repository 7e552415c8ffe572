#!/usr/bin/env python3
"""Where each relational op's time goes on one CUDA card, at TPC-H SF10.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 scripts/relational_trace.py

Builds the kernels the relational tier runs (K1-K4), makes
``chip_smoke.py``'s seeded SF10 columns (15 M orders, ~60 M line items)
and traces one warm call of each op through ``method="auto"`` with
``torch.profiler`` (``chip_smoke.trace_summary``): one JSON line an op
with the card's busy ms (its kernels' own times summed) and the kernels
and aten ops that took the most, ms each.
The card's name and power limit lead the output.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("relational_trace: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.relational as rel
    from chip_smoke import (FLAT_IDS, MOE_EXPERTS, MOE_IDS, REL_BINS, REL_QS,
                            SEED, card, emit, tpch_columns, trace_summary)
    from repro_torch.kernels import _build

    emit({"card": card(), "torch": torch.__version__})
    _build.build_all(("bitonic_sort", "merge_path", "radix_sort",
                      "radix_select"))
    rng = np.random.default_rng(SEED)
    orders, lines, qty, price = tpch_columns(rng)
    n = lines.numel()
    ids = torch.from_numpy(rng.integers(0, MOE_EXPERTS, MOE_IDS)
                           .astype(np.int32)).cuda()
    flat = torch.from_numpy(rng.integers(0, FLAT_IDS[1], FLAT_IDS[0])
                            .astype(np.int32)).cuda()
    ops = {
        "unique l_orderkey": lambda: rel.unique(lines, return_counts=True),
        "group_by l_orderkey, l_quantity": lambda: rel.group_by(
            lines, qty, agg=("sum", "count", "min", "max", "mean")),
        "group_by l_orderkey, l_extendedprice": lambda: rel.group_by(
            lines, price, agg=("sum", "mean")),
        "join l_orderkey = o_orderkey": lambda: rel.join(lines, orders,
                                                         size=n),
        "rle o_orderkey": lambda: rel.run_length_encode(orders),
        "delta o_orderkey": lambda: rel.delta_encode(orders),
        "histogram l_extendedprice": lambda: rel.histogram(price, REL_BINS),
        "quantiles l_extendedprice": lambda: rel.quantiles(price, REL_QS),
        f"group_ranks {MOE_IDS}": lambda: rel.group_ranks(ids, MOE_EXPERTS),
        "group_ranks 2^24": lambda: rel.group_ranks(flat, FLAT_IDS[1]),
    }
    for name, fn in ops.items():
        t0 = time.perf_counter()
        summary = trace_summary(fn, top=10)
        emit({"op": name, "seconds_with_warmup": time.perf_counter() - t0,
              **summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
