"""Quickstart: the ADS-IMC sorting stack on PyTorch and CUDA in five minutes.

1. sort with every backend (torch / bitonic / cuda / merge / radix / auto)
   through the front door, ``repro_torch.sort``
2. validate the paper's headline numbers from the cost model
3. run the cycle-accurate in-memory sort and inspect its accounting

On the card (the default) the ``cuda`` sort runs the bitonic kernel (K1),
``topk(5, cuda)`` the top-k kernel (K5), the 2^20 ``merge`` sort K1's runs
and the merge-path kernel's tree (K2), ``radix`` the radix kernels (K3) and
the in-memory sort the bit-serial CAS kernel (K7), one launch a stage.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import sort as sorting
from repro_torch.core import cost_model
from repro_torch.core.sorter import sort_in_memory

METHODS = ("torch", "bitonic", "cuda", "merge", "radix", "auto")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="ADS-IMC quickstart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = ap.parse_args(argv).device

    print("== 1. one API, seven backends ==")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 100))
                         .astype(np.float32))
    for method in METHODS:
        out = sorting.sort(x, method=method, device=dev).cpu()
        assert (out.diff(dim=-1) >= 0).all()
        print(f"  sort(method={method!r}): ok, first row head "
              f"{out[0, :3].numpy().round(3)}")

    vals, idx = sorting.topk(x, 5, method="cuda", device=dev)
    assert torch.equal(vals.cpu(), x.topk(5).values)
    print(f"  topk(5, cuda): values[0]={vals[0].cpu().numpy().round(3)}")

    big = torch.from_numpy(np.random.default_rng(2).standard_normal(1 << 20)
                           .astype(np.float32))
    out = sorting.sort(big, method="merge", device=dev).cpu()
    assert (out.diff() >= 0).all()
    print(f"  sort(n={big.shape[0]}, method='merge'): ok "
          f"(out-of-core engine: tiled runs + merge-path tree)")

    print("\n== 2. the paper's numbers, reproduced ==")
    claims = cost_model.validate_claims()
    for name, model, paper, tol in claims.rows[:8]:
        print(f"  {name:42s} model={model:>8} paper={paper}")
    print(f"  ... all {len(claims.rows)} claims pass: {claims.all_pass()}")
    assert claims.all_pass()

    print("\n== 3. faithful in-memory sort (bit-serial, cycle-accurate) ==")
    v = np.random.default_rng(1).integers(0, 16, size=(2, 8))
    res = sort_in_memory(v, width=4, device=dev)
    assert (res.values.cpu().numpy() == np.sort(v, axis=-1)).all()
    print(f"  input : {v.tolist()}")
    print(f"  sorted: {res.values.cpu().tolist()}")
    print(f"  cycles: {res.cycles} (= {res.compute_cycles} compute "
          f"+ {res.movement_cycles} movement)   [paper: 192]")
    print(f"  array : {res.array_rows} rows x {res.array_cols} cols, "
          f"{res.n_partitions} partitions, {res.n_temp_rows} temp rows")
    print(f"  latency: {cost_model.sort_latency_ns(8):.1f} ns  "
          f"[paper Table II: 105.6 ns]")
    assert res.cycles == 192
    return {"claims": claims, "in_memory": res, "topk": (vals, idx)}


if __name__ == "__main__":
    main()
