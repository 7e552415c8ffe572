"""Sort engine demo: runs, merge tree, planner, segmented sort.

Walks the memory hierarchy the engine completes — one kernel-resident row
to million-element arrays — and shows the pieces the serving stack calls.
On the card (the default) the runs are sorted by the bitonic kernel (K1)
and merged by the merge-path kernel (K2); the planner prices every
registered backend for that device.

Run:  PYTHONPATH=src python examples/torch/engine_sort_demo.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import engine
from repro_torch.engine import planner, runs, segmented


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="ADS-IMC sort engine demo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = ap.parse_args(argv).device
    rng = np.random.default_rng(0)

    print("== 1. planner: cost-model dispatch over (n, batch) ==")
    plans = {}
    for n in (256, 4096, 65536, 1 << 20):
        plan = planner.choose(n, batch=1, device=dev)
        plans[n] = plan.method
        est = {k: f"{v / 1e3:.0f}us" for k, v in sorted(plan.costs.items())}
        print(f"  n={n:>8}: auto -> {plan.method:8s} estimates={est}")

    print("\n== 2. million-element sort through the engine ==")
    n = (1 << 20) + 12345          # deliberately non-power-of-two
    x = rng.standard_normal(n).astype(np.float32)
    out = engine.sort(torch.from_numpy(x), method="merge", device=dev)
    assert (out.cpu().numpy() == np.sort(x)).all()
    plan = planner.choose(n, 1, requested="merge", device=dev)
    n_tiles, padded = runs.run_layout(n, plan.run_len)
    print(f"  n={n}: {n_tiles} runs of {padded // n_tiles}, "
          f"{int(np.log2(n_tiles))} merge levels — bit-exact vs np.sort")

    print("\n== 3. top-k at vocab scale (partition-then-merge, paper §II-B) ==")
    logits = rng.standard_normal((4, 152064)).astype(np.float32)
    v, i = engine.topk(torch.from_numpy(logits), 50, method="merge",
                       device=dev)
    ref = -np.sort(-logits, -1)[:, :50]
    assert (v.cpu().numpy() == ref).all()
    print(f"  topk(50) over vocab 152064: ok, head "
          f"{v[0, :3].cpu().numpy().round(3)}")

    print("\n== 4. segmented sort (serving length buckets / MoE groups) ==")
    values = rng.standard_normal(64).astype(np.float32)
    seg = np.sort(rng.integers(0, 5, 64)).astype(np.int32)
    sv, sseg = segmented.segmented_sort(torch.from_numpy(values),
                                        torch.from_numpy(seg), device=dev)
    sv, sseg = sv.cpu().numpy(), sseg.cpu().numpy()
    for s in range(5):
        grp = sv[sseg == s]
        assert (np.diff(grp) >= 0).all()
    print("  5 ragged groups sorted independently in one pass: ok")

    perm, splits = segmented.group_tokens_by_expert(
        torch.from_numpy(rng.integers(0, 8, 256).astype(np.int32)), 8,
        device=dev)
    print(f"  MoE grouping: row_splits={splits.cpu().tolist()}")
    return {"plans": plans, "row_splits": splits.cpu().tolist()}


if __name__ == "__main__":
    main()
