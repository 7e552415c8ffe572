"""The paper's memory partitioning at cluster scale: every mesh entry sorts
its shard, then the shards combine over the mesh — either D odd-even
merge rounds (each a temp-row operand exchange, Eq. 3-4) or the
single-round sample sort (splitters + ONE bucket all-to-all, §II-B's
exchange-once structure).  ``strategy="auto"`` lets the planner's
collective cost model pick per (n, D).

The mesh has 8 entries.  With ``--device cuda`` (the default) every entry
is ``cuda:0``: the exchanges are copies on one card and each shard's sort
and merges run the card's kernels; ``--device cpu`` puts every entry on
the CPU.

Run:  PYTHONPATH=src python examples/torch/distributed_sort_demo.py \\
          [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import distributed_sort as ds
from repro_torch.core.mesh import make_mesh
from repro_torch.engine import planner, samplesort

N_ENTRIES = 8
LOCAL = 4096


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="sorting over a device mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: 8 entries on cuda:0) or cpu")
    dev = ap.parse_args(argv).device
    entry = "cuda:0" if torch.device(dev).type == "cuda" else dev
    mesh = make_mesh((N_ENTRIES,), ("data",), entry)
    n_dev = mesh.shape["data"]
    n = n_dev * LOCAL
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    xs = torch.from_numpy(x)

    plan = planner.choose_distributed(n, n_dev, xs.dtype)
    out = ds.distributed_sort(xs, mesh)                  # strategy="auto"
    assert np.allclose(out.cpu().numpy(), np.sort(x))
    print(f"globally sorted {n} elements over {n_dev} mesh entries "
          f"(auto -> {plan.strategy}; modeled ns: "
          + ", ".join(f"{k}={v:.3g}" for k, v in sorted(plan.costs.items()))
          + ")")
    for strategy in ("oddeven", "sample"):
        forced = ds.distributed_sort(xs, mesh, strategy=strategy)
        assert (forced.cpu().numpy() == np.sort(x)).all()
        print(f"strategy={strategy!r}: the same {n} keys, bit-exact")

    oe = ds.collective_bytes_per_device(n_dev, LOCAL, 4)
    ss = samplesort.alltoall_bytes_per_device(n_dev, LOCAL, 4)
    print(f"link volume/entry: odd-even {oe/1e3:.1f} kB ({n_dev} rounds x "
          f"{LOCAL*4/1e3:.1f} kB) vs sample {ss/1e3:.1f} kB "
          f"(1 bucket all-to-all + 1 rebalance)")

    # the sample path also covers what odd-even cannot express: uneven
    # length, descending, and a payload riding the buckets
    k = np.random.default_rng(1).integers(0, 100, n - 3).astype(np.int32)
    sk, sv = ds.distributed_sort(torch.from_numpy(k), mesh,
                                 strategy="sample", descending=True,
                                 values=torch.arange(n - 3))
    sk, sv = sk.cpu().numpy(), sv.cpu().numpy()
    assert (sk == np.flip(np.sort(k))).all()
    assert (k[sv] == sk).all()
    print(f"sample-sort kv/descending/uneven: {n - 3} elements OK")
    ascending = bool(np.all(np.diff(out.cpu().numpy()) >= 0))
    print("device order is globally ascending:", ascending)
    assert ascending
    return {"plan": plan, "mesh": mesh}


if __name__ == "__main__":
    main()
