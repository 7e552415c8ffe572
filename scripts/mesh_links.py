#!/usr/bin/env python3
"""The distributed tier on distinct cards against the same mesh on one
card: what NVLink changes.

    python3 scripts/mesh_links.py            # every card of the machine
    python3 scripts/mesh_links.py --device cpu --n 65536   # rehearsal

For D = the machine's card count (at least 2), two meshes of D entries:
one a card (``cuda:0`` .. ``cuda:D-1``; exchanges cross NVLink) and all on
``cuda:0`` (exchanges are copies inside its memory).  On each, in turns
(one card, distinct, distinct, one card): the flat sample sort, its stable
argsort and odd-even transposition of ``--n`` float32 normals drawn with
numpy from ``--seed``, each held bit for bit against ``torch.sort`` of
the keycodec key on ``cuda:0``, then timed on the host clock around calls
that end in a synchronise of every card (the mean of ``--reps``); and
``topology.calibrate`` of each mesh at 1 MiB / 64 MiB an entry (the
fitted tier, rate and latency).  One JSON line a measurement; the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 28)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.core import distributed_sort as ds
    from repro_torch.core import keycodec, topology
    from repro_torch.core.mesh import make_mesh
    from repro_torch.engine import samplesort as ss

    cuda = args.device == "cuda"
    if cuda:
        d = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if d < 2:
            print("mesh_links: needs at least 2 CUDA cards", file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
        emit({"cards": smi, "torch": torch.__version__})
        meshes = {"distinct": make_mesh((d,), ("data",)),
                  "one card": make_mesh((d,), ("data",), "cuda:0")}
    else:
        d = 4
        meshes = {"distinct": make_mesh((d,), ("data",), "cpu"),
                  "one card": make_mesh((d,), ("data",), "cpu")}
    first = torch.device("cuda:0" if cuda else "cpu")
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.standard_normal(args.n, dtype=np.float32)) \
        .to(first)
    key = keycodec.encode(x) ^ -(1 << 31)
    order = torch.sort(key, stable=True).indices
    want, want_i = x[order], order.to(torch.int32)
    del key, order

    def sync():
        if cuda:
            for i in range(d):
                torch.cuda.synchronize(i)

    def timed(fn):
        out = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3 / args.reps

    calls = {
        "sample sort": lambda m: ss.sample_sort(x, m, "data"),
        "stable argsort": lambda m: ss.sample_sort(
            x, m, "data", return_indices=True)[1],
        "odd-even": lambda m: ds.distributed_sort(x, m, "data",
                                                  strategy="oddeven"),
    }
    for kind in ("one card", "distinct", "distinct", "one card"):
        mesh = meshes[kind]
        for name, fn in calls.items():
            out, ms = timed(lambda: fn(mesh))
            ref = want_i if name == "stable argsort" else want
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"{kind} {name}: differs from "
                                     f"torch.sort")
            emit({"mesh": kind, "entries": d, "call": name, "n": args.n,
                  "host_ms": ms, "reps": args.reps,
                  "devices": [str(v) for v in mesh.devices.flat]})
            del out
    for kind, mesh in meshes.items():
        t = topology.calibrate(mesh, small_bytes=1 << 20,
                               large_bytes=1 << 26, set_as_active=False)
        emit({"mesh": kind, "calibrate": t.to_dict()["axes"],
              "probe_ns": t.probe_ns})
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
