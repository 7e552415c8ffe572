#!/usr/bin/env python3
"""The distributed tier on distinct cards against the same mesh on one
card: what NVLink changes.

    python3 scripts/mesh_links.py            # every card of the machine
    python3 scripts/mesh_links.py --device cpu --n 65536   # rehearsal
    python3 scripts/mesh_links.py --ranks    # and one NCCL rank a card
    python3 scripts/mesh_links.py --ranks --device cpu --n 65536

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

``--ranks`` adds the rank form of the same calls: D spawned processes,
one a card, joined in an NCCL group (gloo with ``--device cpu``), each
holding its shard of a DTensor placed ``Shard(0)`` on a ``(D,)``
DeviceMesh; each rank's shard is held bit for bit against the same
``torch.sort``, the time is the slowest rank's mean over ``--reps`` calls
(each rank synchronises its card and the ranks meet at a barrier before
the clock starts), and ``topology.calibrate`` of the DeviceMesh (tier
from where the ranks are).
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
    ap.add_argument("--ranks", action="store_true",
                    help="also run the rank form, one process a card")
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
    if args.ranks:
        del x, want, want_i
        for rec in run_ranks(d, args):
            emit(rec)
    emit({"ok": True})
    return 0


def _rank_main(rank, world, port, args, out_dir):
    """One rank of ``--ranks``: its records (rank 0's) or its traceback
    go to ``out_dir``."""
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed_sort as ds
    from repro_torch.core import keycodec, topology
    from repro_torch.engine import samplesort as ss
    from repro_torch.launch.mesh import make_host_device_mesh
    cuda = args.device == "cuda"
    recs = []
    try:
        if cuda:
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        dm = make_host_device_mesh((world,), ("data",),
                                   device="cuda" if cuda else "cpu")
        dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
        rng = np.random.default_rng(args.seed)
        x = torch.from_numpy(rng.standard_normal(args.n, dtype=np.float32)
                             ).to(dev)
        order = torch.sort(keycodec.encode(x) ^ -(1 << 31),
                           stable=True).indices
        m = -(-args.n // world)
        mine = order[min(rank * m, args.n):min(rank * m + m, args.n)]
        want, want_i = x[mine], mine.to(torch.int32)
        del order
        xd = ss.shard_of(x, dm)

        def sync():
            if cuda:
                torch.cuda.synchronize()
            dist.barrier()

        calls = {
            "sample sort": lambda: ss.sample_sort(xd, dm, "data"),
            "stable argsort": lambda: ss.sample_sort(
                xd, dm, "data", return_indices=True)[1],
            "odd-even": lambda: ds.distributed_sort(xd, dm, "data",
                                                    strategy="oddeven"),
        }
        for name, fn in calls.items():
            out = fn().to_local()
            ref = want_i if name == "stable argsort" else want
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"rank {rank} {name}: differs from "
                                     f"torch.sort")
            del out
            sync()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            sync()
            ms = torch.tensor([(time.perf_counter() - t0) * 1e3 / args.reps],
                              dtype=torch.float64, device=dev)
            dist.all_reduce(ms, op=dist.ReduceOp.MAX)
            recs.append({"mesh": "ranks", "backend": dist.get_backend(),
                         "entries": world, "call": name, "n": args.n,
                         "host_ms": ms.item(), "reps": args.reps})
        t = topology.calibrate(dm, small_bytes=1 << 20, large_bytes=1 << 26,
                               set_as_active=False)
        recs.append({"mesh": "ranks", "calibrate": t.to_dict()["axes"],
                     "probe_ns": t.probe_ns})
        dist.destroy_process_group()
        res = {"records": recs}
    except Exception:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def run_ranks(world: int, args) -> list:
    """Spawn the ``--ranks`` processes; rank 0's records."""
    import multiprocessing
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, port, args, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(1800)
            if p.is_alive():
                p.kill()
                p.join()
        res = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if not os.path.exists(path):
                raise AssertionError(f"--ranks: rank {r} wrote nothing")
            res.append(json.load(open(path)))
    for r, got in enumerate(res):
        if "error" in got:
            raise AssertionError(f"--ranks: rank {r}:\n{got['error']}")
    return res[0]["records"]


if __name__ == "__main__":
    sys.exit(main())
