"""One rank of the mesh tier's rank-form parity run
(``test_torch_ranks.py``; ``test_torch_cuda.py`` on a card).

    python tests/_torch_ranks_worker.py RANK WORLD PORT OUT_DIR [cpu|cuda]

Joins a ``gloo`` group of WORLD processes at ``tcp://localhost:PORT``.

``cpu`` (four ranks): builds a ``(4,)`` ``("data",)`` and a ``(2, 2)``
``("host", "dev")`` DeviceMesh and runs every case of the rank form of
the mesh sort against the one-process ``core.mesh.Mesh`` path over the
same shards (bit for bit, the counter bytes summed over the ranks
included) and against numpy's stable order; rank 0 also writes the
gathered results of the inputs in ``OUT_DIR/inputs.npz`` to
``OUT_DIR/ranks.npz`` for the JAX package's results at D = 4.  Then the
launchers' data mesh on the ``(4,)`` mesh (``data_cases``): the serve
scheduler, ``serve`` and the train step under the data policy.

``cuda`` (two ranks, every rank on ``cuda:0``): a sample sort, a stable
argsort and a top-k of 2^20 float32 keys against ``torch.sort`` /
``torch.topk`` of the whole array, with each rank's launches of K3's
``radix_bucket_hist``, K2's merges and K4's select.

Writes ``OUT_DIR/rank<RANK>.json``: ``{"checks": {name: value},
"errors": {name: traceback}}``.
"""
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import repro_torch.relational as rel  # noqa: E402
import repro_torch.sort as rsort  # noqa: E402
from repro_torch.core import distributed_sort as ds  # noqa: E402
from repro_torch.core import keycodec, topology  # noqa: E402
from repro_torch.core.mesh import make_mesh, rank_index  # noqa: E402
from repro_torch.core.sortspec import SortSpec  # noqa: E402
from repro_torch.engine import collectives as coll  # noqa: E402
from repro_torch.engine import samplesort as ss  # noqa: E402
from repro_torch.launch.mesh import make_host_device_mesh  # noqa: E402
from repro_torch.obs import metrics, trace as obs  # noqa: E402

MESHES = {"flat": ((4,), ("data",)), "two": ((2, 2), ("host", "dev"))}
DTYPES = ("float32", "bfloat16", "int8", "uint32")
KINDS = ("uneven", "small", "dups")
M = 96                      # shard length of the uneven and dups cases
OPS = ("sort", "argsort", "sort_kv")
TOPK_N = 4 * 100            # top-k keys: 100 a shard, so k = 150 > m
TOPK_K = (1, 64, 150)
PREFIXES = ("samplesort.", "collectives.", "distsort.")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def same(a, b) -> bool:
    """Bit equality of two tensors (or tuples / lists of them)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape) and \
        np.array_equal(bits(a), bits(b))


def np_key(x: torch.Tensor) -> np.ndarray:
    """numpy's total order of the keys as int64 (floats by their bits:
    -0.0 below +0.0), independent of the port's keycodec."""
    if x.is_floating_point():
        f = x.to(torch.float32).numpy().view(np.uint32).astype(np.int64)
        neg = f >= 1 << 31
        return np.where(neg, (1 << 32) - 1 - f, f | (1 << 31))
    return x.numpy().astype(np.int64)


def np_order(x: torch.Tensor, descending: bool) -> np.ndarray:
    k = np_key(x)
    return np.argsort(-k if descending else k, kind="stable")


def counters() -> dict:
    return {k: int(v["value"]) for k, v in metrics.snapshot().items()
            if v["type"] == "counter" and k.startswith(PREFIXES)}


def summed(mine: dict, keys) -> dict:
    """Each counter of ``keys`` summed over the ranks."""
    keys = sorted(keys)
    t = torch.tensor([mine.get(k, 0) for k in keys] or [0],
                     dtype=torch.int64)
    dist.all_reduce(t)
    return dict(zip(keys, t.tolist()))


def counted(fn):
    """(result, counters) of one call with obs on."""
    metrics.reset()
    with obs.tracing():
        out = fn()
    c = counters()
    metrics.reset()
    obs.clear()
    return out, c


def make_data(dtype: str, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    n = {"uneven": 4 * M - 3, "small": 3, "dups": 4 * M}[kind]
    if kind == "dups":
        raw = rng.integers(0, 4, n)
    elif dtype in ("float32", "bfloat16"):
        raw = rng.standard_normal(n) * 100
    elif dtype == "int8":
        raw = rng.integers(-128, 128, n)
    else:
        raw = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    if dtype == "bfloat16":
        x = torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16)
    else:
        x = torch.from_numpy(raw.astype(np.dtype(dtype)))
    pay = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                           .astype(np.int32))
    return x, pay


def cut(t: torch.Tensor, d: int):
    """The one-process sample sort's cut: ceil(n / d) a shard."""
    n = t.shape[0]
    m = -(-n // d) if n else 0
    return [t[min(i * m, n):min(i * m + m, n)] for i in range(d)]


class Run:
    def __init__(self):
        self.checks, self.errors = {}, {}

    def __call__(self, name, fn):
        try:
            self.checks[name] = fn()
        except Exception:
            self.errors[name] = traceback.format_exc()[-3000:]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def sort_case(dm, om, axes, x, pay, op, descending, **kw):
    """(one-process equal incl. counters, numpy's stable order) of one
    sort of the shard entry point."""
    me = rank_index(dm, axes)
    shards, pshards = cut(x, 4), cut(pay, 4)
    opts = dict(descending=descending, return_indices=op == "argsort",
                **kw)
    if op == "sort_kv":
        opts["values"] = pshards
    want, c1 = counted(lambda: ss.sample_sort_shards(shards, om, axes,
                                                     **opts))
    if op == "sort_kv":
        opts["values"] = pshards[me]
    got, c2 = counted(lambda: ss.sample_sort_shards(shards[me], dm, axes,
                                                    **opts))
    if isinstance(got, tuple):
        mine = same(got, tuple(w[me] for w in want))
    else:
        mine = same(got, want[me])
    tot = summed(c2, set(c1) | set(c2))
    ok_counts = tot == {k: c1.get(k, 0) for k in tot} and bool(c1)
    order = np_order(x, descending)
    parts = got if isinstance(got, tuple) else (got,)
    whole = [ss.gather_shards(p, dm, axes) for p in parts]
    ok_np = np.array_equal(bits(whole[0]), bits(x)[order])
    if op == "argsort":
        ok_np &= np.array_equal(whole[1].numpy(), order)
    if op == "sort_kv":
        ok_np &= np.array_equal(whole[1].numpy(), pay.numpy()[order])
    return {"one_process": bool(mine), "counters": bool(ok_counts),
            "numpy": bool(ok_np)}


def dtype_cases(run, dm, om, mname, axes):
    for di, dtype in enumerate(DTYPES):
        for ki, kind in enumerate(KINDS):
            x, pay = make_data(dtype, kind, 100 * di + ki)
            for op in OPS:
                for desc in (False, True):
                    name = f"{mname}/{dtype}/{kind}/{op}/" \
                           f"{'desc' if desc else 'asc'}"
                    run(name, lambda: sort_case(dm, om, axes, x, pay, op,
                                                desc))


def option_cases(run, dm, om, mname, axes):
    """capacity, pipeline_chunks, the int8 codec, the front door,
    distributed_sort's strategies, top-k, relational ops, topology."""
    me = rank_index(dm, axes)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(4 * M).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal(4 * M).astype(np.float32))
    pay = torch.from_numpy(np.arange(4 * M, dtype=np.int32))

    def options():
        out = {}
        for chunks in (1, 2, 4):
            out[f"chunks{chunks}"] = sort_case(
                dm, om, axes, x, pay, "sort_kv", False,
                pipeline_chunks=chunks)
        shards, vs = cut(x, 4), cut(vf, 4)
        want, c1 = counted(lambda: ss.sample_sort_shards(
            shards, om, axes, values=vs, wire_codec="int8",
            pipeline_chunks=2))
        got, c2 = counted(lambda: ss.sample_sort_shards(
            shards[me], dm, axes, values=vs[me], wire_codec="int8",
            pipeline_chunks=2))
        tot = summed(c2, set(c1) | set(c2))
        out["int8"] = {"one_process": same(got, (want[0][me], want[1][me])),
                       "counters": tot == {k: c1.get(k, 0) for k in tot}}
        if mname == "flat":
            cap = 2 * M
            out["capacity"] = sort_case(dm, om, axes, x, pay, "sort", False,
                                        capacity=cap)
            try:
                ss.sample_sort_shards(shards[me], dm, axes, capacity=1)
                out["capacity_error"] = False
            except ValueError as e:
                out["capacity_error"] = "realized maximum" in str(e)
        return out
    run(f"{mname}/options", options)

    def front_door():
        xd, pd = ss.shard_of(x, dm, axes), ss.shard_of(pay, dm, axes)
        res = {}
        got = rsort.sort(xd, mesh=dm)
        res["sort_placement"] = tuple(got.placements) == tuple(
            xd.placements) and tuple(got.shape) == tuple(x.shape)
        res["sort"] = same(ss.gather_shards(got.to_local(), dm, axes),
                           rsort.sort(x, mesh=om))
        got = rsort.argsort(xd, mesh=dm, descending=True, stable=True)
        res["argsort"] = same(ss.gather_shards(got.to_local(), dm, axes),
                              rsort.argsort(x, mesh=om, descending=True))
        k, v = rsort.sort_kv(xd, pd, mesh=dm)
        wk, wv = rsort.sort_kv(x, pay, mesh=om)
        res["sort_kv"] = same((ss.gather_shards(k.to_local(), dm, axes),
                               ss.gather_shards(v.to_local(), dm, axes)),
                              (wk, wv))
        v, i = rsort.run(SortSpec(k=5, mesh=dm), xd)
        wv, wi = rsort.topk(x, 5, mesh=om)
        res["topk_replicated"] = all(p.is_replicate() for p in v.placements)
        res["topk"] = same((v.to_local(), i.to_local()), (wv, wi))
        try:
            rsort.sort(x, mesh=dm)
            res["plain_tensor_refused"] = False
        except TypeError:
            res["plain_tensor_refused"] = True
        try:                              # a shard off the mesh's device
            ss.sample_sort_shards(torch.empty(4, device="meta"), dm, axes)
            res["off_device_refused"] = False
        except ValueError as e:
            res["off_device_refused"] = "off the DeviceMesh" in str(e)
        # a collective the backend cannot carry raises by name: gloo has
        # no int16 all_reduce (the rank form sends bytes, so it never
        # asks for one)
        grp = coll.RankGroup(dm, axes, torch.device("cpu"))
        t16 = torch.zeros(2, dtype=torch.int16)
        try:
            grp._run("all_reduce(MAX)", lambda: dist.all_reduce(
                t16, group=grp.pg), t16)
            res["refusal_named"] = False
        except RuntimeError as e:
            res["refusal_named"] = "all_reduce(MAX)" in str(e) and \
                "'gloo'" in str(e)
        return res
    run(f"{mname}/front_door", front_door)

    def strategies():
        xd = ss.shard_of(x, dm, axes)
        res = {}
        names = ("sample", "oddeven", "auto") if mname == "flat" else \
            ("sample", "hier", "auto")
        for s in names:
            got, c2 = counted(lambda: ds.distributed_sort(
                xd, dm, None, strategy=s))
            want, c1 = counted(lambda: ds.distributed_sort(
                x, om, None, strategy=s))
            tot = summed(c2, set(c1) | set(c2))
            res[s] = same(ss.gather_shards(got.to_local(), dm, axes), want)
            if s != "auto":         # the tiers differ: auto may plan apart
                res[f"{s}_counters"] = tot == {k: c1.get(k, 0)
                                               for k in tot}
        return res
    run(f"{mname}/strategies", strategies)

    def topk():
        r2 = np.random.default_rng(11)
        res = {}
        xi = torch.from_numpy(r2.integers(-20, 20, TOPK_N).astype(np.int32))
        xz = torch.from_numpy(r2.choice(np.array(
            [-0.0, 0.0, 1.5, -1.5, 2.0], np.float32), TOPK_N))
        for nm, t in (("ties", xi), ("zeros", xz)):
            td = ss.shard_of(t, dm, axes)
            key = np_key(t)
            for k in TOPK_K:
                (v, i), c2 = counted(lambda: ss.sample_topk(td, k, dm, axes))
                (wv, wi), c1 = counted(lambda: ss.sample_topk(t, k, om,
                                                              axes))
                tot = summed(c2, set(c1) | set(c2))
                want_i = np.lexsort((np.arange(TOPK_N), -key))[:k]
                res[f"{nm}_k{k}"] = {
                    "one_process": same((v.to_local(), i.to_local()),
                                        (wv, wi)),
                    "counters": tot == {kk: c1.get(kk, 0) for kk in tot},
                    "numpy": np.array_equal(i.to_local().numpy(), want_i)
                    and np.array_equal(bits(v.to_local()),
                                       bits(t)[want_i])}
        return res
    run(f"{mname}/topk", topk)

    def relational():
        r2 = np.random.default_rng(13)
        res = {}
        keys = torch.from_numpy(r2.integers(0, 60, 4 * M - 3)
                                .astype(np.int32))
        vals = torch.from_numpy(r2.integers(-9, 9, 4 * M - 3)
                                .astype(np.int32))
        right = keys[:50].clone()
        u = rel.unique(ss.shard_of(keys, dm, axes), return_counts=True,
                       mesh=dm)
        wu = rel.unique(keys, return_counts=True, mesh=om)
        nu, cnt = np.unique(keys.numpy(), return_counts=True)
        res["unique"] = same(tuple(t for t in u if t is not None),
                             tuple(t for t in wu if t is not None)) and \
            np.array_equal(u.values[:len(nu)].numpy(), nu) and \
            np.array_equal(u.counts[:len(nu)].numpy(), cnt)
        g = rel.group_by(ss.shard_of(keys, dm, axes),
                         ss.shard_of(vals, dm, axes),
                         agg=("sum", "count", "min", "max"), mesh=dm)
        wg = rel.group_by(keys, vals, agg=("sum", "count", "min", "max"),
                          mesh=om)
        sums = np.array([vals.numpy()[keys.numpy() == k].sum()
                         for k in nu])
        res["group_by"] = same((g.keys, g.n_groups) + tuple(g.aggregates),
                               (wg.keys, wg.n_groups)
                               + tuple(wg.aggregates)) and \
            np.array_equal(g.aggregates[0][:len(nu)].numpy(), sums)
        j = rel.join(keys, right, size=4000, mesh=dm)      # whole columns
        wj = rel.join(keys, right, size=4000, mesh=om)
        pairs = int((keys.numpy()[:, None] == right.numpy()[None]).sum())
        res["join"] = same(tuple(j), tuple(wj)) and \
            int(j[2]) == pairs
        return res
    run(f"{mname}/relational", relational)

    def topo():
        t = topology.from_mesh(dm)
        cal = topology.calibrate(dm, set_as_active=False)
        return {"tiers": [a.tier for a in t.axes],
                "calibrated": [[a.tier, a.bandwidth_bytes_per_s,
                                a.latency_ns] for a in cal.axes]}
    run(f"{mname}/topology", topo)


def reference_outputs(dm_flat, dm_two, inputs: dict) -> dict:
    """The inputs' results through the DTensor entry points, gathered
    (what the JAX package's D = 4 run computes)."""
    x = torch.from_numpy(inputs["x"])
    xi = torch.from_numpy(inputs["xi"])
    v = torch.from_numpy(inputs["v"])
    out = {}

    def whole(t, dm):
        return ss.gather_shards(t.to_local(), dm).numpy()
    xd, xid = ss.shard_of(x, dm_flat), ss.shard_of(xi, dm_flat)
    out["sort"] = whole(ss.sample_sort(xd, dm_flat, "data"), dm_flat)
    out["sort_desc"] = whole(ss.sample_sort(xd, dm_flat, "data",
                                            descending=True), dm_flat)
    out["sort_int_hist"] = whole(ss.sample_sort(
        xid, dm_flat, "data", use_histogram=True), dm_flat)
    k, _ = ss.sample_sort(xd, dm_flat, "data",
                          values=ss.shard_of(v, dm_flat))
    out["kv_keys"] = whole(k, dm_flat)
    out["oddeven"] = whole(ds.distributed_sort(xd, dm_flat, "data",
                                               strategy="oddeven"), dm_flat)
    for k_ in (1, 64, 500):
        tv, ti = ss.sample_topk(xid, k_, dm_flat, "data")
        out[f"topk{k_}_v"], out[f"topk{k_}_i"] = \
            tv.to_local().numpy(), ti.to_local().numpy()
    x2 = ss.shard_of(x, dm_two)
    out["hier"] = whole(ss.sample_sort(x2, dm_two, None), dm_two)
    out["flat2x2"] = whole(ss.sample_sort(x2, dm_two, None,
                                          hierarchical=False), dm_two)
    tv, ti = ds.distributed_topk(x2, 50, dm_two, None)
    out["topk2x2_v"], out["topk2x2_i"] = \
        tv.to_local().numpy(), ti.to_local().numpy()
    return out


# ---------------------------------------------------------------------------
# the launchers' data mesh: the serve scheduler, serve, the train step
# ---------------------------------------------------------------------------

SCHED_BACKLOGS = (4097, 5000)     # over distributed_min (4096), uneven
SCHED_BATCH = 8
SCHED_REF_BATCHES = 4             # batches the reference runs at D = 4
SERVE_KW = dict(n_requests=8, batch_size=4, decode_steps=4, topk=10,
                max_len=64, device="cpu")


def sched_lens(n: int) -> np.ndarray:
    """The prompt lengths of a backlog of ``n`` (both packages')."""
    return np.random.default_rng(n).integers(4, 4096, n)


def sched_batches(sched, lens, count: int) -> list:
    """The rids of ``sched``'s first ``count`` batches of ``lens``."""
    from repro_torch.launch import serve as srv
    for i, n in enumerate(lens):
        sched.submit(srv.Request(rid=i, prompt=np.zeros(int(n), np.int32)))
    return [[r.rid for r in sched.next_batch()] for _ in range(count)]


def data_cases(run, dm, out_dir):
    """(i) the serve scheduler on the (4,) data mesh at uneven backlogs
    against the mesh-free scheduler and one on numpy's stable order;
    (ii) ``serve`` under the data policy against the unsharded serve,
    its scheduler on the mesh, the snapshot written by rank 0 and
    restored on the mesh; (iii) the data policy's float32 loss and
    gradients against the unsharded model's, no placement on ``model``."""
    import dataclasses
    from repro_torch import tree as ttree
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tuning
    from repro_torch.launch import serve as srv
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import dp_axes_of
    from repro_torch.models.model_zoo import build
    from repro_torch.sharding.partitioning import ShardingPolicy, full_tensor

    class NumpyOrder(srv.LengthSortedScheduler):
        def _order(self, lens):
            return np.argsort(lens, kind="stable")

    for n in SCHED_BACKLOGS:
        def scheduler(n=n):
            lens = sched_lens(n)
            # every batch whose backlog reaches distributed_min, then two
            # (at least the reference's batches)
            count = max(SCHED_REF_BATCHES, (n - 4096) // SCHED_BATCH + 3)
            mesh = srv.LengthSortedScheduler(SCHED_BATCH, mesh=dm,
                                             axis_name="data", device="cpu")
            got = sched_batches(mesh, lens, count)
            local = sched_batches(srv.LengthSortedScheduler(
                SCHED_BATCH, device="cpu"), lens, count)
            plain = sched_batches(NumpyOrder(SCHED_BATCH, device="cpu"),
                                  lens, count)
            return {"mesh_sorts": mesh.mesh_sorts, "batches": count,
                    "equal_mesh_free": got == local,
                    "equal_numpy": got == plain,
                    "first": got[:SCHED_REF_BATCHES]}
        run(f"data/scheduler/{n}", scheduler)

    pol = ShardingPolicy(mesh=dm, dp_axes=dp_axes_of(dm))
    state = os.path.join(out_dir, "serve_state")

    def serve():
        made, snaps = [], []
        real_sched, real_snap = srv.LengthSortedScheduler, srv.snapshot_state

        class Spy(real_sched):
            """The serve's scheduler, recorded; its backlog of 8 reaches
            a distributed_min of 4, so its first sorts go over the mesh."""
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.distributed_min = 4
                made.append(self)

        def spy_snap(*a, **kw):
            snaps.append(real_snap(*a, **kw))
            return snaps[-1]
        # float32: in bfloat16 a contraction over FSDP-sharded weights
        # sums per-rank partials, whose rounding flips close samples
        cfg = dataclasses.replace(get_smoke_config("minitron-4b"),
                                  dtype="float32")
        want = srv.serve("minitron-4b", config=cfg, **SERVE_KW)[0]
        srv.LengthSortedScheduler, srv.snapshot_state = Spy, spy_snap
        try:
            got, stats = srv.serve("minitron-4b", config=cfg, policy=pol,
                                   state_dir=state, **SERVE_KW)
        finally:
            srv.LengthSortedScheduler, srv.snapshot_state = real_sched, \
                real_snap
        tuning.set_active(None)
        topology.set_active(None)
        restored = srv.restore_state(state, mesh=dm)
        tuning.set_active(None)
        topology.set_active(None)
        return {"tokens_equal": {r.rid: r.out.tolist() for r in want}
                == {r.rid: r.out.tolist() for r in got},
                "requests": len(got),
                "distributed_queue": stats["distributed_queue"],
                "mesh_sorts": stats["mesh_sorts"],
                "scheduler_on_the_mesh": len(made) == 1
                and made[0].mesh is dm and made[0].axis_name == ("data",),
                "snapshot_files": [len(x) for x in snaps],
                "restored": restored}
    run("data/serve", serve)

    def gradients():
        cfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"),
                                  dtype="float32")
        m0, m1 = build(cfg, device="cpu"), build(cfg, device="cpu",
                                                 policy=pol)
        p = m0.init(torch.Generator().manual_seed(0))
        tok = torch.randint(0, 256, (8, 32), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
        loss0, _, g0 = steps.loss_and_grads(m0, p, batch)
        placed = m1.place(p)
        with steps.sharded(pol):
            loss1, _, g1 = steps.loss_and_grads(
                m1, placed, steps.place_batch(m1, batch))
        pls = {str(pl) for t in ttree.leaves(placed)
               for pl in getattr(t, "placements", ())}
        return {"loss_rel": float(abs(loss0 - full_tensor(loss1))
                                  / abs(loss0)),
                "grad_rel": max(float(
                    (a - full_tensor(b)).abs().max()
                    / a.abs().max().clamp(min=1e-30))
                    for a, b in zip(ttree.leaves(g0), ttree.leaves(g1))),
                "placements": sorted(pls),
                "sharded_leaves": sum(any(x.is_shard() for x in
                                          t.placements)
                                      for t in ttree.leaves(placed))}
    run("data/gradients", gradients)


# ---------------------------------------------------------------------------
# the card: two gloo ranks on cuda:0
# ---------------------------------------------------------------------------

CUDA_N = 1 << 20


def cuda_cases(run, rank):
    from repro_torch.kernels import _build
    dm = make_host_device_mesh((2,), ("data",), device="cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(CUDA_N).astype(np.float32)
                         ).cuda()
    xd = ss.shard_of(x, dm)
    key = keycodec.encode(x) ^ -(1 << 31)      # the sort's signed key
    order = torch.sort(key, stable=True).indices

    def launched(fn):
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_build.launches)

    def sort():
        got, n = launched(lambda: ss.sample_sort(xd, dm))
        whole = ss.gather_shards(got.to_local(), dm)
        return {"equal": bool(torch.equal(whole, x[order])),
                "hist": n.get("radix_bucket_hist", 0),
                "k2": n.get("merge_path_partition", 0)}
    run("cuda/sort", sort)

    def argsort():
        got, n = launched(lambda: rsort.argsort(xd, mesh=dm))
        whole = ss.gather_shards(got.to_local(), dm)
        return {"equal": bool(torch.equal(whole.long(), order)),
                "hist": n.get("radix_bucket_hist", 0),
                "k2": n.get("merge_path_partition", 0)}
    run("cuda/argsort", argsort)

    def topk():
        (v, i), n = launched(lambda: ss.sample_topk(xd, 64, dm))
        _, want = torch.topk(key, 64)
        wk = key[want].cpu().numpy().astype(np.int64)
        want = want.cpu().numpy()
        want = want[np.lexsort((want, -wk))]
        return {"equal": bool(np.array_equal(i.to_local().cpu().numpy(),
                                             want)),
                "select": n.get("select_digit_hist", 0)}
    run("cuda/topk", topk)


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    run = Run()
    if mode == "cuda":
        cuda_cases(run, rank)
    else:
        meshes = {}
        for mname, (shape, names) in MESHES.items():
            dm = make_host_device_mesh(shape, names, device="cpu")
            om = make_mesh(shape, names, "cpu")
            meshes[mname] = dm
            dtype_cases(run, dm, om, mname, names)
            option_cases(run, dm, om, mname, names)
        data_cases(run, meshes["flat"], out_dir)
        inputs = os.path.join(out_dir, "inputs.npz")
        if os.path.exists(inputs):
            def ref():
                res = reference_outputs(meshes["flat"], meshes["two"],
                                        dict(np.load(inputs)))
                if rank == 0:
                    np.savez(os.path.join(out_dir, "ranks.npz"), **res)
                return True
            run("reference_outputs", ref)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"checks": run.checks, "errors": run.errors}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
